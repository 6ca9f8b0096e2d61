"""Metadata generators: dataset adapters emitting the canonical
``metadata.csv`` (header ``id,video_dir,video_name,class,split``) and
``classes.txt``. The port's own copy of
``sl_hwgat_tpu/data/meta_generators.py`` (reference
`hwgat/meta_generators/`, 7 adapters), with its seeds and CSV layouts.

Each public dataset's traversal conventions are kept; paths are parameters
instead of hard-coded. Each adapter returns the row list and vocabulary;
:func:`generate_meta` writes them.
"""

from __future__ import annotations

import csv
import json
import os
import random
from math import ceil


def generate_meta(data_path: str, rows: list, vocab: list | None, subset=None) -> str:
    """Write metadata.csv + classes.txt next to the dataset.
    ≡ `meta_generators/meta_generator.py:4-31`."""
    os.makedirs(data_path + "_meta", exist_ok=True)
    suffix = f"_{subset}" if subset is not None else ""
    meta_file = f"{data_path}_meta/metadata{suffix}.csv"
    class_file = f"{data_path}_meta/classes{suffix}.txt"
    with open(meta_file, "w", encoding="UTF8", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["id", "video_dir", "video_name", "class", "split"])
        writer.writerows(rows)
    if vocab:
        with open(class_file, "w") as f:
            for word in vocab:
                f.write(word + "\n")
    return meta_file


def _add_ids(rows_by_class: dict[str, list]) -> list:
    out = []
    i = 0
    for cls in rows_by_class:
        for row in rows_by_class[cls]:
            out.append([str(i)] + row)
            i += 1
    return out


def include_meta(root: str, val_split: float = 0.1, seed: int | None = None) -> tuple[list, list]:
    """INCLUDE: class = parent dir name after the dot; val carved from train.
    ≡ `INCLUDE_meta_gen.py`."""
    if seed is not None:
        random.seed(seed)
    data_path = os.path.join(root, "INCLUDE")
    split_path = os.path.join(root, "Train_Test_Split")
    vocab: list[str] = []
    by_class: dict[str, list] = {}

    def ingest(csv_name: str, split: str):
        with open(os.path.join(split_path, csv_name)) as f:
            reader = csv.reader(f)
            next(reader)
            for row in reader:
                vid_path = os.path.join(data_path, row[3])
                if not os.path.exists(vid_path):
                    continue
                part = vid_path.split("/")[-3] if "xtra" in vid_path else vid_path.split("/")[-2]
                cls = part.split(".")[1].strip().lower()
                if cls not in vocab:
                    vocab.append(cls)
                by_class.setdefault(cls, []).append(
                    [os.path.join("INCLUDE", row[3]), os.path.basename(vid_path), cls, split]
                )

    ingest("train_include.csv", "train")
    ingest("test_include.csv", "test")
    vocab.sort()
    for cls, rows in by_class.items():
        train_rows = [r for r in rows if r[3] == "train"]
        for idx in random.sample(range(len(train_rows)), ceil(len(train_rows) * val_split)):
            train_rows[idx][3] = "val"
    return _add_ids(by_class), vocab


def fdmse_meta(root: str, val_split: float = 0.1, seed: int | None = None) -> tuple[list, list]:
    """FDMSE-ISL: <root>/<split or class dirs>/<class>/<video>. ≡ `FDMSE_meta_gen.py`."""
    if seed is not None:
        random.seed(seed)
    vocab: list[str] = []
    by_class: dict[str, list] = {}
    for split_dir, split in (("train", "train"), ("test", "test")):
        base = os.path.join(root, split_dir)
        if not os.path.isdir(base):
            continue
        for cls_dir in sorted(os.listdir(base)):
            cls = cls_dir.strip().lower()
            cdir = os.path.join(base, cls_dir)
            if not os.path.isdir(cdir):
                continue
            if cls not in vocab:
                vocab.append(cls)
            for vid in sorted(os.listdir(cdir)):
                by_class.setdefault(cls, []).append(
                    [os.path.join(split_dir, cls_dir, vid), vid, cls, split]
                )
    vocab.sort()
    for cls, rows in by_class.items():
        train_rows = [r for r in rows if r[3] == "train"]
        if train_rows:
            for idx in random.sample(range(len(train_rows)), ceil(len(train_rows) * val_split)):
                train_rows[idx][3] = "val"
    return _add_ids(by_class), vocab


def fdmse_meta_from_csv(root: str, split_file: str) -> tuple[list, list]:
    """FDMSE-ISL from the dataset's own metadata.csv, the reference's actual
    adapter (`FDMSE_meta_gen.py`): zero-padded 7-digit ids, rows kept only
    when the video file exists and the split field is non-trivial."""
    rows, vocab = [], []
    idx = 0
    with open(split_file) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            vid_path = os.path.join(row[1], row[2])
            if not os.path.exists(os.path.join(root, vid_path)):
                continue
            cls = row[3]
            if cls not in vocab:
                vocab.append(cls)
            if len(row[4]) > 1:
                rows.append(["{:07d}".format(idx), vid_path, row[2], cls, row[4]])
            idx += 1
    vocab.sort()
    return rows, vocab


def wlasl_subset_meta(root: str, subset: int = 2000) -> tuple[list, list]:
    """WLASL-{100,300,1000,2000} from WLASL_v0.3.json. ≡ `WLASL_subset_meta_gen.py`."""
    with open(os.path.join(root, "WLASL_v0.3.json")) as f:
        content = json.load(f)
    vocab, rows = [], []
    split_map = {"train": "train", "val": "val", "test": "test"}
    for entry in content[:subset]:
        gloss = entry["gloss"].strip().lower()
        if gloss not in vocab:
            vocab.append(gloss)
        for inst in entry["instances"]:
            vid = inst["video_id"] + ".mp4"
            path = os.path.join("videos", vid)
            if not os.path.exists(os.path.join(root, path)):
                continue
            rows.append([path, vid, gloss, split_map.get(inst["split"], "train")])
    vocab.sort()
    return [[str(i)] + r for i, r in enumerate(rows)], vocab


def autsl_meta(root: str) -> tuple[list, list]:
    """AUTSL: per-split CSV label files ``<split>_labels.csv``. ≡ `AUTSL_meta_gen.py`."""
    vocab, rows = [], []
    for split in ("train", "val", "test"):
        labels = os.path.join(root, f"{split}_labels.csv")
        if not os.path.exists(labels):
            continue
        with open(labels) as f:
            for line in csv.reader(f):
                name, cls = line[0], line[1].strip()
                if cls not in vocab:
                    vocab.append(cls)
                rows.append([os.path.join(split, name + "_color.mp4"), name + "_color.mp4", cls, split])
    vocab.sort()
    return [[str(i)] + r for i, r in enumerate(rows)], vocab


def msasl_subset_meta(root: str, subset: int = 1000) -> tuple[list, list]:
    """MSASL-{100,200,500,1000} from the official JSON lists. ≡ `MSASL_subset_meta_gen.py`."""
    vocab, rows = [], []
    for fname, split in (("MSASL_train.json", "train"), ("MSASL_val.json", "val"),
                         ("MSASL_test.json", "test")):
        p = os.path.join(root, fname)
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for entry in json.load(f):
                if entry.get("label", 0) >= subset:
                    continue
                cls = entry["clean_text"].strip().lower()
                if cls not in vocab:
                    vocab.append(cls)
                vid = entry["file"] + ".mp4"
                rows.append([os.path.join("videos", vid), vid, cls, split])
    vocab.sort()
    return [[str(i)] + r for i, r in enumerate(rows)], vocab


def lsa64_meta(root: str, val_split: float = 0.1, test_split: float = 0.2,
               seed: int | None = None) -> tuple[list, list]:
    """LSA64: filename encodes class (``<class>_<signer>_<rep>.mp4``).
    ≡ `LSA_meta_gen.py`."""
    if seed is not None:
        random.seed(seed)
    by_class: dict[str, list] = {}
    for vid in sorted(os.listdir(os.path.join(root, "all"))):
        cls = vid.split("_")[0]
        by_class.setdefault(cls, []).append([os.path.join("all", vid), vid, cls, "train"])
    vocab = sorted(by_class)
    for rows in by_class.values():
        n = len(rows)
        idxs = random.sample(range(n), ceil(n * (val_split + test_split)))
        for j, idx in enumerate(idxs):
            rows[idx][3] = "test" if j < ceil(n * test_split) else "val"
    return _add_ids(by_class), vocab


def pose_video_meta(root: str, meta_csv: str) -> tuple[list, list]:
    """Re-point an existing metadata.csv at extracted pose videos.
    ≡ `pose_meta_gen.py`."""
    rows, vocab = [], []
    with open(meta_csv) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            if row[3] not in vocab:
                vocab.append(row[3])
            rows.append([row[0], row[1], row[2], row[3], row[4]])
    vocab.sort()
    return rows, vocab


ADAPTERS = {
    "INCLUDE": include_meta,
    "FDMSE": fdmse_meta,
    "WLASL": wlasl_subset_meta,
    "AUTSL": autsl_meta,
    "MSASL": msasl_subset_meta,
    "LSA64": lsa64_meta,
}
