"""Preprocess packer: ``metadata.csv`` and per-clip keypoint pickles → the
four training artifacts under ``<input_root>/<dataset>/``. The port's own
copy of ``sl_hwgat_tpu/data/preprocess.py`` (reference
`hwgat/data_preprocess.py:31-116`):

- the class map in order of first appearance (target encoding);
- degenerate clips dropped (a unit or zero dimension, or all-zero features);
- the static transform applied (the extractor's denormalisation and
  ``PoseSelect``);
- ``vid_splits``, ``vid_class`` and the data map pickled (``store="pickle"``:
  the arrays in memory; ``store="clipstore"``: the arrays in a clip store
  beside it, ``data/clipstore.py``, and a ``{"__clipstore__": path}`` marker
  in the pickle), and ``class_map_<ds>.csv`` written.

    python -m sl_hwgat_tpu_torch.data.preprocess --root <dir> -ds <name> \\
        --meta <metadata.csv> [-dr <subdir>] [-kpm mediapipe|dwpose] \\
        [--store pickle|clipstore]

takes the JAX package's flags, and ``--store``.
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle

import numpy as np

from sl_hwgat_tpu_torch.configs import DataConfig, build_static_transform


def preprocess(meta_csv: str, dataset_name: str, keypoint_dir: str,
               pose_method: str = "mediapipe", input_root: str = "input",
               feature_type: str = "keypoints", store: str = "pickle") -> DataConfig:
    """Write the four artifacts of ``meta_csv``'s clips (``<keypoint_dir>/
    <id>.pkl``) and return their ``DataConfig``."""
    if store not in ("pickle", "clipstore"):
        raise ValueError(f"store={store!r}: 'pickle' or 'clipstore'")
    cfg = DataConfig(dataset_name, feature_type, input_root)
    os.makedirs(os.path.dirname(cfg.vid_split_path), exist_ok=True)
    static_transform = build_static_transform(pose_method)

    vid_splits = {"train": [], "val": [], "test": []}
    vid_class: dict = {}
    class_map: dict = {}
    data_map: dict = {}
    next_cls = 0

    with open(meta_csv, newline="") as f:
        reader = csv.reader(f)
        next(reader)  # header: id, video_dir, video_name, class, split
        for row in reader:
            vid, word, split = row[0], row[3].strip(), row[4]
            if word not in class_map:  # target encoding (≡ `:70-73`)
                class_map[word] = next_cls
                next_cls += 1
            vid_class[vid] = class_map[word]
            if feature_type == "keypoints":
                with open(os.path.join(keypoint_dir, vid + ".pkl"), "rb") as pf:
                    data = pickle.load(pf)
                feat = data.get("feat", data.get(feature_type))
                if 1 in feat.shape or 0 in feat.shape or feat.sum() == 0:
                    continue  # degenerate clip filter (≡ `:81-82`)
                data_map[vid] = np.asarray(static_transform(data), dtype=np.float32)
            else:
                data_map[vid] = os.path.join(keypoint_dir, row[1])
            if split in vid_splits:
                vid_splits[split].append(vid)
            else:
                print(f"Not In SPLIT {vid}")

    with open(cfg.vid_split_path, "wb") as f:
        pickle.dump(vid_splits, f)
    with open(cfg.vid_class_path, "wb") as f:
        pickle.dump(vid_class, f)
    if store == "clipstore" and feature_type != "keypoints":
        raise ValueError("store='clipstore' requires feature_type='keypoints' (rgb data "
                         "maps hold video paths, not arrays)")
    if store == "clipstore":
        from sl_hwgat_tpu_torch.data.clipstore import write_clipstore

        cs_path = cfg.data_map_path + ".cs"
        write_clipstore(cs_path, data_map)
        with open(cfg.data_map_path, "wb") as f:
            pickle.dump({"__clipstore__": cs_path}, f)
    else:
        with open(cfg.data_map_path, "wb") as f:
            pickle.dump(data_map, f)
    with open(cfg.class_map_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["class", "word"])
        for word, c in class_map.items():
            w.writerow([c, word])
    print(f"Unique Words: {len(class_map)}")
    return cfg


def parser() -> argparse.ArgumentParser:
    """The JAX package's flags (`sl_hwgat_tpu/data/preprocess.py:92-98`),
    and ``--store``."""
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("-ds", required=True)
    p.add_argument("--meta", required=True)
    p.add_argument("-dr", "--dataroot", default="")
    p.add_argument("-kpm", "--kp_model", default="mediapipe")
    p.add_argument("--store", choices=("pickle", "clipstore"), default="pickle",
                   help="the data map as one pickle of arrays, or a clip store beside it")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    preprocess(args.meta, args.ds, os.path.join(args.root, args.dataroot),
               pose_method=args.kp_model, store=args.store)


if __name__ == "__main__":
    main()
