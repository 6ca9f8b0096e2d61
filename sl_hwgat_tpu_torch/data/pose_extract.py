"""Offline pose extraction: videos → per-clip keypoint pickles.

    python -m sl_hwgat_tpu_torch.data.pose_extract --root <dir> -ds <name>
        --meta <metadata.csv> [-dr <subdir>] [-kpm mediapipe|dwpose|rtmwpose]
        [--workers 10] [--device cuda|cpu]

≡ ``sl_hwgat_tpu/data/pose_extract.py`` (the port keeps its own copy) and
reference `hwgat/pose_feature_extract.py:27-180`: fans out over the
metadata.csv rows with a process pool, decodes frames (decord when available,
OpenCV fallback), runs the pose backend per frame, and pickles
``{'feat', 'num_frames', 'vid_loc', 'vid_name', 'vid_width', 'vid_height'}``
per clip id. Idempotent: clips whose ``.pkl`` already exists are skipped;
broken videos are reported and skipped (fault tolerance ≡ `:84-89`). The
mmpose backends run on ``--device``, the card by default (refused without
one); mediapipe runs on the host (``data.pose``).
"""

from __future__ import annotations

import csv
import os
import pickle
from multiprocessing import Pool

import numpy as np

_POSE_MODEL = None
_POSE_NAME = None


def read_metadata(meta_csv: str, video_root: str) -> list[dict]:
    jobs = []
    with open(meta_csv, newline="") as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            jobs.append(
                {"id": row[0], "video_dir": row[1], "video_name": row[2], "root": video_root}
            )
    return jobs


def _frames(path: str):
    try:
        from decord import VideoReader, cpu

        vr = VideoReader(path, ctx=cpu(0))
        for i in range(len(vr)):
            yield vr[i].asnumpy()
        return
    except ImportError:
        pass
    import cv2

    cap = cv2.VideoCapture(path)
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    cap.release()


def _init_worker(pose_name: str, device: str = "cuda"):
    global _POSE_MODEL, _POSE_NAME
    from sl_hwgat_tpu_torch.data.pose import load_pose_model

    _POSE_MODEL, _ = load_pose_model(pose_name, device=device)
    _POSE_NAME = pose_name


def extract_one(job: dict, out_dir: str, pose_model=None) -> str | None:
    """Extract one clip; returns the output path or None on failure/skip."""
    out_path = os.path.join(out_dir, job["id"] + ".pkl")
    if os.path.exists(out_path):
        return out_path
    model = pose_model if pose_model is not None else _POSE_MODEL
    video_path = os.path.join(job["root"], job["video_dir"])
    feats, h = [], None
    try:
        for frame in _frames(video_path):
            kp, h, w = model(frame)
            feats.append(kp)
    except Exception as e:  # broken video: report + skip (≡ `:84-89`)
        print(f"[pose_extract] failed {video_path}: {e}")
        return None
    if not feats:
        print(f"[pose_extract] empty video {video_path}")
        return None
    feat = np.stack(feats)
    payload = {
        "feat": feat,
        "num_frames": len(feats),
        "vid_loc": video_path,
        "vid_name": job["video_name"],
        "vid_width": w,
        "vid_height": h,
    }
    os.makedirs(out_dir, exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, out_path)
    return out_path


def extract_all(meta_csv: str, video_root: str, out_dir: str, pose_name: str = "mediapipe",
                workers: int = 10, device: str = "cuda") -> list[str]:
    """Pool-parallel extraction over all metadata rows. ≡ `:111-180`."""
    jobs = read_metadata(meta_csv, video_root)
    jobs = [j for j in jobs if not os.path.exists(os.path.join(out_dir, j["id"] + ".pkl"))]
    os.makedirs(out_dir, exist_ok=True)
    if workers <= 1:
        _init_worker(pose_name, device)
        return [p for p in (extract_one(j, out_dir) for j in jobs) if p]
    with Pool(workers, initializer=_init_worker, initargs=(pose_name, device)) as pool:
        results = pool.starmap(extract_one, [(j, out_dir) for j in jobs])
    return [p for p in results if p]


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True, help="dataset root directory")
    p.add_argument("-ds", required=True, help="dataset name")
    p.add_argument("--meta", required=True, help="metadata.csv path")
    p.add_argument("-dr", "--dataroot", default="", help="output subdir for keypoint pkls")
    p.add_argument("-kpm", "--kp_model", default="mediapipe")
    p.add_argument("--workers", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="where the mmpose backends run (mediapipe runs on the host)")
    args = p.parse_args()
    out_dir = os.path.join(args.root, args.dataroot or f"{args.ds}_keypoints")
    extract_all(args.meta, args.root, out_dir, args.kp_model, args.workers, args.device)


if __name__ == "__main__":
    main()
