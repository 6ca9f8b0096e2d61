"""Synthetic keypoint dataset generator (SYNTH), the port's own copy of
``sl_hwgat_tpu/data/synthetic.py``: the same seeds write the same artifacts.
The reference ships no data; tests and ``chip_smoke.py`` train on this."""

from __future__ import annotations

import csv
import os
import pickle

import numpy as np


def make_clip(rng: np.random.Generator, num_frames: int, num_joints: int = 29,
              coords: int = 2, canonical: np.ndarray | None = None,
              pose_sigma: float = 0.04) -> np.ndarray:
    """Plausible normalized keypoints: anchors/origin nonzero, smooth motion.

    ``canonical``: shared base skeleton. Real pose data has consistent
    geometry across clips after shoulder-anchored normalization (same human
    skeleton, different signers ⇒ small deviations); the original generator
    drew every clip's base uniform(0.3, 0.7) PER JOINT — a ±0.2 per-clip
    class-independent nuisance that survives normalization and, at 2 train
    clips/class, swamps few-shot generalization through the σ·10 Fourier
    embedding even though linear probes (which average through additive
    noise) still read 79% (tools/largevocab_sweep_r05.md). With a canonical
    skeleton + N(0, pose_sigma) per-clip variation the intra-class nuisance
    matches real normalized data.
    """
    if canonical is None:
        base = rng.uniform(0.3, 0.7, size=(1, num_joints, coords))
    else:
        base = canonical[None] + rng.normal(
            0, pose_sigma, size=(1, num_joints, coords))
    drift = np.cumsum(rng.normal(0, 0.01, size=(num_frames, 1, coords)), axis=0)
    jitter = rng.normal(0, 0.005, size=(num_frames, num_joints, coords))
    clip = np.clip(base + drift + jitter, 0.05, 0.95).astype(np.float32)
    return clip


def write_synthetic_dataset(root: str, dataset_name: str = "SYNTH",
                            num_classes: int = 16, clips_per_class: int = 4,
                            frames: tuple[int, int] = (12, 40), seed: int = 0) -> None:
    """Emit the four preprocessed artifacts (≡ `data_preprocess.py:102-116`)."""
    rng = np.random.default_rng(seed)
    out_dir = os.path.join(root, dataset_name)
    os.makedirs(out_dir, exist_ok=True)

    # Large vocabularies: one canonical skeleton for the whole dataset
    # (≡ real normalized pose data — see make_clip docstring); the small
    # 16-class SYNTH keeps the legacy fully-random geometry its golden
    # tests were written against.
    canonical = None
    if num_classes > 16:
        canonical = np.random.default_rng(999).uniform(
            0.35, 0.65, size=(29, 2)).astype(np.float32)

    vid_splits = {"train": [], "val": [], "test": []}
    vid_class, data_map = {}, {}
    for cls in range(num_classes):
        # Large vocabularies: the frequency code aliases once (1+cls)
        # exceeds the frame-count Nyquist limit, so classes additionally get
        # a fixed class-seeded spatial offset pattern on the hand joints —
        # constant in time (survives temporal resampling/edge-padding),
        # linear in the coordinates (survives shear/rotate/normalize), on
        # BOTH coords (survives RandomFlip up to sign, which the y-coord
        # component disambiguates).
        crng = np.random.default_rng(10_000 + cls)
        # Two independent class signals, both chosen to survive the full
        # train pipeline (nearest-centroid probes, round 4):
        # - a static per-joint offset pattern on all 29 joints, amplitude
        #   ABOVE the clip-generator's own per-joint base spread (±0.2) so
        #   intra-class noise doesn't drown it (±0.12 did);
        # - a per-joint oscillation pattern (class-seeded frequency/phase
        #   per joint) — temporal structure that per-clip static offsets and
        #   the shoulder-anchored normalization cannot remove.
        pattern = crng.uniform(-0.4, 0.4, size=(29, 2)).astype(np.float32)
        jfreq = crng.integers(1, 7, size=(29,)).astype(np.float32)
        jphase = crng.uniform(0, 2 * np.pi, size=(29,)).astype(np.float32)
        for i in range(clips_per_class):
            vid = f"c{cls:03d}_{i}"
            t = int(rng.integers(frames[0], frames[1]))
            clip = make_clip(rng, t, canonical=canonical)
            phase = rng.uniform(0, 2 * np.pi)
            freq = 1 + (cls % 12 if num_classes > 16 else cls)
            wave = 0.08 * np.sin(2 * np.pi * freq * np.linspace(0, 1, t) + phase)
            clip[:, 9:29, 1] += wave[:, None]
            if num_classes > 16:
                clip[:, :, :2] += pattern[None]
                tt = np.linspace(0, 1, t, dtype=np.float32)[:, None]
                motion = 0.15 * np.sin(
                    2 * np.pi * jfreq[None, :] * tt + jphase[None, :])
                clip[:, :, 1] += motion
                # keep strictly inside (0, 1): exact 0.0 coordinates read as
                # "missing joint" to NormalizeKeypoints/HandCorrection
                clip = np.clip(clip, 0.02, 0.98)
            data_map[vid] = np.clip(clip, 0.0, 1.0)
            vid_class[vid] = cls
            split = "train" if i < clips_per_class - 2 else ("val" if i == clips_per_class - 2 else "test")
            vid_splits[split].append(vid)

    with open(os.path.join(out_dir, f"vid_splits_{dataset_name}.pkl"), "wb") as f:
        pickle.dump(vid_splits, f)
    with open(os.path.join(out_dir, f"vid_class_{dataset_name}.pkl"), "wb") as f:
        pickle.dump(vid_class, f)
    with open(os.path.join(out_dir, f"data_map_{dataset_name}_keypoints.pkl"), "wb") as f:
        pickle.dump(data_map, f)
    with open(os.path.join(out_dir, f"class_map_{dataset_name}.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["class", "word"])
        for c in range(num_classes):
            w.writerow([c, f"word{c}"])
