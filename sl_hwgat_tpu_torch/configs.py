"""Eval-time transform pipelines, ≡ ``sl_hwgat_tpu/configs.py``
(reference `hwgat/configs.py:41-42, 105-109`)."""

from __future__ import annotations

from sl_hwgat_tpu_torch.constants import (
    ANCHOR_POINTS,
    COORD_LIST,
    KP_LIST,
    LEFT_HAND_SLICE,
    ORIGIN_IDX,
    RIGHT_HAND_SLICE,
)
from sl_hwgat_tpu_torch.data import transforms as T


def build_eval_transform(src_len: int) -> T.Compose:
    """Canonical 29-joint clip → (src_len, 64, C) windowed model input."""
    return T.Compose(
        [
            T.HandCorrection(LEFT_HAND_SLICE, RIGHT_HAND_SLICE),
            T.NormalizeKeypoints(ORIGIN_IDX, ANCHOR_POINTS),
            T.TemporalSample(src_len),
            T.WindowCreate(src_len),
        ]
    )


def build_static_transform(pose_method: str, input_type: str = "kp2D") -> T.Compose:
    """Extractor output → canonical 29-joint clip (the preprocess-time step)."""
    proc = T.DWPoseDataProcess() if pose_method == "dwpose" else T.MediapipeDataProcess()
    return T.Compose([proc, T.PoseSelect(KP_LIST[pose_method], COORD_LIST[pose_method + input_type])])
