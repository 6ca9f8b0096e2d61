"""Transform pipelines, ≡ ``sl_hwgat_tpu/configs.py``
(reference `hwgat/configs.py:14-26, 41-42, 93-109`)."""

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

# Augmentation knobs ≡ `configs.py:14-26`
FRAME_AUGMENTATION = (0.5, 1.5)
SAMPLING_PROB = 0.2
SHEAR_STD = 0.1
ROTATION_STD = 0.1


def build_train_transform(src_len: int, feature_type: str = "keypoints") -> T.Compose:
    """Canonical 29-joint clip → (src_len, 64, C) augmented model input.
    ≡ `configs.py:93-103`."""
    return T.Compose(
        [
            T.KeypointMasking(SAMPLING_PROB, LEFT_HAND_SLICE[0], RIGHT_HAND_SLICE[1]),
            T.HandCorrection(LEFT_HAND_SLICE, RIGHT_HAND_SLICE),
            T.NormalizeKeypoints(ORIGIN_IDX, ANCHOR_POINTS),
            T.ShearTransform(SHEAR_STD),
            T.RotationTransform(ROTATION_STD),
            T.TemporalAugmentation(FRAME_AUGMENTATION, uniform_sample=True, random_sample=True),
            T.TemporalSample(src_len, random_shift=True),
            T.RandomFlip(feature_type),
            T.WindowCreate(src_len),
        ]
    )


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


def build_skeleton_eval_transform(src_len: int) -> T.Compose:
    """Canonical 29-joint clip → (src_len, 29, C) model input for the
    29-joint models (GATE): the eval pipeline without WindowCreate."""
    return T.Compose(build_eval_transform(src_len).transforms[:-1])


def build_skeleton_train_transform(src_len: int, feature_type: str = "keypoints") -> T.Compose:
    """The train pipeline without WindowCreate (29-joint models)."""
    return T.Compose(build_train_transform(src_len, feature_type).transforms[:-1])


def build_static_transform(pose_method: str, input_type: str = "kp2D") -> T.Compose:
    """Extractor output → canonical 29-joint clip (the preprocess-time step)."""
    proc = T.DWPoseDataProcess() if pose_method == "dwpose" else T.MediapipeDataProcess()
    return T.Compose([proc, T.PoseSelect(KP_LIST[pose_method], COORD_LIST[pose_method + input_type])])
