"""Run configuration and transform pipelines, the port's own copy of
``sl_hwgat_tpu/configs.py`` (reference `hwgat/configs.py:10-143`): the same
defaults, knobs and output-artifact paths, plus the device a run takes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from datetime import datetime

from sl_hwgat_tpu_torch.constants import (
    ANCHOR_POINTS,
    COORD_LIST,
    DATASET_PARAMS,
    INPUT_DIM,
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


@dataclass
class DataConfig:
    """Paths of the four preprocessed artifacts (≡ `configs.py:34-49`)."""

    dataset_name: str
    feature_type: str = "keypoints"
    input_root: str = "input"

    @property
    def class_map_path(self):
        return f"{self.input_root}/{self.dataset_name}/class_map_{self.dataset_name}.csv"

    @property
    def vid_split_path(self):
        return f"{self.input_root}/{self.dataset_name}/vid_splits_{self.dataset_name}.pkl"

    @property
    def vid_class_path(self):
        return f"{self.input_root}/{self.dataset_name}/vid_class_{self.dataset_name}.pkl"

    @property
    def data_map_path(self):
        return (
            f"{self.input_root}/{self.dataset_name}/"
            f"data_map_{self.dataset_name}_{self.feature_type}.pkl"
        )


@dataclass
class RunConfig:
    """≡ `runCFG` (`configs.py:52-143`), with the JAX package's defaults.
    ``device``: where the model runs, ``"cuda"`` unless a caller asks for the
    CPU."""

    dataset: str
    model_type: str = "HWGATE"
    mode: str = "train"            # train | test | load
    feature_type: str = "keypoints"
    input_type: str = "kp2D"
    time: str = "none"
    postfix: str = "none"
    model_weights: str | None = None
    topk: int = 1

    seed: int = 1001               # ≡ configs.py:55-59
    criterion_type: str = "smooth_cross_entropy"
    optimizer_type: str = "adamw"
    scheduler: str = "CosineAnnealingLR"
    scheduler_t_max: int = 20
    early_stopping: bool = False
    early_stopping_step: int = 400

    lr: float = 5e-4
    start_epoch: int = 0
    epochs: int = 500
    batch_size: int = 4
    n_workers: int = 8
    save_interval: int = 100

    input_root: str = "input"
    output_root: str = "output"
    ckpt_backend: str = "pickle"   # 'pickle' (one file) | 'orbax' (sharded directory)
    grad_accum: int = 1            # microbatches per optimizer update
    device: str = "cuda"

    # model constructor overrides (tests, small runs, the CLI's model flags)
    overrides: dict = field(default_factory=dict)

    def __post_init__(self):
        ds = DATASET_PARAMS[self.dataset]
        self.src_len = ds["src_len"]
        self.num_class = ds["num_class"]
        self.input_dim = INPUT_DIM[self.input_type]
        self.dataset_params = ds
        if self.time == "none":
            self.time = datetime.now().strftime("%Y%m%d_%H%M")[2:]
        if self.postfix == "none":
            self.postfix = "best_loss"
        if self.model_weights == "none":
            self.model_weights = None
        self.data = DataConfig(self.dataset, self.feature_type, self.input_root)

    # --- transforms (windowed vs raw-skeleton models) -----------------------
    @property
    def uses_windowed_layout(self) -> bool:
        from sl_hwgat_tpu_torch.models import MODEL_NUM_KPS

        return MODEL_NUM_KPS[self.model_type] == 64

    def train_transform(self):
        if self.uses_windowed_layout:
            return build_train_transform(self.src_len, self.feature_type)
        return build_skeleton_train_transform(self.src_len, self.feature_type)

    def eval_transform(self):
        if self.uses_windowed_layout:
            return build_eval_transform(self.src_len)
        return build_skeleton_eval_transform(self.src_len)

    # --- output artifact paths (≡ configs.py:133-143) -----------------------
    @property
    def save_suffix(self):
        return f"{self.model_type}_{self.time}"

    @property
    def out_folder(self):
        return f"{self.output_root}/{self.dataset}/{self.save_suffix}"

    @property
    def save_config_path(self):
        return f"{self.out_folder}/config.pkl"

    @property
    def save_model_path(self):
        return f"{self.out_folder}/model"

    @property
    def save_cm_path(self):
        return f"{self.out_folder}/cm_list_w.csv"

    @property
    def save_loss_curve_path(self):
        return f"{self.out_folder}/loss_curve.png"

    @property
    def save_acc_curve_path(self):
        return f"{self.out_folder}/acc_curve.png"

    def ensure_out_folder(self):
        os.makedirs(self.out_folder, exist_ok=True)
        return self.out_folder
