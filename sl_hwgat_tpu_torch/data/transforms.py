"""Keypoint transforms of the train and eval pipelines — NumPy/SciPy, host side.

The port's own copy of ``sl_hwgat_tpu/data/transforms.py`` (reference
`hwgat/dataTransform.py`): every callable takes and returns (T, V, C) float
arrays and must give exactly the JAX package's output. The stochastic ones draw from the
``np.random.Generator`` they are handed, in the JAX package's order.
"""

from __future__ import annotations

import numpy as np
from scipy import interpolate

from sl_hwgat_tpu_torch.graphs.skeleton import WINDOW_JOINTS


class Compose:
    """Sequential application; rng is threaded to transforms that accept it.
    ≡ `dataTransform.py:9-31`."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, x, rng: np.random.Generator | None = None):
        for t in self.transforms:
            x = t(x, rng) if getattr(t, "stochastic", False) else t(x)
        return x


class MediapipeDataProcess:
    """Denormalize x,y by video size. ≡ `dataTransform.py:61-71`.
    Input: dict {'feat', 'vid_width', 'vid_height'} → (T, 543, 4)."""

    def __call__(self, data):
        feat = data["feat"]
        feat[:, :, 0] = feat[:, :, 0] * data["vid_width"]
        feat[:, :, 1] = feat[:, :, 1] * data["vid_height"]
        return feat


class DWPoseDataProcess:
    """Zero hands when the wrist sits at the bottom edge or has low visibility.
    ≡ `dataTransform.py:33-59`."""

    def __init__(self):
        self.left_idx = [9, 91, 95, 96, 99, 100, 103, 104, 107, 108, 111]
        self.right_idx = [10] + [i + 21 for i in self.left_idx[1:]]
        self.visibility_threshold = 0.5

    def __call__(self, data):
        feat = data["feat"]
        for idx in (self.left_idx, self.right_idx):
            wrist, hand = idx[0], idx[1:]
            # both tests read the wrist only, which the zeroing never touches
            at_bottom = feat[:, wrist, 1] > 0.95 * np.max(feat[:, wrist, 1])
            hidden = feat[:, wrist, -1] < self.visibility_threshold
            for frames in (np.where(at_bottom)[0], np.where(hidden)[0]):
                if frames.size > 1:
                    block = feat[np.ix_(frames, hand)]
                    block[..., :-1] = 0  # keep the visibility channel
                    feat[np.ix_(frames, hand)] = block
        return feat


class PoseSelect:
    """Select keypoint + coordinate subsets. ≡ `dataTransform.py:74-82`."""

    def __init__(self, kp_list, coord_list):
        self.kp_idx = list(kp_list)
        self.coord_list = list(coord_list)

    def __call__(self, data):
        data = np.take(data, self.kp_idx, axis=1)
        return np.take(data, self.coord_list, axis=2)


class NormalizeKeypoints:
    """Shoulder-anchored canonical box normalization. ≡ `dataTransform.py:84-109`.

    The first frame with nonzero origin + anchors defines
    origin = nose − (3u, 2u), scale = 6u with u = ‖shoulderL − shoulderR‖;
    the whole clip is normalized by that frame's box.
    """

    def __init__(self, origin_idx, anchor_points_idx):
        assert len(anchor_points_idx) == 2
        self.origin_idx = origin_idx
        self.anchors = anchor_points_idx

    def __call__(self, vid):
        for keypoints in vid:
            if (
                keypoints[self.origin_idx].all() != 0
                and keypoints[self.anchors[0]].all() != 0
                and keypoints[self.anchors[1]].all() != 0
            ):
                root = keypoints[self.origin_idx]
                unit = np.linalg.norm(keypoints[self.anchors[0]] - keypoints[self.anchors[1]])
                left_top = root - 3 * unit
                left_top[1] = root[1] - 2 * unit
                return (vid - left_top) / (6 * unit)
        raise ValueError(
            "NormalizeKeypoints: no frame with valid origin/anchor joints "
            "(the reference would crash with UnboundLocalError here; degenerate "
            "clips are filtered in preprocessing, data_preprocess.py:81-82)"
        )


class RandomFlip:
    """p=0.5 horizontal flip: x ← 1 − x. ≡ `dataTransform.py:111-121`."""

    stochastic = True

    def __init__(self, feature_type="keypoints"):
        self.feature_type = feature_type

    def __call__(self, data, rng):
        if rng.uniform() <= 0.5:
            if self.feature_type == "rgb":
                data = np.flip(data, axis=2)
            else:
                data[:, :, 0] = -data[:, :, 0] + 1
        return data


class Rectifier3Dto2D:
    """Drop z. ≡ `dataTransform.py:123-129`."""

    def __call__(self, data):
        return data[:, :, :2]


class ShearTransform:
    """Random 2D shear about a random origin. ≡ `dataTransform.py:132-160`."""

    stochastic = True

    def __init__(self, shear_std=0.2):
        self.shear_std = shear_std

    def __call__(self, data, rng):
        origin = np.clip(rng.normal(0.5, 0.1, size=data.shape[2]), 0, 1)
        x = data - origin
        shear = np.eye(2)
        shear[0][1] = rng.normal(0, self.shear_std)
        x[:, :, :2] = x[:, :, :2] @ shear
        return x + origin


class ShearTransform3D:
    """3D shear variant (no default pipeline uses it). ≡ `dataTransform.py:
    162-198`, with its quirk: the three partial shear matrices alias one
    identity, so the later writes overwrite the earlier ones before the
    product ``m @ m @ m``. The reference assigns the (T, V, 3) product into
    ``x[:, :, :2]``, which raises; here all three coordinates take it, as in
    the JAX package."""

    stochastic = True

    def __init__(self, shear_std=0.2):
        self.shear_std = shear_std

    def __call__(self, data, rng):
        origin = np.clip(rng.normal(0.5, 0.1, size=data.shape[2]), 0, 1)
        x = data - origin
        a, b, c = rng.normal(0, self.shear_std, size=3)
        m = np.eye(3)
        m[0, 1] = b
        m[0, 2] = c
        m[1, 0] = a
        m[1, 2] = c
        m[2, 0] = a
        m[2, 1] = b
        x[:, :, :3] = np.matmul(x[:, :, :3], m @ m @ m)
        return x + origin


class RotationTransform:
    """Random 2D rotation (3D Euler path for C=3). ≡ `dataTransform.py:200-234`."""

    stochastic = True

    def __init__(self, rotation_std=0.2):
        self.rotation_std = rotation_std

    def __call__(self, data, rng):
        origin = np.clip(rng.normal(0.5, 0.1, size=data.shape[2]), 0, 1)
        x = data - origin
        if x.shape[2] == 2:
            a = rng.normal(0, self.rotation_std)
            c, s = np.cos(a), np.sin(a)
            res = x @ np.array([[c, -s], [s, c]])
        else:
            from scipy.spatial.transform import Rotation as R

            thetas = rng.normal(0, self.rotation_std, size=3) * 90
            res = x @ R.from_euler("xyz", thetas, degrees=True).as_matrix()
        return res + origin


class KeypointMasking:
    """Zero hand joints in a random fraction of frames. ≡ `dataTransform.py:236-253`."""

    stochastic = True

    def __init__(self, sampling_prob=0.2, start_kp=9, end_kp=29):
        self.sampling_prob = sampling_prob
        self.start_kp = start_kp
        self.end_kp = end_kp

    def __call__(self, data, rng):
        n = int(self.sampling_prob * data.shape[0])
        choices = np.sort(rng.choice(data.shape[0], size=n, replace=False))
        data[choices, self.start_kp : self.end_kp] = 0.0
        return data


class TemporalAugmentation:
    """Resample clip length by ratio U(a, b). ≡ `dataTransform.py:255-289`."""

    stochastic = True

    def __init__(self, frame_augmentation=(0.5, 1.5), uniform_sample=True, random_sample=False):
        self.frame_augmentation = frame_augmentation
        self.uniform_sample = uniform_sample
        self.random_sample = random_sample

    def __call__(self, data, rng):
        a, b = self.frame_augmentation
        ratio = (b - a) * rng.uniform() + a
        n = int(data.shape[0] * ratio)
        if rng.uniform() < 0.5 and self.random_sample:
            if ratio <= 1:
                choices = np.sort(rng.choice(data.shape[0], size=n, replace=False))
            else:
                choices = np.sort(rng.choice(data.shape[0], size=n, replace=True))
            return data[choices]
        choices = np.linspace(0, data.shape[0] - 1, num=n).astype(int)
        return data[choices]


class TemporalSample:
    """Pad to ``max_len`` with edge-frame replication at a (random-shifted)
    offset, or uniformly downsample longer clips. ≡ `dataTransform.py:291-326`."""

    stochastic = True

    def __init__(self, max_length=64, random_shift=False):
        self.max_len = max_length
        self.random_shift = random_shift
        self.scale_std = 0.1

    def __call__(self, x, rng=None):
        if x.shape[0] <= self.max_len:
            if not self.random_shift or rng is None:
                sample = 0.5
            else:
                sample = float(np.clip(rng.normal(0.5, self.scale_std), 0, 1))
            index = int((self.max_len - x.shape[0]) * sample)
            front = np.full((self.max_len // 2, x.shape[1], x.shape[2]), x[0], dtype=np.float32)
            back = np.full(
                (self.max_len - self.max_len // 2, x.shape[1], x.shape[2]), x[-1], dtype=np.float32
            )
            out = np.concatenate([front, back], axis=0)
            out[index : index + x.shape[0]] = x
            return out
        choices = np.linspace(0, x.shape[0] - 1, num=self.max_len).astype(int)
        return x[choices]


class HandCorrection:
    """Inpaint missing hand detections. ≡ `dataTransform.py:328-404`.

    Leading/trailing all-zero hand frames copy the wrist; interior gaps are
    filled with quadratic B-spline interpolation per joint per coordinate.
    Spline failures are silently ignored, as in the reference (`:395-396`).
    """

    def __init__(self, left_slice=(9, 19, 7), right_slice=(19, 29, 8), k_spline=2):
        self.left_slice = left_slice
        self.right_slice = right_slice
        self.k_spline = k_spline

    def _correct(self, vid, slices):
        lo, hi, wrist = slices
        dim = vid.shape[2]
        if np.sum(vid[:, lo:hi]) == 0:
            vid[:, lo:hi, :] = vid[:, wrist, :][:, None, :]
            return vid
        start = end = 0
        for t in range(len(vid)):
            if not vid[t, lo:hi].any():
                vid[t, lo:hi, :] = vid[t, wrist, :][None, :]
            else:
                start = t
                break
        for t in reversed(range(len(vid))):
            if not vid[t, lo:hi].any():
                vid[t, lo:hi, :] = vid[t, wrist, :][None, :]
            else:
                end = t
                break
        present, missing = [], []
        for t in range(start, end + 1):
            (present if vid[t, lo:hi].any() else missing).append(t)
        try:
            for kp in range(lo, hi):
                series = [np.take(vid, present, 0)[:, kp, c] for c in range(dim)]
                for t in missing:
                    for c in range(dim):
                        tck = interpolate.splrep(present, series[c], k=self.k_spline)
                        vid[t, kp, c] = interpolate.splev(t, tck)
        except Exception:
            pass
        return vid

    def __call__(self, data):
        data = self._correct(data, self.left_slice)
        return self._correct(data, self.right_slice)


class ValidFrames:
    """Drop frames with a joint out of range. ≡ `dataTransform.py:406-424`."""

    def __init__(self, x_range=(0, 1), y_range=(0, 1)):
        self.x_range = x_range
        self.y_range = y_range

    def __call__(self, data):
        x_ok = (data[:, :, 0] >= self.x_range[0]) & (data[:, :, 0] <= self.x_range[1])
        y_ok = (data[:, :, 1] >= self.y_range[0]) & (data[:, :, 1] <= self.y_range[1])
        mask = x_ok.all(axis=1) & y_ok.all(axis=1)
        if mask.sum() < 2:
            return data
        return data[mask]


class WindowCreate:
    """Final layout: 29 joints → 4 overlapping body-part windows × 16 joints.
    ≡ `dataTransform.py:426-455`. Load-bearing: the model's window structure
    is baked into this data layout (head/arm joints duplicated per window)."""

    def __init__(self, max_len):
        self.window_idx = WINDOW_JOINTS
        self.max_len = max_len

    def __call__(self, data):
        out = np.zeros((self.max_len, 64, data.shape[-1]), dtype=data.dtype)
        for w, idx in enumerate(self.window_idx):
            out[:, 16 * w : 16 * (w + 1)] = data.take(idx, 1)
        return out
