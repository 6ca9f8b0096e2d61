"""Pose-extraction backends behind a uniform duck-type:
``Model()(image) -> (keypoints (K, C), height, width)``.

≡ ``sl_hwgat_tpu/data/pose/__init__.py`` (the registry names the port's
own backend modules) and reference
`hwgat/pose_modules/keypoint_extract_models.py:1-6`. Backends are
import-gated: mediapipe / mmpose are optional heavy dependencies. The
mmpose backends (dwpose, rtmwpose) run on ``device``, the card by default;
mediapipe runs on the host whatever ``device`` says (``host_only``: its
Python library runs the network on the CPU).
"""

KEYPOINT_MODEL_DICT = {
    "dwpose": {"module": "sl_hwgat_tpu_torch.data.pose.dwpose", "shape": (133, 3),
               "host_only": False},
    "rtmwpose": {"module": "sl_hwgat_tpu_torch.data.pose.rtmwpose", "shape": (133, 3),
                 "host_only": False},
    "mediapipe": {"module": "sl_hwgat_tpu_torch.data.pose.mediapipe_backend",
                  "shape": (543, 4), "host_only": True},
}


def load_pose_model(name: str, device: str = "cuda", **kwargs):
    import importlib

    info = KEYPOINT_MODEL_DICT[name]
    mod = importlib.import_module(info["module"])
    if not info["host_only"]:
        kwargs["device"] = device
    return mod.Model(**kwargs), info["shape"]
