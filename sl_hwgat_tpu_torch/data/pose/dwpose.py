"""DWPose backend via mmpose top-down inference → (133, 3) keypoints.

≡ ``sl_hwgat_tpu/data/pose/dwpose.py`` and reference
`hwgat/pose_modules/DWPose.py:8-23`, except that the network runs on the
card by default (``device="cuda"``, refused when no card is present);
``device="cpu"`` asks for the host.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_CONFIG = (
    "configs/wholebody_2d_keypoint/rtmpose/ubody/"
    "rtmpose-l_8xb32-270e_coco-ubody-wholebody-384x288.py"
)
DEFAULT_CHECKPOINT = "weights/dw-ll_ucoco_384.pth"


class Model:
    def __init__(self, config_file=None, checkpoint_file=None, device="cuda"):
        try:
            from mmpose.apis import inference_topdown, init_model
            from mmpose.utils import register_all_modules
        except ImportError as e:  # pragma: no cover - optional dependency
            raise ImportError("mmpose is not installed; 'dwpose' backend unavailable") from e
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"the mmpose backend was asked for {device!r} and no card is "
                               "present (device='cpu' runs it on the host)")
        register_all_modules()
        self._inference = inference_topdown
        self.model = init_model(
            config_file or DEFAULT_CONFIG, checkpoint_file or DEFAULT_CHECKPOINT, device
        )

    def __call__(self, image):
        results = self._inference(self.model, image)[0]
        inst = results.pred_instances
        if inst.keypoints.any():
            kp = np.concatenate(
                [inst.keypoints[0], inst.keypoint_scores[0][:, None]], axis=1
            )
        else:
            kp = np.zeros((133, 3))
        return kp, *results.img_shape
