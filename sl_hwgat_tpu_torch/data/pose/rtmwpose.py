"""RTMW-Pose backend via mmpose top-down inference → (133, 3) keypoints.

≡ ``sl_hwgat_tpu/data/pose/rtmwpose.py`` and reference
`hwgat/pose_modules/RTMWPose.py:8-29`; on the card by default, as the
DWPose backend.
"""

from __future__ import annotations

from sl_hwgat_tpu_torch.data.pose.dwpose import Model as _DWModel

DEFAULT_CONFIG = (
    "configs/wholebody_2d_keypoint/rtmpose/cocktail14/"
    "rtmw-x_8xb704-270e_cocktail14-256x192.py"
)
DEFAULT_CHECKPOINT = "weights/rtmw-x_simcc-cocktail14_pt-ucoco_270e-256x192.pth"


class Model(_DWModel):
    def __init__(self, config_file=None, checkpoint_file=None, device="cuda"):
        super().__init__(
            config_file or DEFAULT_CONFIG, checkpoint_file or DEFAULT_CHECKPOINT, device
        )
