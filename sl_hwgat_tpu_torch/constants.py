"""Dataset registry and keypoint-subset tables.

The port's own copy of ``sl_hwgat_tpu/constants.py`` (reference
`hwgat/constants.py:3-26`): dataset name → class count and the clip length
(``src_len``) every clip is resampled to by the eval pipeline.
"""

from __future__ import annotations

DATASET_PARAMS: dict[str, dict[str, int]] = {
    "INCLUDE": {"num_class": 262, "src_len": 64},
    "INCLUDE_INTERSECTION": {"num_class": 2002, "src_len": 192},
    "FDMSE_INTERSECTION": {"num_class": 262, "src_len": 64},
    "FDMSE-ISL": {"num_class": 2002, "src_len": 192},
    "FDMSE-ISL400": {"num_class": 400, "src_len": 192},
    "FDMSE-ATOMIC": {"num_class": 1099, "src_len": 192},
    "FDMSE_COMPOSITE": {"num_class": 1099, "src_len": 192},
    "WLASL": {"num_class": 2000, "src_len": 64},
    "AUTSL": {"num_class": 226, "src_len": 64},
    "MSASL": {"num_class": 1000, "src_len": 64},
    "LSA64": {"num_class": 64, "src_len": 64},
    # Synthetic datasets of the test and smoke runs (not in the reference).
    "SYNTH": {"num_class": 16, "src_len": 32},
    "SYNTH-2000": {"num_class": 2000, "src_len": 64},
}

# Coordinates per keypoint of each input type (reference `hwgat/constants.py:17`).
INPUT_DIM = {"kp2D": 2, "kp3D": 3}

# 29-keypoint subsets per pose backend (9 body + 10 left hand + 10 right hand).
# Mediapipe holistic output is [33 pose | 468 face | 21 left hand | 21 right
# hand]; dwpose is COCO-WholeBody 133.
_MP_POSE = [0, 2, 5, 11, 12, 13, 14, 15, 16]
_MP_LH = [i + 33 + 468 for i in (0, 4, 5, 8, 9, 12, 13, 16, 17, 20)]
_MP_RH = [i + 21 + 33 + 468 for i in (0, 4, 5, 8, 9, 12, 13, 16, 17, 20)]
_DW_POSE = [0, 1, 2, 5, 6, 7, 8, 9, 10]
_DW_LH = [91, 95, 96, 99, 100, 103, 104, 107, 108, 111]
_DW_RH = [i + 21 for i in _DW_LH]

KP_LIST = {
    "mediapipe": _MP_POSE + _MP_LH + _MP_RH,
    "dwpose": _DW_POSE + _DW_LH + _DW_RH,
}

COORD_LIST = {
    "mediapipekp2D": [0, 1],
    "mediapipekp3D": [0, 1, 2],
    "dwposekp2D": [0, 1],
}

# Indices into the 29-joint canonical skeleton (post-PoseSelect order):
# 0 nose, 1-2 eyes, 3-4 shoulders, 5-6 elbows, 7-8 wrists, 9-18 left hand,
# 19-28 right hand.
ORIGIN_IDX = 0
ANCHOR_POINTS = (3, 4)
LEFT_HAND_SLICE = (9, 19, 7)   # (start, stop, wrist idx)
RIGHT_HAND_SLICE = (19, 29, 8)
