"""MediaPipe Holistic backend → (543, 4) keypoints per frame.

≡ ``sl_hwgat_tpu/data/pose/mediapipe_backend.py`` and reference
`hwgat/pose_modules/Mediapipe.py:8-35`: output layout is
[33 pose | 468 face | 21 left hand | 21 right hand] × (x, y, z, visibility),
with visibility defaulting to 1 for face/hands and zero-filled blocks for
undetected parts.
"""

from __future__ import annotations

import numpy as np

try:
    import mediapipe as mp
except ImportError:  # pragma: no cover - optional dependency
    mp = None


class Model:
    def __init__(self):
        if mp is None:
            raise ImportError("mediapipe is not installed; pose extraction for "
                              "'mediapipe' backend unavailable")
        self.holistic = mp.solutions.holistic.Holistic(
            model_complexity=2, min_detection_confidence=0.0, min_tracking_confidence=0.0
        )

    def __call__(self, image):
        if isinstance(image, str):
            import cv2

            image = cv2.cvtColor(cv2.imread(image), cv2.COLOR_BGR2RGB)
        results = self.holistic.process(image)
        return self._features(results), *image.shape[:2]

    @staticmethod
    def _features(results) -> np.ndarray:
        def block(landmarks, n, with_vis):
            if landmarks is None:
                return np.zeros((n, 4))
            return np.array(
                [
                    [p.x, p.y, p.z, p.visibility if with_vis else 1]
                    for p in landmarks.landmark
                ]
            )

        return np.concatenate(
            [
                block(results.pose_landmarks, 33, True),
                block(results.face_landmarks, 468, False),
                block(results.left_hand_landmarks, 21, False),
                block(results.right_hand_landmarks, 21, False),
            ]
        )
