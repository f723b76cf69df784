"""Heuristic face selection: choose one face from the detector output.

The port's numpy copy of rs_face_detection_tpu/pipeline/selection.py (that
module sits under a package ``__init__`` that imports JAX); the tests hold
the two equal.  Branch-heavy scalar logic over at most max_detections rows,
so it stays on the host.

Enroll mode picks the biggest-area face.  Normal mode applies a margin-edge
filter and a minimum area ratio, then a center-band filter, falls back
center -> valid -> all, and picks the largest (w + h).  Area is
width*height; ``compat_area_bug=True`` squares the width as the original
Rust selection does.  Keypoints are re-associated by row index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..configs import FaceSelectionConfig


class FaceSelection:
    def __init__(
        self,
        cfg: Optional[FaceSelectionConfig] = None,
        compat_area_bug: bool = False,
    ) -> None:
        self.cfg = cfg or FaceSelectionConfig()
        self.compat_area_bug = compat_area_bug

    def __call__(
        self,
        image_shape: Tuple[int, int],
        face_boxes: np.ndarray,
        key_points: Optional[np.ndarray],
        is_enroll: bool = False,
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Select one face.

        Args:
          image_shape: (height, width) of the original image.
          face_boxes: (N, 5+) [x1, y1, x2, y2, score, ...].
          key_points: (N, 5, 2) landmarks aligned with face_boxes rows, or None.
          is_enroll: enroll-mode selection (biggest face).

        Returns:
          (selected_box (5+,) or None, selected_keypoints (5, 2) or None).
        """
        face_boxes = np.asarray(face_boxes, dtype=np.float32)
        if face_boxes.ndim != 2 or face_boxes.shape[0] == 0:
            return None, None
        height, width = float(image_shape[0]), float(image_shape[1])

        if is_enroll:
            idx = self._biggest_area_index(face_boxes)
            if idx is None:
                return None, None
            kp = key_points[idx] if key_points is not None else None
            return face_boxes[idx].copy(), (None if kp is None else np.array(kp))

        cfg = self.cfg
        margin_center_left = cfg.margin_center_left_ratio * width
        margin_center_right = cfg.margin_center_right_ratio * width
        margin_edge = min(50.0, cfg.margin_edge_ratio * width)
        x_cen = width / 2.0

        indices = np.arange(face_boxes.shape[0])
        x1, y1, x2, y2 = (face_boxes[:, i] for i in range(4))
        if self.compat_area_bug:
            area = (x2 - x1) * (x2 - x1)  # reference face_selection.rs:117
        else:
            area = (x2 - x1) * (y2 - y1)
        cx = (x1 + x2) / 2.0
        cy = (y1 + y2) / 2.0
        valid_mask = (
            (cx >= margin_edge)
            & (cx <= width - margin_edge)
            & (cy >= margin_edge)
            & (cy <= height - margin_edge)
            & (area / (height * width) >= cfg.minimum_face_ratio)
        )
        valid = indices[valid_mask]

        center_mask = (-margin_center_left <= cx - x_cen) & (
            cx - x_cen <= margin_center_right
        )
        center = indices[valid_mask & center_mask]

        if center.size == 0:
            center = valid if valid.size > 0 else indices

        sizes = (x2[center] - x1[center]) + (y2[center] - y1[center])
        # Reference keeps the first strict maximum (tem_size > max_size,
        # :151) with max_size starting at 0.0 — if every candidate is
        # degenerate (size <= 0) it selects NOTHING; mirror that instead of
        # returning a collapsed box to alignment/embedding.
        best = center[int(np.argmax(sizes))] if center.size else None
        if best is None or sizes.size == 0 or float(np.max(sizes)) <= 0.0:
            return None, None

        kp = key_points[best] if key_points is not None else None
        return face_boxes[best].copy(), (None if kp is None else np.array(kp))

    def _biggest_area_index(self, face_boxes: np.ndarray) -> Optional[int]:
        x1, y1, x2, y2 = (face_boxes[:, i] for i in range(4))
        areas = (x2 - x1) * (y2 - y1)
        if areas.size == 0:
            return None
        # Reference keeps the first strict maximum over 0 (:44); areas <= 0
        # select nothing.
        best = int(np.argmax(areas))
        if areas[best] <= 0.0:
            return None
        return best

    def is_face_area_big_enough(
        self, image_shape: Tuple[int, int], face_box: np.ndarray
    ) -> bool:
        """Enroll-mode width check (face_selection.rs:54-70)."""
        width = float(image_shape[1])
        face_width = float(face_box[2] - face_box[0])
        return face_width / width > self.cfg.enroll_min_width_ratio
