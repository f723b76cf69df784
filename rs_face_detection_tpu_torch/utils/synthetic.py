"""Synthetic face-like scenes for evaluation fixtures (numpy).

The port's copy of rs_face_detection_tpu/utils/synthetic.py: bright square
"faces" with dark eye dots and a fixed 5-point landmark pattern on a noise
background, drawn from a seeded numpy generator.  tests/test_torch_eval.py
holds it equal to the original, draw for draw.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: Landmark pattern (fractions of the face square): eyes, nose, mouth corners.
LANDMARK_TEMPLATE = np.array(
    [[0.25, 0.35], [0.75, 0.35], [0.5, 0.55], [0.3, 0.8], [0.7, 0.8]]
)


def synth_scene(
    rng: np.random.Generator,
    h: int = 64,
    w: int = 64,
    max_faces: int = 2,
    min_size: int = 14,
    max_size: int = 28,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One scene: (img (h,w,3) f32 [0,255], boxes (max_faces,4), lms
    (max_faces,5,2), valid (max_faces,) bool)."""
    img = rng.uniform(0, 50, (h, w, 3)).astype(np.float32)
    boxes = np.zeros((max_faces, 4), np.float32)
    lms = np.zeros((max_faces, 5, 2), np.float32)
    valid = np.zeros((max_faces,), bool)
    for f in range(int(rng.integers(1, max_faces + 1))):
        s = int(rng.integers(min_size, max_size))
        x = int(rng.integers(0, w - s))
        y = int(rng.integers(0, h - s))
        img[y : y + s, x : x + s] = rng.uniform(180, 255)
        img[y + s // 4 : y + s // 4 + 2, x + s // 4 : x + s // 4 + 2] = 30
        img[y + s // 4 : y + s // 4 + 2, x + 3 * s // 4 : x + 3 * s // 4 + 2] = 30
        boxes[f] = (x, y, x + s - 1, y + s - 1)
        lms[f] = np.array([x, y]) + LANDMARK_TEMPLATE * s
        valid[f] = True
    return img, boxes, lms, valid


def synth_batch_arrays(
    rng: np.random.Generator,
    batch: int,
    h: int = 64,
    w: int = 64,
    max_faces: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stacked batch of synth_scene outputs (images f32, boxes, lms, valid)."""
    imgs = np.zeros((batch, h, w, 3), np.float32)
    boxes = np.zeros((batch, max_faces, 4), np.float32)
    lms = np.zeros((batch, max_faces, 5, 2), np.float32)
    valid = np.zeros((batch, max_faces), bool)
    for b in range(batch):
        imgs[b], boxes[b], lms[b], valid[b] = synth_scene(rng, h, w, max_faces)
    return imgs, boxes, lms, valid


def synth_eval_set(
    rng: np.random.Generator, n: int, h: int = 64, w: int = 64, max_faces: int = 2
):
    """[(img_u8, gt_boxes (k,4))] pairs for ops.eval.evaluate_detector."""
    dataset = []
    for _ in range(n):
        img, boxes, _, valid = synth_scene(rng, h, w, max_faces)
        dataset.append(
            (np.clip(img, 0, 255).astype(np.uint8), boxes[valid].copy())
        )
    return dataset
