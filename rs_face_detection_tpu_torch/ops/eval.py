"""Detection evaluation: WIDER-FACE-style average precision (host numpy).

The port's copy of rs_face_detection_tpu/ops/eval.py, as written: greedy
score-ordered matching of each detection to its best-overlap ground truth
at an IoU threshold (each GT matched at most once), stable sorts, and the
all-points-interpolated AP.  ``evaluate_detector`` runs any callable
detector over an in-memory dataset; tests/test_torch_eval.py holds every
function equal to JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

from ..pipeline.tracking import iou_matrix_np


@dataclass
class ImageEval:
    """Per-image match bookkeeping."""

    scores: np.ndarray  # (D,) detection scores
    matched: np.ndarray  # (D,) bool: matched a GT
    num_gt: int


def match_detections(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    gt_boxes: np.ndarray,
    iou_threshold: float = 0.5,
) -> ImageEval:
    """Greedy score-ordered matching of detections to ground truth."""
    det_boxes = np.asarray(det_boxes, np.float32).reshape(-1, 4)
    det_scores = np.asarray(det_scores, np.float32).reshape(-1)
    gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)

    order = np.argsort(-det_scores, kind="stable")
    iou = iou_matrix_np(det_boxes[order], gt_boxes)  # (D, G)
    gt_taken = np.zeros(gt_boxes.shape[0], dtype=bool)
    matched = np.zeros(det_boxes.shape[0], dtype=bool)
    for rank, d in enumerate(order):
        if gt_boxes.shape[0] == 0:
            break
        # PASCAL/WIDER rule (and wider_split.image_eval): each detection is
        # judged against its BEST-overlap GT; if that GT is already taken,
        # the detection is a false positive.  Re-matching to the best
        # UNMATCHED GT would be more lenient on crowded scenes and inflate
        # AP versus the standard protocol.
        g = int(np.argmax(iou[rank]))
        if iou[rank, g] >= iou_threshold and not gt_taken[g]:
            gt_taken[g] = True
            matched[d] = True
    return ImageEval(det_scores, matched, gt_boxes.shape[0])


def average_precision(evals: Sequence[ImageEval]) -> Dict[str, float]:
    """All-points-interpolated AP over a set of per-image match results."""
    total_gt = sum(e.num_gt for e in evals)
    if total_gt == 0:
        return {"ap": 0.0, "precision": 0.0, "recall": 0.0, "num_gt": 0}

    scores = np.concatenate([e.scores for e in evals]) if evals else np.zeros(0)
    matched = (
        np.concatenate([e.matched for e in evals])
        if evals
        else np.zeros(0, dtype=bool)
    )
    order = np.argsort(-scores, kind="stable")
    tp = np.cumsum(matched[order])
    fp = np.cumsum(~matched[order])
    recall = tp / total_gt
    precision = tp / np.maximum(tp + fp, 1)

    # All-points interpolation (monotone precision envelope), vectorized.
    prec_env = np.maximum.accumulate(precision[::-1])[::-1]
    ap = float(np.sum(np.diff(recall, prepend=0.0) * prec_env))
    return {
        "ap": float(ap),
        "precision": float(precision[-1]) if precision.size else 0.0,
        "recall": float(recall[-1]) if recall.size else 0.0,
        "num_gt": int(total_gt),
    }


def evaluate_detector(
    detector: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
    dataset: Sequence[Tuple[np.ndarray, np.ndarray]],
    iou_threshold: float = 0.5,
) -> Dict[str, float]:
    """Run `detector(image) -> (boxes (N, 5), kps)` over (image, gt_boxes) pairs."""
    evals = []
    for image, gt_boxes in dataset:
        boxes, _ = detector(image)
        boxes = np.asarray(boxes, np.float32)  # accept plain-list returns
        boxes = boxes.reshape(-1, boxes.shape[-1] if boxes.size else 5)
        evals.append(
            match_detections(boxes[:, :4], boxes[:, 4], gt_boxes, iou_threshold)
        )
    return average_precision(evals)
