"""Greedy non-maximum suppression over padded, score-sorted candidates.

Counterpart of rs_face_detection_tpu/ops/nms.py.  Every function takes boxes
already sorted by descending score per image, (B, K, 4), plus a validity
mask (B, K) for padding, and returns a (B, K) bool keep mask with the
reference's semantics: "+1" box areas, and box i < j suppresses box j when
both are valid and their IoU is > the threshold.

``nms_numpy`` is the host version over a handful of rows in numpy (TTA's
cross-view merge, pipeline/tta.py), not the detector's NMS.

``nms_mask`` is what the detector calls.  On a CPU tensor it runs the plain
version below; on a CUDA tensor it launches the CUDA kernel
(kernels/nms.py) or raises.  There is no fallback between the two.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def nms_numpy(dets: np.ndarray, thresh: float) -> List[int]:
    """Host greedy NMS over (N, 5) [x1, y1, x2, y2, score] rows: kept row
    indices in descending-score order (stable sort on the score, "+1"
    areas, a neighbour stays when its overlap is <= thresh).  The JAX
    package's ``nms_numpy``; TTA merges its views' post-NMS rows with it."""
    dets = np.asarray(dets, dtype=np.float32)
    scores = dets[:, 4]
    # numpy argsort is stable with kind="stable"; reference sort_by is stable.
    order = list(np.argsort(-scores, kind="stable"))
    keep: List[int] = []
    while order:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        if not rest:
            break
        rest_arr = np.array(rest)
        xx1 = np.maximum(dets[i, 0], dets[rest_arr, 0])
        yy1 = np.maximum(dets[i, 1], dets[rest_arr, 1])
        xx2 = np.minimum(dets[i, 2], dets[rest_arr, 2])
        yy2 = np.minimum(dets[i, 3], dets[rest_arr, 3])
        w = np.maximum(0.0, xx2 - xx1 + 1.0)
        h = np.maximum(0.0, yy2 - yy1 + 1.0)
        inter = w * h
        area_i = (dets[i, 2] - dets[i, 0] + 1.0) * (dets[i, 3] - dets[i, 1] + 1.0)
        area_r = (dets[rest_arr, 2] - dets[rest_arr, 0] + 1.0) * (
            dets[rest_arr, 3] - dets[rest_arr, 1] + 1.0
        )
        ovr = inter / (area_i + area_r - inter)
        order = [rest[k] for k in range(len(rest)) if ovr[k] <= thresh]
    return keep


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(B, K, 4) -> (B, K, K) IoU with the "+1" area convention.

    The operation order is the reference's (ops/nms.py::iou_matrix), which
    the CUDA kernel repeats bit for bit.
    """
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    iw = torch.clamp(
        torch.minimum(x2[:, :, None], x2[:, None, :])
        - torch.maximum(x1[:, :, None], x1[:, None, :])
        + 1.0,
        min=0.0,
    )
    ih = torch.clamp(
        torch.minimum(y2[:, :, None], y2[:, None, :])
        - torch.maximum(y1[:, :, None], y1[:, None, :])
        + 1.0,
        min=0.0,
    )
    inter = iw * ih
    return inter / (area[:, :, None] + area[:, None, :] - inter)


def suppression_matrix(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """S[b, i, j] = True iff box i would suppress the later box j (i < j)."""
    k = boxes.shape[1]
    upper = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    valid = valid.bool()
    return (
        (iou_matrix(boxes) > iou_threshold)
        & upper
        & valid[:, None, :]
        & valid[:, :, None]
    )


def nms_mask_plain(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Plain PyTorch greedy NMS: the CUDA kernel's reference version.

    A sequential scan over the K sorted boxes, vectorised over the batch:
    box i, if still kept, removes every later box it suppresses.
    """
    suppress = suppression_matrix(boxes, valid, iou_threshold)
    keep = valid.bool().clone()
    for i in range(boxes.shape[1]):
        keep &= ~(suppress[:, i, :] & keep[:, i : i + 1])
    return keep


def nms_mask(
    boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float
) -> torch.Tensor:
    """Greedy-NMS keep mask (B, K) bool; the kernel on CUDA, plain on CPU."""
    if boxes.device.type == "cuda":
        from ..kernels.nms import nms_mask_cuda

        return nms_mask_cuda(boxes, valid, iou_threshold)
    if boxes.device.type == "cpu":
        return nms_mask_plain(boxes, valid, iou_threshold)
    raise ValueError(f"nms_mask: unsupported device {boxes.device}")
