"""Box / landmark delta decoding and clipping on tensors.

Counterpart of rs_face_detection_tpu/ops/box_decode.py (``bbox_pred``,
``landmark_pred``, ``clip_boxes``, ``bbox_overlaps``, and SCRFD's
``distance2bbox`` and ``distance2kps``), with the same "+1" width/height convention and operation
order.  Every function takes any number of leading batch dimensions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import tracing


def _whctr(boxes: torch.Tensor):
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * (widths - 1.0)
    ctr_y = boxes[..., 1] + 0.5 * (heights - 1.0)
    return widths, heights, ctr_x, ctr_y


def bbox_pred(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Decode (..., 4) center/size deltas against (..., 4) corner anchors."""
    widths, heights, ctr_x, ctr_y = _whctr(anchors)
    pred_ctr_x = deltas[..., 0] * widths + ctr_x
    pred_ctr_y = deltas[..., 1] * heights + ctr_y
    pred_w = torch.exp(deltas[..., 2]) * widths
    pred_h = torch.exp(deltas[..., 3]) * heights
    return torch.stack(
        [
            pred_ctr_x - 0.5 * (pred_w - 1.0),
            pred_ctr_y - 0.5 * (pred_h - 1.0),
            pred_ctr_x + 0.5 * (pred_w - 1.0),
            pred_ctr_y + 0.5 * (pred_h - 1.0),
        ],
        dim=-1,
    )


def landmark_pred(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Decode (..., 5, 2) landmark deltas against (..., 4) corner anchors."""
    widths, heights, ctr_x, ctr_y = _whctr(anchors)
    x = deltas[..., 0] * widths[..., None] + ctr_x[..., None]
    y = deltas[..., 1] * heights[..., None] + ctr_y[..., None]
    return torch.stack([x, y], dim=-1)


def clip_boxes(boxes: torch.Tensor, im_shape: Tuple[int, int]) -> torch.Tensor:
    """Clamp (..., 4) corner boxes to [0, W-1] x [0, H-1]; im_shape is (H, W)."""
    height, width = im_shape
    bound = torch.tensor(
        [width - 1.0, height - 1.0, width - 1.0, height - 1.0],
        dtype=boxes.dtype,
        device=boxes.device,
    )
    tracing.host_sync(boxes.device)
    return torch.minimum(torch.clamp(boxes, min=0.0), bound)


def distance2bbox(points: torch.Tensor, distances: torch.Tensor) -> torch.Tensor:
    """Decode (..., 4) [l, t, r, b] pixel distances against (..., 2) anchor
    centers into (..., 4) corner boxes: the SCRFD parameterization
    (rs_face_detection_tpu/ops/box_decode.py::distance2bbox)."""
    x1 = points[..., 0] - distances[..., 0]
    y1 = points[..., 1] - distances[..., 1]
    x2 = points[..., 0] + distances[..., 2]
    y2 = points[..., 1] + distances[..., 3]
    return torch.stack([x1, y1, x2, y2], dim=-1)


def distance2kps(points: torch.Tensor, distances: torch.Tensor) -> torch.Tensor:
    """Decode (..., 5, 2) landmark offsets against (..., 2) anchor centers."""
    return points[..., None, :] + distances


def bbox_overlaps(boxes: torch.Tensor, query_boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., K, 4) -> (..., N, K) IoU with the "+1" area
    convention; 0 where the boxes do not intersect.  Leading dimensions
    broadcast (the anchor table against a batch of ground truth)."""
    b = boxes[..., :, None, :]
    q = query_boxes[..., None, :, :]
    iw = torch.clamp(torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0], q[..., 0]) + 1.0, min=0.0)
    ih = torch.clamp(torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1], q[..., 1]) + 1.0, min=0.0)
    inter = iw * ih
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    area_q = (q[..., 2] - q[..., 0] + 1.0) * (q[..., 3] - q[..., 1] + 1.0)
    union = area_b + area_q - inter
    return torch.where(inter > 0.0, inter / union, torch.zeros_like(inter))
