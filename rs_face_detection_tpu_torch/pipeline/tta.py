"""Test-time augmentation: multi-scale + horizontal-flip detection with
box voting, the published WIDER FACE evaluation protocol.

Counterpart of rs_face_detection_tpu/pipeline/tta.py.  Every scale is a
detector of its own size sharing one module (fully convolutional); each view
is letterboxed on the detector's device with OpenCV's uint8 arithmetic
(ops/image.py::letterbox_u8, bit for bit the JAX package's host letterbox),
detected at its own size (one NMS launch per view: K1 on the card), mapped
back to the image's pixels and, for the mirrored view, un-flipped with the
left/right landmark identities swapped.  The views' post-NMS rows (tens of
them) merge on the host in numpy: cross-view greedy NMS or score-weighted
box voting.

One departure from the JAX package, on purpose: the base scale that every
view's zoom is measured against is the base view's own letterbox scale
(``letterbox_geometry``'s truncated ``det_scale``), not the analytic
``min(base_w / width, base_h / height)``.  So the base view's zoom is
exactly 1, and the shrunk-view filter never drops the base view's small
faces; the JAX code drops them whenever the letterbox size truncates
(tests/test_torch_tta.py shows a frame where it does).

Offline evaluation path: the serving hot loop stays single-scale.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.image import letterbox_geometry, letterbox_u8
from ..ops.nms import nms_numpy
from ..serving.detection_server import detector_image_size
from ..utils.device import to_device

#: 5-point landmark left/right identity swap under horizontal flip:
#: [left_eye, right_eye, nose, left_mouth, right_mouth] (image.rs:41-67).
_FLIP_LANDMARK_ORDER = (1, 0, 2, 4, 3)


def flip_detections(
    boxes: np.ndarray, kps: np.ndarray, width: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Map detections on the mirrored image back to original coordinates.

    Boxes use the reference's inclusive "+1" convention, so column i maps
    to (width - 1 - i): x1' = W-1-x2, x2' = W-1-x1.  Landmark x reflects
    the same way, and the left/right-eye and mouth-corner identities swap.
    """
    boxes = np.asarray(boxes, np.float32).copy()
    kps = np.asarray(kps, np.float32).copy()
    if boxes.size:
        x1 = boxes[:, 0].copy()
        boxes[:, 0] = width - 1.0 - boxes[:, 2]
        boxes[:, 2] = width - 1.0 - x1
    if kps.size:
        kps[..., 0] = width - 1.0 - kps[..., 0]
        kps = kps[:, _FLIP_LANDMARK_ORDER, :]
    return boxes, kps


def bbox_vote(
    dets: np.ndarray,
    kps: Optional[np.ndarray] = None,
    iou_threshold: float = 0.4,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Score-weighted box voting over (N, 5) rows (RetinaFace test protocol).

    Greedy over descending scores: each round takes the top-scoring box,
    collects every box with IoU >= iou_threshold ("+1" areas, matching
    ops.nms semantics), replaces the group by the score-weighted average of
    its coordinates with the group's max score, and removes it.  Landmarks
    (if given) keep the top-scoring member's points — averaging landmarks
    across flipped/rescaled duplicates would smear asymmetric faces.
    """
    dets = np.asarray(dets, np.float32)
    if dets.shape[0] == 0:
        return dets.reshape(0, 5), (
            None if kps is None else np.zeros((0, 5, 2), np.float32)
        )
    if kps is not None:
        kps = np.asarray(kps, np.float32)
    order = np.argsort(-dets[:, 4], kind="stable")
    dets = dets[order]
    kps = None if kps is None else kps[order]

    out_rows: List[np.ndarray] = []
    out_kps: List[np.ndarray] = []
    while dets.shape[0]:
        box = dets[0]
        xx1 = np.maximum(box[0], dets[:, 0])
        yy1 = np.maximum(box[1], dets[:, 1])
        xx2 = np.minimum(box[2], dets[:, 2])
        yy2 = np.minimum(box[3], dets[:, 3])
        w = np.maximum(0.0, xx2 - xx1 + 1.0)
        h = np.maximum(0.0, yy2 - yy1 + 1.0)
        inter = w * h
        area = lambda b: (b[..., 2] - b[..., 0] + 1.0) * (
            b[..., 3] - b[..., 1] + 1.0
        )
        with np.errstate(invalid="ignore", divide="ignore"):
            iou = inter / (area(box) + area(dets) - inter)
        group = iou >= iou_threshold
        # A degenerate top box (zero "+1" area or NaN coords) has NaN
        # self-IoU; always consume it so the greedy loop stays total.
        group[0] = True
        members = dets[group]
        weights = members[:, 4:5]
        merged = np.empty((5,), np.float32)
        merged[:4] = (members[:, :4] * weights).sum(0) / weights.sum()
        merged[4] = members[:, 4].max()
        out_rows.append(merged)
        if kps is not None:
            out_kps.append(kps[np.argmax(group)])  # top-scoring member
        dets = dets[~group]
        kps = None if kps is None else kps[~group]
    merged_dets = np.stack(out_rows)
    merged_kps = None if kps is None else np.stack(out_kps)
    return merged_dets, merged_kps


class TTADetection:
    """Multi-scale + flip wrapper over per-size detectors.

    detectors: one per scale, sharing one module (build them with the same
    model at different image sizes, e.g. MultiScaleDetection's
    ``detectors.values()``, or pass a single detector for flip-only TTA),
    each with a ``device`` and the ``__call__`` contract of
    RetinaFaceDetection; default: ``[RetinaFaceDetection()]`` on the card.
    The FIRST detector is the base scale: scale filtering and relative-zoom
    bookkeeping are computed against its size.

    merge: "nms" (cross-view greedy NMS, default) or "vote" (bbox_vote).
    Measured on the real-pixel collage protocol (tests/test_real_collage,
    20 scenes, 2 scales + flip): nms beats vote on every split
    (easy/medium/hard 0.724/0.774/0.804 vs 0.700/0.752/0.753) — with only
    2-4 views per face, vote's score-weighted coordinate averaging lets a
    low-score misaligned member drag the merged box off target, while NMS
    keeps the top-scoring box intact.  Voting is the RetinaFace paper's
    protocol for ~10-view pyramids where averaging has votes to work with;
    it stays available for that regime.

    scale_filter (default True): the published multi-scale testing rule
    (S3FD/RetinaFace eval code): an enlarged view exists to resolve SMALL
    faces, so only its small detections are kept; a shrunk view only its
    large ones.  Without it, every view contributes boxes for every face,
    and the off-distribution duplicates from non-native scales outrank
    native-scale true positives (measured: unfiltered 64+96 TTA lost 0.11
    easy AP vs single-scale; filtered recovers to -0.03 while keeping the
    +0.13 hard gain).  Cut semantics: a box whose max side, rescaled to
    the BASE detector frame, is >= small_faces_cut * base_size is dropped
    from zoomed-in views; <= large_faces_cut * base_size is dropped from
    zoomed-out views.
    """

    def __init__(
        self,
        detectors: Optional[Sequence] = None,
        flip: bool = True,
        merge: str = "nms",
        merge_iou: float = 0.4,
        scale_filter: bool = True,
        small_faces_cut: float = 0.375,
        large_faces_cut: float = 0.0625,
    ) -> None:
        if merge not in ("vote", "nms"):
            raise ValueError(f"merge={merge!r} not in ('vote', 'nms')")
        if detectors is None:
            from .detection import RetinaFaceDetection

            detectors = [RetinaFaceDetection()]
        if not detectors:
            raise ValueError("need at least one detector")
        self.detectors = list(detectors)
        self.flip = flip
        self.merge = merge
        self.merge_iou = merge_iou
        self.scale_filter = scale_filter
        self.small_faces_cut = float(small_faces_cut)
        self.large_faces_cut = float(large_faces_cut)

    def __call__(
        self, image_bgr: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        dets, kps = self.views(image_bgr)
        if self.merge == "vote":
            return bbox_vote(dets, kps, self.merge_iou)
        order = np.argsort(-dets[:, 4], kind="stable")
        dets, kps = dets[order], kps[order]
        keep = nms_numpy(dets, self.merge_iou)
        return dets[keep], kps[keep]

    def views(self, image_bgr) -> Tuple[np.ndarray, np.ndarray]:
        """Every view's detections in the image's pixels, after the scale
        filter, concatenated in view order (each detector, then its mirrored
        view): the rows ``__call__`` merges."""
        # Each view is letterboxed to its detector's size before the call, so
        # the detector's own letterbox keeps it as it is (scale 1).
        device = self.detectors[0].device
        image = to_device(image_bgr, device)
        height, width = image.shape[:2]
        flipped = torch.flip(image, dims=[1]) if self.flip else None
        base_w, base_h = detector_image_size(self.detectors[0])
        # The base view's own (truncated) letterbox scale: its zoom is
        # exactly 1, so the scale filter leaves it whole.  View zoom is a
        # ratio of scales (not of canvas widths), so non-square detector
        # sets and aspect-mismatched images classify correctly.
        base_scale = letterbox_geometry(height, width, base_w, base_h)[2]
        all_d: List[np.ndarray] = []
        all_k: List[np.ndarray] = []
        for det in self.detectors:
            dw, dh = detector_image_size(det)
            for src, is_flip in ((image, False), (flipped, True)):
                if src is None:
                    continue
                padded, scale = letterbox_u8(src.to(det.device), dw, dh)
                zoom = scale / base_scale
                d, k = det(padded)
                d = np.asarray(d, np.float32).reshape(-1, 5).copy()
                k = np.asarray(k, np.float32).reshape(-1, 5, 2) / scale
                d[:, :4] /= scale
                if is_flip:
                    d, k = flip_detections(d, k, width)
                if self.scale_filter and d.shape[0] and zoom != 1.0:
                    # box max-side as the BASE view letterboxes it
                    side = np.maximum(
                        d[:, 2] - d[:, 0], d[:, 3] - d[:, 1]
                    ) * base_scale
                    if zoom > 1.0:  # enlarged: small faces only
                        keep = side < self.small_faces_cut * base_w
                    else:  # shrunk: large faces only
                        keep = side > self.large_faces_cut * base_w
                    d, k = d[keep], k[keep]
                all_d.append(d)
                all_k.append(k)
        return np.concatenate(all_d, axis=0), np.concatenate(all_k, axis=0)
