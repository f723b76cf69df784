"""RetinaFace detection: pixels to padded boxes on one device.

Counterpart of rs_face_detection_tpu/pipeline/detection.py, natural layout
only (the ``stem="xla"`` graph), plus the fused stem of the s2d ResNet-50
(``stem="pallas"``).  Letterbox, BGR->RGB, normalize, the network, then the
detection tail, batched over images:

  1. keep scores >= confidence_threshold and take a stable top-k
     (``torch.sort(stable=True)`` then a slice: ``jax.lax.top_k`` keeps
     ties in index order, ``torch.topk`` promises no order);
  2. decode the k winners' boxes and landmarks ("+1" convention), clip boxes;
  3. greedy NMS -- one CUDA kernel launch for the whole batch on the card;
  4. compact the kept rows into max_detections padded rows plus a count;
  5. descale by the letterbox scale.

``select_and_nms`` runs steps 1, 3 and 4 on rows that are already decoded:
the SCRFD detector of the eKYC pipeline (pipeline/ekyc_pipeline.py) decodes
every anchor first, as the JAX package does, and shares the rest.

For the ResNet-50 the batched path (``detect_batch``, ``candidates``) runs
the whole stem -- normalize, s2d conv, BatchNorm, ReLU, max-pool -- as one
fused pass over the uint8 canvases (ops/stem.py; the CUDA kernel K2 on the
card), then the network from stage 1: the JAX detector's
``make_batched_fn(pre_s2d=True, stem="pallas")``.  A quantized model
(ops/quantize.py::quantize_retinaface) runs its own int8 stem instead, as
JAX refuses the Pallas stem for quant models.  The single-image path
keeps the JAX package's semantics: its float letterboxed frame goes through
the module's own stem.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..configs import RPN_ANCHOR_CFG, FaceDetectionConfig

from ..models.registry import ModelRegistry, from_registry
from ..ops.anchors import full_anchor_table
from ..ops.box_decode import bbox_pred, clip_boxes, landmark_pred
from ..ops.image import bgr_to_rgb, letterbox, normalize
from ..ops.nms import nms_mask
from ..ops.stem import fold_stem_params, fused_stem
from ..utils import tracing
from ..utils.device import DeviceLike, resolve_device, to_device


class PaddedDetections(NamedTuple):
    """Fixed-shape detector output: padded rows plus a validity count."""

    det: torch.Tensor  # (..., max_det, 5) [x1, y1, x2, y2, score]
    kps: torch.Tensor  # (..., max_det, 5, 2)
    count: torch.Tensor  # (...) int64 valid rows


class Candidates(NamedTuple):
    """Score-sorted, decoded top-k candidates of a batch, before NMS."""

    boxes: torch.Tensor  # (B, k, 4)
    scores: torch.Tensor  # (B, k); -inf where invalid
    landmarks: torch.Tensor  # (B, k, 5, 2)
    valid: torch.Tensor  # (B, k) bool


def stable_topk(scores: torch.Tensor, cfg: FaceDetectionConfig):
    """Confidence filter, then the top max_candidates of (B, K) scores in a
    stable order: (top scores, -inf where invalid; their indices; valid)."""
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    tracing.host_sync(scores.device)
    masked = torch.where(scores >= cfg.confidence_threshold, scores, neg_inf)
    k = min(cfg.max_candidates, scores.shape[1])
    sorted_scores, order = torch.sort(masked, dim=1, descending=True, stable=True)
    top_scores, top_idx = sorted_scores[:, :k], order[:, :k]
    return top_scores, top_idx, top_scores > neg_inf


def select_candidates(
    net_out: Dict[int, Dict[str, torch.Tensor]],
    anchors: torch.Tensor,
    level_info,
    cfg: FaceDetectionConfig,
) -> Candidates:
    """Confidence filter, stable top-k, then decode only the k winners."""
    width, height = cfg.image_size
    b = net_out[level_info[0][0]]["score"].shape[0]
    scores_l, bbox_l, lm_l = [], [], []
    for stride, fh, fw, a in level_info:
        out = net_out[stride]
        k = fh * fw * a
        scores_l.append(out["score"].reshape(b, k))
        bbox_l.append(out["bbox"].reshape(b, k, 4))
        lm_l.append(out["landmark"].reshape(b, k, 10))
    scores = torch.cat(scores_l, dim=1)
    bbox_raw = torch.cat(bbox_l, dim=1)
    lm_raw = torch.cat(lm_l, dim=1)
    top_scores, top_idx, valid = stable_topk(scores, cfg)
    k = top_idx.shape[1]

    bbox_stds = torch.tensor(cfg.bbox_stds, dtype=torch.float32, device=scores.device)
    tracing.host_sync(scores.device)
    anchor_sel = anchors[top_idx]  # (B, k, 4)
    deltas = torch.gather(bbox_raw, 1, top_idx[..., None].expand(-1, -1, 4)) * bbox_stds
    boxes = clip_boxes(bbox_pred(anchor_sel, deltas), (height, width))
    lm_sel = torch.gather(lm_raw, 1, top_idx[..., None].expand(-1, -1, 10))
    landmarks = landmark_pred(anchor_sel, lm_sel.reshape(b, k, 5, 2) * cfg.landmark_std)
    return Candidates(boxes.contiguous(), top_scores, landmarks, valid.contiguous())


def nms_and_compact(cand: Candidates, cfg: FaceDetectionConfig) -> PaddedDetections:
    """NMS over the candidates, then scatter the kept rows (score order) into
    the first `count` of max_detections rows per image."""
    keep = nms_mask(cand.boxes, cand.valid, cfg.iou_threshold)
    b = keep.shape[0]
    max_det = cfg.max_detections
    rank = torch.cumsum(keep.long(), dim=1) - 1
    # Rows not kept, or past max_det, land in a spare row that is dropped.
    target = torch.where(keep & (rank < max_det), rank, torch.full_like(rank, max_det))
    rows = torch.cat([cand.boxes, cand.scores[..., None]], dim=-1)
    det = torch.zeros((b, max_det + 1, 5), dtype=rows.dtype, device=rows.device)
    det.scatter_(1, target[..., None].expand(-1, -1, 5), rows)
    kps = torch.zeros((b, max_det + 1, 10), dtype=rows.dtype, device=rows.device)
    kps.scatter_(1, target[..., None].expand(-1, -1, 10), cand.landmarks.reshape(b, -1, 10))
    count = torch.clamp(keep.sum(dim=1), max=max_det)
    return PaddedDetections(det[:, :max_det], kps[:, :max_det].reshape(b, max_det, 5, 2), count)


def topk_candidates(
    scores: torch.Tensor, boxes: torch.Tensor, lms: torch.Tensor, cfg: FaceDetectionConfig
) -> Candidates:
    """The stable top-k of rows that are already decoded: (B, K) scores,
    (B, K, 4) boxes, (B, K, 5, 2) landmarks."""
    top_scores, top_idx, valid = stable_topk(scores, cfg)
    k = top_idx.shape[1]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_lms = torch.gather(lms.reshape(lms.shape[0], -1, 10), 1, top_idx[..., None].expand(-1, -1, 10))
    return Candidates(
        top_boxes.contiguous(), top_scores, top_lms.reshape(-1, k, 5, 2), valid.contiguous()
    )


def select_and_nms(
    scores: torch.Tensor, boxes: torch.Tensor, lms: torch.Tensor, cfg: FaceDetectionConfig
) -> PaddedDetections:
    """Decoded rows through topk_candidates and nms_and_compact: the JAX
    package's ``select_and_nms``, which the SCRFD detector shares."""
    return nms_and_compact(topk_candidates(scores, boxes, lms, cfg), cfg)


def descale(padded: PaddedDetections, inv_scale: torch.Tensor) -> PaddedDetections:
    """Multiply boxes and landmarks by (B,) inverse letterbox scales."""
    inv = inv_scale.reshape(-1, 1, 1)
    det = torch.cat([padded.det[..., :4] * inv, padded.det[..., 4:]], dim=-1)
    return PaddedDetections(det, padded.kps * inv[..., None], padded.count)


def fold_model_stem(model: nn.Module, cfg: FaceDetectionConfig):
    """The fused stem's folded constants (ops/stem.py::fold_stem_params) from
    an s2d model's stem conv and BatchNorm and the config's pixel
    normalization."""
    body = model.body
    return fold_stem_params(
        body.conv1.weight.detach().permute(2, 3, 1, 0),  # OIHW -> HWIO
        body.bn1.weight.detach(),
        body.bn1.bias.detach(),
        body.bn1.running_mean,
        body.bn1.running_var,
        cfg.pixel_means,
        cfg.pixel_stds,
        cfg.pixel_scale,
        body.bn1.eps,
    )


class RetinaFaceDetection:
    """Detector with the host-facing contract
    ``__call__(image_bgr_u8) -> (det (N, 5), kps (N, 5, 2))`` in numpy, in
    original-image pixels."""

    def __init__(
        self,
        cfg: Optional[FaceDetectionConfig] = None,
        model: Optional[nn.Module] = None,
        device: DeviceLike = "cuda",
        registry: Optional[ModelRegistry] = None,
        stem: str = "auto",
    ) -> None:
        """``model``: a RetinaFace; else the registry's ``cfg.model_name``
        (``registry``, or the default one: models/registry.py::registry_on),
        whose statistics then count this detector's calls.  ``stem``: the
        batched path's stem, ``"auto"`` (the fused stem for a float s2d
        model, else the module's own) or ``"fused"`` (the fused stem, or
        ValueError: an int8-activation model never takes it, as JAX refuses
        ``stem="pallas"`` for quant models)."""
        if stem not in ("auto", "fused"):
            raise ValueError(f"stem must be 'auto' or 'fused', got {stem!r}")
        self.cfg = cfg or FaceDetectionConfig()
        self.device = resolve_device(device)
        model, self._registry = from_registry(model, registry, self.cfg.model_name, self.device, detection=self.cfg)
        self.model = model.to(self.device).eval()
        anchors, level_info = full_anchor_table(
            self.cfg.image_size, RPN_ANCHOR_CFG, self.cfg.feat_strides, self.cfg.dense_anchor
        )
        self.anchors = torch.from_numpy(anchors).to(self.device)
        self.level_info = tuple(level_info)
        if level_info[0][3] != self.model.num_anchors:
            raise ValueError(
                f"anchor table has {level_info[0][3]} anchors/cell but the model "
                f"head predicts {self.model.num_anchors}"
            )
        # The float s2d models' batched path runs the fused stem (K2 on the
        # card); its constants are folded once, from the weights the detector
        # holds.  It takes even frame sizes only, and raises on odd ones as
        # JAX's stem="pallas" does; the single-image path takes any size.  A
        # quantized model runs its own int8 stem: K2 holds float weights.
        fused_ok = self.model.uses_s2d_stem() and not getattr(self.model, "quant", False)
        if stem == "fused" and not fused_ok:
            raise ValueError("stem='fused' needs a float model with the s2d stem (the ResNet-50), not an int8 one")
        self.stem_consts = fold_model_stem(self.model, self.cfg) if fused_ok else None

    def forward(self, images: torch.Tensor) -> Dict[int, Dict[str, torch.Tensor]]:
        """The network on (B, H, W, 3) float BGR pixels in [0, 255]."""
        cfg = self.cfg
        x = bgr_to_rgb(images)
        x = normalize(
            x,
            tuple(m * cfg.pixel_scale for m in cfg.pixel_means),
            tuple(1.0 / s for s in cfg.pixel_stds),
        ) / cfg.pixel_scale
        return self.model(x.permute(0, 3, 1, 2).contiguous())

    def candidates(self, imgs_u8: torch.Tensor, stem_consts=None) -> Candidates:
        """Top-k decoded candidates of (B, H, W, 3) letterboxed uint8 frames
        (H and W even for an s2d model).  ``stem_consts`` replaces the
        detector's folded stem constants (runtime/aot.py folds them from the
        weights it is called with)."""
        with torch.no_grad():
            if self.stem_consts is not None:
                pooled = fused_stem(imgs_u8.contiguous(), *(stem_consts or self.stem_consts))
                net_out = self.model.forward_pooled(pooled)
            else:
                net_out = self.forward(imgs_u8.float())
            return select_candidates(net_out, self.anchors, self.level_info, self.cfg)

    def detect_batch(self, imgs_u8, det_scales) -> PaddedDetections:
        """Batched detect on letterboxed (B, H, W, 3) uint8 frames with (B,)
        letterbox scales: the contract of the JAX detector's
        ``make_batched_fn(stem="xla")``, and for the ResNet-50 of
        ``make_batched_fn(pre_s2d=True, stem="pallas")`` on the same frames
        (the fused stem reads the canvas as it is, so no s2d copy is made).
        Results stay on the device."""
        imgs = to_device(imgs_u8, self.device)
        scales = to_device(det_scales, self.device).float()
        padded = nms_and_compact(self.candidates(imgs), self.cfg)
        return descale(padded, 1.0 / scales)

    def detect_padded(self, image_bgr_u8) -> PaddedDetections:
        """One (H, W, 3) uint8 image of any size: letterbox on the device,
        detect, descale; unbatched padded result on the device."""
        width, height = self.cfg.image_size
        img = to_device(image_bgr_u8, self.device)
        padded_img, det_scale = letterbox(img, width, height)
        # The float letterbox is not rounded to uint8 here (the JAX
        # single-image path does not round it either), so the fused stem,
        # which reads uint8, does not apply: the module runs its own stem.
        with torch.no_grad():
            net_out = self.forward(padded_img[None])
            cand = select_candidates(net_out, self.anchors, self.level_info, self.cfg)
            padded = nms_and_compact(cand, self.cfg)
        inv = torch.tensor([1.0 / det_scale], dtype=torch.float32, device=self.device)
        tracing.host_sync(self.device)
        out = descale(padded, inv)
        return PaddedDetections(out.det[0], out.kps[0], out.count[0])

    def __call__(self, image_bgr_u8) -> Tuple[np.ndarray, np.ndarray]:
        """Under a ``detect`` span (utils/tracing.py) whose clock reads the
        registry's statistics share, with CUDA events from the first launch
        to just before the host copies."""
        start = time.perf_counter_ns()
        with tracing.span("detect", start, self.device) as sp:
            out = self.detect_padded(image_bgr_u8)
            sp.device_end()
            n = int(out.count)
            det, kps = out.det[:n].cpu().numpy(), out.kps[:n].cpu().numpy()
            tracing.host_sync(self.device, 3)
            end = sp.end(time.perf_counter_ns())
        self.record_traffic(1, (end - start) * 1e-9)
        return det, kps

    def record_traffic(self, n_images: int, duration_s: float) -> None:
        """Count traffic served outside ``__call__`` (``detect_batch`` from a
        pipeline or a server) in the registry's statistics, if it has one."""
        if self._registry is not None:
            self._registry.record(self.cfg.model_name, n_images, duration_s)
