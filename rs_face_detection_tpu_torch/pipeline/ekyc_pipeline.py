"""eKYC pipeline: ID-document face against selfie, on one device.

Counterpart of rs_face_detection_tpu/pipeline/ekyc_pipeline.py
(``SCRFDDetection``, ``EKYCResult``, ``EKYCPipeline``) with the same
results.  ``verify(card_bytes, selfie_bytes)`` decodes both images, detects
each with SCRFD (the NMS kernel K1 on the card), takes the face of largest
box area, aligns both faces, embeds them with ``face_id``, and runs four
heads on the selfie: the ``face_attribute`` mask classifier at 128, the
``face_quality_vp`` cover classifier at 112, and two CLIP ViT-L/14
anti-spoofing towers at 224 -- one on the aligned face, one on the whole
selfie resized with OpenCV's uint8 INTER_LINEAR arithmetic on the device
(ops/image.py::resize_u8_linear).  Every attention layer of the towers runs
K4 on the card.  A verify makes two host syncs: the detections (boxes and
landmarks, for the Umeyama solve) and the results.

Models come from a table keyed by the registry's names (``scrfd``,
``face_id``, ``face_attribute``, ``face_quality_vp``,
``face_anti_spoofing_crop_l14``, ``face_anti_spoofing_fi_l14``); names left
out come from a registry on the pipeline's device (models/registry.py: the
caller's, or ``default_registry``), which serves ``$RSFD_CHECKPOINT_DIR`` or seeded
full-width models (models/registry.py::EKYC_FAMILIES): SCRFD at width 32 and neck 32,
IResNet-50 with 512 outputs, ResNet-18 classifiers with 2 outputs, and
``clip_l14`` with 2 classes cast to bf16 (models/vit.py::cast_for_serving).
As in the JAX package, the registry's statistics count the detector only:
one call of batch 1 per image.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..configs import (
    EkycFaceAttributeConfig,
    EkycFaceDetectionConfig,
    EkycFaceIDConfig,
    EkycFaceQualityConfig,
    EkycFASCropConfig,
    EkycFASFullConfig,
    FaceAlignmentConfig,
    FaceDetectionConfig,
)
from ..models.registry import ModelRegistry, from_registry, registry_on
from ..ops.anchors import scrfd_anchor_centers
from ..ops.box_decode import clip_boxes, distance2bbox, distance2kps
from ..ops.image import bgr_to_rgb, letterbox, normalize, resize_bilinear, resize_u8_linear
from ..utils.device import DeviceLike, fetch, resolve_device, timed_fetch, to_device
from ..utils.image_io import decode_image_bytes
from .alignment import FaceAlignment
from .detection import PaddedDetections, descale, select_and_nms

class SCRFDDetection:
    """SCRFD detector with RetinaFaceDetection's three entry points:
    ``__call__`` and ``detect_padded`` on one image of any size, letterboxed
    in float on the device; ``detect_batch`` on letterboxed uint8 frames.
    The select and NMS settings are the JAX detector's, with its defaults:
    scores >= 0.5, the top 256 candidates, NMS at IoU 0.45, 100 rows."""

    def __init__(
        self,
        cfg: Optional[EkycFaceDetectionConfig] = None,
        model: Optional[nn.Module] = None,
        device: DeviceLike = "cuda",
        image_size: Tuple[int, int] = (640, 640),
        registry: Optional[ModelRegistry] = None,
        confidence_threshold: float = 0.5,
        iou_threshold: float = 0.45,
        max_candidates: int = 256,
        max_detections: int = 100,
    ) -> None:
        """``model``: a SCRFD network (models/scrfd.py, or the mmdet layout
        of models/scrfd_import.py); else the registry's ``cfg.model_name``
        (models/registry.py::from_registry), whose statistics then count the
        calls.  The four thresholds go to ``sel_cfg``, the select/NMS stage
        (an evaluation runs at ``confidence_threshold=0.02``)."""
        self.cfg = cfg or EkycFaceDetectionConfig()
        self.device = resolve_device(device)
        model, self._registry = from_registry(model, registry, self.cfg.model_name, self.device)
        self.model = model.to(self.device).eval()
        self.image_size = tuple(image_size)
        centers, levels = scrfd_anchor_centers(self.image_size, num_anchors=self.model.num_anchors)
        self.centers = torch.from_numpy(centers).to(self.device)
        self.levels = tuple(levels)
        # The RetinaFace select/NMS stage, through a detection-config shim.
        self.sel_cfg = FaceDetectionConfig(
            image_size=self.image_size,
            confidence_threshold=confidence_threshold,
            iou_threshold=iou_threshold,
            max_candidates=max_candidates,
            max_detections=max_detections,
        )

    def forward(self, images: torch.Tensor) -> Dict[int, Dict[str, torch.Tensor]]:
        """The network on (B, H, W, 3) float BGR pixels in [0, 255]."""
        mean, scale = self.cfg.mean, self.cfg.scale
        x = normalize(bgr_to_rgb(images), (mean,) * 3, (scale,) * 3)
        return self.model(x.permute(0, 3, 1, 2).contiguous())

    def decode(self, net_out) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-stride maps -> (B, K) scores, (B, K, 4) clipped boxes and
        (B, K, 5, 2) landmarks (not clipped): distances times the stride,
        from the anchor centers."""
        width, height = self.image_size
        b = net_out[self.levels[0][0]]["score"].shape[0]
        scores_l, boxes_l, kps_l = [], [], []
        offset = 0
        for stride, fh, fw, a in self.levels:
            maps = net_out[stride]
            k = fh * fw * a
            centers = self.centers[offset : offset + k]
            scores_l.append(maps["score"].reshape(b, k))
            dist = maps["bbox"].reshape(b, k, 4) * float(stride)
            boxes_l.append(clip_boxes(distance2bbox(centers, dist), (height, width)))
            kd = maps["kps"].reshape(b, k, 5, 2) * float(stride)
            kps_l.append(distance2kps(centers, kd))
            offset += k
        return torch.cat(scores_l, 1), torch.cat(boxes_l, 1), torch.cat(kps_l, 1)

    def detect_batch(self, imgs_u8, det_scales) -> PaddedDetections:
        """Batched detect on letterboxed (B, H, W, 3) uint8 frames with (B,)
        letterbox scales: the contract of the JAX detector's
        ``make_batched_fn(stem="xla")``.  Results stay on the device."""
        imgs = to_device(imgs_u8, self.device)
        scales = to_device(det_scales, self.device).float()
        with torch.no_grad():
            padded = select_and_nms(*self.decode(self.forward(imgs.float())), self.sel_cfg)
        return descale(padded, 1.0 / scales)

    def detect_padded(self, image_bgr_u8) -> PaddedDetections:
        """One (H, W, 3) uint8 image of any size: letterbox on the device in
        float (not rounded, as the JAX single-image path), detect, descale;
        unbatched padded result on the device."""
        width, height = self.image_size
        img = to_device(image_bgr_u8, self.device)
        padded_img, det_scale = letterbox(img, width, height)
        with torch.no_grad():
            padded = select_and_nms(*self.decode(self.forward(padded_img[None])), self.sel_cfg)
        out = descale(padded, 1.0 / det_scale)
        return PaddedDetections(out.det[0], out.kps[0], out.count[0])

    def __call__(self, image_bgr_u8) -> Tuple[np.ndarray, np.ndarray]:
        (det, kps, count), seconds = timed_fetch("detect", self.device, lambda: self.detect_padded(image_bgr_u8))
        self.record_traffic(1, seconds)
        return det[:count], kps[:count]

    def record_traffic(self, n_images: int, duration_s: float) -> None:
        """Count traffic served outside ``__call__`` in the registry's
        statistics, if it has one."""
        if self._registry is not None:
            self._registry.record(self.cfg.model_name, n_images, duration_s)


@dataclass
class EKYCResult:
    """Same schema as the JAX package's EKYCResult."""

    similarity: float = 0.0
    same_person: bool = False
    same_ekyc: bool = False
    card_face_found: bool = False
    selfie_face_found: bool = False
    selfie_mask: Optional[bool] = None
    selfie_quality: Optional[float] = None
    selfie_covered: Optional[bool] = None
    selfie_live_crop: Optional[bool] = None
    selfie_live_full: Optional[bool] = None
    card_face_box: Optional[np.ndarray] = None
    selfie_face_box: Optional[np.ndarray] = None


def largest_face(padded: PaddedDetections) -> torch.Tensor:
    """(16,) row on the device: the box (5,), landmarks (10,) of the valid
    detection of largest box area (the first on a tie, as np.argmax) and
    the count.  Row 0 when there is none (the count says so)."""
    det, kps, count = padded
    areas = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    rows = torch.arange(det.shape[0], device=det.device)
    areas = torch.where(rows < count, areas, torch.full_like(areas, float("-inf")))
    i = torch.argmax(areas)
    return torch.cat([det[i], kps[i].reshape(10), count.reshape(1).to(det.dtype)])


class EKYCPipeline:
    """verify(card_bytes, selfie_bytes) -> EKYCResult."""

    def __init__(
        self,
        models: Optional[Mapping[str, nn.Module]] = None,
        device: DeviceLike = "cuda",
        detector_image_size: Tuple[int, int] = (640, 640),
        registry: Optional[ModelRegistry] = None,
    ) -> None:
        self.device = resolve_device(device)
        self.id_cfg = EkycFaceIDConfig()
        self.attr_cfg = EkycFaceAttributeConfig()
        self.quality_cfg = EkycFaceQualityConfig()
        self.fas_crop_cfg = EkycFASCropConfig()
        self.fas_full_cfg = EkycFASFullConfig()
        det_cfg = EkycFaceDetectionConfig()
        names = (
            det_cfg.model_name, self.id_cfg.model_name, self.attr_cfg.model_name,
            self.quality_cfg.model_name, self.fas_crop_cfg.model_name, self.fas_full_cfg.model_name,
        )
        models = dict(models or {})
        served = [n for n in names if n not in models]
        if served:
            registry = registry_on(registry, self.device)
            models.update((n, registry.get(n)) for n in served if n != det_cfg.model_name)
        self.detection = SCRFDDetection(
            det_cfg, device=self.device, image_size=detector_image_size,
            **({"registry": registry} if det_cfg.model_name in served else {"model": models[det_cfg.model_name]}),
        )
        self.alignment = FaceAlignment(FaceAlignmentConfig())
        self.face_id = models[self.id_cfg.model_name].to(self.device).eval()
        # name -> (model, input size, per-channel RGB mean, scale)
        fas_norm = [
            (tuple(m * 255.0 for m in c.mean), tuple(1.0 / (s * 255.0) for s in c.std))
            for c in (self.fas_crop_cfg, self.fas_full_cfg)
        ]
        self.heads = {
            "attribute": (
                models[self.attr_cfg.model_name], self.attr_cfg.imsize,
                (self.attr_cfg.mean,) * 3, (self.attr_cfg.scale,) * 3,
            ),
            "quality": (
                models[self.quality_cfg.model_name], self.quality_cfg.imsize,
                self.quality_cfg.mean, self.quality_cfg.scale,
            ),
            "fas_crop": (models[self.fas_crop_cfg.model_name], self.fas_crop_cfg.imsize, *fas_norm[0]),
            "fas_full": (models[self.fas_full_cfg.model_name], self.fas_full_cfg.imsize, *fas_norm[1]),
        }
        for model, *_ in self.heads.values():
            model.to(self.device).eval()

    def embed(self, faces_bgr: torch.Tensor) -> torch.Tensor:
        """(N, 112, 112, 3) float BGR aligned faces -> (N, 512) unit rows."""
        mean, scale = self.id_cfg.mean, self.id_cfg.scale
        x = normalize(bgr_to_rgb(faces_bgr), (mean,) * 3, (scale,) * 3)
        with torch.no_grad():
            emb = self.face_id(x.permute(0, 3, 1, 2).contiguous())
        return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)

    def run_head(self, which: str, imgs_bgr: torch.Tensor) -> torch.Tensor:
        """(N, h, w, 3) BGR images -> the head's (N, 2) probabilities: a
        half-pixel bilinear resize to its input size, BGR->RGB, normalize."""
        model, size, mean, scale = self.heads[which]
        x = normalize(bgr_to_rgb(resize_bilinear(imgs_bgr.float(), size, size)), mean, scale)
        with torch.no_grad():
            return model(x.permute(0, 3, 1, 2).contiguous()).float()

    # -- public API --------------------------------------------------------

    def verify(self, card_bytes: bytes, selfie_bytes: bytes) -> EKYCResult:
        return self.verify_images(decode_image_bytes(card_bytes), decode_image_bytes(selfie_bytes))

    def verify_images(self, card_bgr: np.ndarray, selfie_bgr: np.ndarray) -> EKYCResult:
        result = EKYCResult()
        images = [to_device(card_bgr, self.device), to_device(selfie_bgr, self.device)]
        start = time.perf_counter()
        (best,) = fetch(torch.stack([largest_face(self.detection.detect_padded(img)) for img in images]))
        # Two detect calls of one image each; one clock spans both.
        half = (time.perf_counter() - start) / 2
        self.detection.record_traffic(1, half)
        self.detection.record_traffic(1, half)
        faces: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [
            (row[:5].copy(), row[5:15].reshape(5, 2).copy()) if row[15] > 0 else None for row in best
        ]
        result.card_face_found = faces[0] is not None
        result.selfie_face_found = faces[1] is not None
        result.card_face_box = faces[0][0] if faces[0] is not None else None
        result.selfie_face_box = faces[1][0] if faces[1] is not None else None
        if faces[0] is None or faces[1] is None:
            return result

        aligned = torch.stack(
            [self.alignment(img, box, kps) for img, (box, kps) in zip(images, faces)]
        )
        emb = self.embed(aligned)
        full = self.fas_full_cfg.imsize
        selfie_full = resize_u8_linear(images[1], full, full)
        selfie_face = aligned[1:]
        sim, attr, quality, fas_crop, fas_full = fetch(
            (emb[0] @ emb[1]).float(),
            self.run_head("attribute", selfie_face)[0],
            self.run_head("quality", selfie_face)[0],
            self.run_head("fas_crop", selfie_face)[0],
            self.run_head("fas_full", selfie_full[None])[0],
        )

        result.similarity = float(sim)
        result.same_person = result.similarity >= self.id_cfg.threshold_same_person
        result.same_ekyc = result.similarity >= self.id_cfg.threshold_same_ekyc
        result.selfie_mask = bool(attr[1] > self.attr_cfg.threshold_face_mask)
        # Column 0 = P(not covered), column 1 = P(covered): selfie_quality
        # reports P(uncovered), threshold_cover gates the boolean.
        result.selfie_quality = float(quality[0])
        result.selfie_covered = bool(quality[1] > self.quality_cfg.threshold_cover)
        result.selfie_live_crop = bool(fas_crop[1] > self.fas_crop_cfg.threshold)
        result.selfie_live_full = bool(fas_full[1] > self.fas_full_cfg.threshold)
        return result
