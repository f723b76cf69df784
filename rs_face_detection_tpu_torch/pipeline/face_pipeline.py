"""FacePipeline: the end-to-end face-ID extraction API.

Counterpart of rs_face_detection_tpu/pipeline/face_pipeline.py: decode,
detect, select one face, align it, classify its quality and extract a 512-d
L2-normalized embedding, returned as a ``FaceExtractionResult`` with the same
schema.  A request costs two device passes: detect, then one fused tail of
warp + quality head + embedding head.  The heads' input normalisation and
the quality demotion come from the staged modules (pipeline/quality.py and
pipeline/extraction.py), as in the JAX package.

Models come from a table keyed by the registry's names
(``face_detection_retina``, ``face_quality``, ``face_identification``);
names left out come from a registry on the pipeline's device
(models/registry.py: the caller's, or ``default_registry`` for this config,
which serves ``$RSFD_CHECKPOINT_DIR`` or seeded full-width weights), whose
statistics then count them as the JAX pipeline counts: the detector per
detect call, each head per tail call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..configs import FacePipelineConfig, FaceQualityClass

from ..models.registry import ModelRegistry, registry_on
from ..ops.image import bgr_to_rgb, letterbox_u8_batch, normalize, resize_bilinear, warp_affine
from ..utils import tracing
from ..utils.device import DeviceLike, resolve_device, to_device
from ..utils.image_io import decode_image_bytes
from .alignment import FaceAlignment
from .detection import RetinaFaceDetection
from .extraction import EMBED_MEAN, EMBED_SCALE, l2_normalize
from .quality import QUALITY_MEAN, QUALITY_SCALE, demote_quality
from .selection import FaceSelection


@dataclass
class FaceExtractionResult:
    """Same schema as the JAX package's FaceExtractionResult."""

    face_count: int = 0
    face_quality: Optional[FaceQualityClass] = None
    quality_score: Optional[float] = None
    facial_feature: Optional[np.ndarray] = None  # (512,)
    selected_face_box: Optional[np.ndarray] = None  # (5,)


class FacePipeline:
    def __init__(
        self,
        config: Optional[FacePipelineConfig] = None,
        models: Optional[Mapping[str, nn.Module]] = None,
        device: DeviceLike = "cuda",
        is_enroll: bool = False,
        process_on_no_face: bool = False,
        compat_area_bug: bool = False,
        registry: Optional[ModelRegistry] = None,
    ) -> None:
        self.config = config or FacePipelineConfig()
        self.device = resolve_device(device)
        self.enroll = is_enroll
        self.process_on_no_face = process_on_no_face
        cfg = self.config
        names = (cfg.detection.model_name, cfg.quality.model_name, cfg.identification.model_name)
        models = dict(models or {})
        #: names taken from the registry, whose statistics count their calls
        self.served = tuple(n for n in names if n not in models)
        self.registry = None
        if self.served:
            self.registry = registry_on(
                registry, self.device, detection=cfg.detection, quality=cfg.quality, identification=cfg.identification
            )
            for n in self.served:
                if n != cfg.detection.model_name:  # the detector takes its own from the registry
                    models[n] = self.registry.get(n)

        det_name = cfg.detection.model_name
        self.face_detection = RetinaFaceDetection(
            cfg.detection, device=self.device,
            **({"registry": self.registry} if det_name in self.served else {"model": models[det_name]}),
        )
        self.face_selection = FaceSelection(cfg.selection, compat_area_bug=compat_area_bug)
        self.face_alignment = FaceAlignment(cfg.alignment)
        self.quality_model = models[cfg.quality.model_name].to(self.device).eval()
        self.embedding_model = models[cfg.identification.model_name].to(self.device).eval()

    def _record(self, name: str, n: int, duration_s: float) -> None:
        if name in self.served:
            self.registry.record(name, n, duration_s)

    def _record_heads(self, n: int, duration_s: float) -> None:
        self._record(self.config.quality.model_name, n, duration_s)
        self._record(self.config.identification.model_name, n, duration_s)

    # ---- the fused tail ----------------------------------------------------

    def heads(self, faces_bgr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, h, w, 3) float BGR aligned faces -> (quality probs (N, 4),
        L2-normalized embeddings (N, D)), on the device."""
        q_w, q_h = self.config.quality.image_size
        e_w, e_h = self.config.identification.image_size
        rgb = bgr_to_rgb(faces_bgr)
        q_in = normalize(resize_bilinear(rgb, q_h, q_w), QUALITY_MEAN, QUALITY_SCALE)
        e_in = normalize(resize_bilinear(rgb, e_h, e_w), EMBED_MEAN, EMBED_SCALE)
        with torch.no_grad():
            probs = self.quality_model(q_in.permute(0, 3, 1, 2).contiguous())
            emb = self.embedding_model(e_in.permute(0, 3, 1, 2).contiguous())
        return probs, l2_normalize(emb)

    def _fill(self, result: FaceExtractionResult, probs: np.ndarray, emb: np.ndarray) -> None:
        predict, score = demote_quality(probs, self.config.quality.threshold)
        result.face_quality = FaceQualityClass(predict)
        result.quality_score = score
        result.facial_feature = emb

    # ---- single image --------------------------------------------------------

    def extract(self, im_bytes: bytes) -> FaceExtractionResult:
        """Decode bytes -> detect -> select -> align -> quality -> embed."""
        with tracing.span("pipeline.extract") as top:
            with tracing.span("pipeline.decode"):
                image = decode_image_bytes(im_bytes)
            return self._extract_image(image, top)

    def extract_image(self, image_bgr: np.ndarray) -> FaceExtractionResult:
        """extract() for an already-decoded (H, W, 3) uint8 BGR image."""
        with tracing.span("pipeline.extract") as top:
            return self._extract_image(image_bgr, top)

    def _extract_image(self, image_bgr: np.ndarray, top) -> FaceExtractionResult:
        """The single-image path under its ``pipeline.extract`` span, in the
        batch path's stages: the frame's upload is its letterbox (the
        letterbox itself runs inside the detector, whose host call is the
        ``detect`` span), and the alignment's warp is in the heads."""
        top.set("images", 1)
        result = FaceExtractionResult()
        with tracing.span("pipeline.letterbox"):
            img = to_device(image_bgr, self.device)
        detections, key_points = self.face_detection(img)
        result.face_count = int(detections.shape[0])
        with tracing.span("pipeline.select"):
            box, points = self.face_selection(
                image_bgr.shape[:2], detections, key_points, is_enroll=self.enroll
            )
        if box is None and not self.process_on_no_face:
            top.set("faces", 0)
            return result
        top.set("faces", 1)
        start = time.perf_counter_ns()
        with tracing.span("heads", start, self.device) as sp:
            face = self.face_alignment(img, box, points)
            probs, emb = self.heads(face[None])
            sp.device_end()
            probs, emb = probs[0].cpu().numpy(), emb[0].cpu().numpy()
            tracing.host_sync(self.device, 2)
            end = sp.end(time.perf_counter_ns())
        self._record_heads(1, (end - start) * 1e-9)
        with tracing.span("pipeline.assemble"):
            self._fill(result, probs, emb)
            result.selected_face_box = box
        return result

    # ---- batch ---------------------------------------------------------------

    def extract_batch(self, payloads) -> List[FaceExtractionResult]:
        """extract() over a batch of images (bytes or BGR arrays).

        Two device passes: one batched detect over uint8 letterboxed
        canvases, one fused warp + quality + embed over every selected face.
        Faces are warped from the letterboxed canvas (the matrix rescaled by
        det_scale).
        """
        n = len(payloads)
        if n == 0:
            return []
        with tracing.span("pipeline.extract_batch") as top:
            top.set("images", n)
            return self._extract_batch(payloads, top)

    def _extract_batch(self, payloads, top) -> List[FaceExtractionResult]:
        n = len(payloads)
        width, height = self.config.detection.image_size
        with tracing.span("pipeline.decode"):
            images = [
                decode_image_bytes(p) if isinstance(p, (bytes, bytearray)) else p for p in payloads
            ]
        # OpenCV's uint8 INTER_LINEAR letterbox, bit for bit: the JAX batch
        # path letterboxes on the host with cv2.
        with tracing.span("pipeline.letterbox"):
            canvases, det_scales = letterbox_u8_batch(images, width, height, self.device)
            scales = np.asarray(det_scales, np.float32)

        start = time.perf_counter_ns()
        with tracing.span("detect", start, self.device) as sp:
            out = self.face_detection.detect_batch(canvases, torch.from_numpy(scales))
            sp.device_end()
            counts, all_det, all_kps = (t.cpu().numpy() for t in (out.count, out.det, out.kps))
            tracing.host_sync(self.device, 3)
            end = sp.end(time.perf_counter_ns())
        self._record(self.config.detection.model_name, n, (end - start) * 1e-9)

        with tracing.span("pipeline.select"):
            results = [FaceExtractionResult(face_count=int(c)) for c in counts]
            selected, matrices, staged = [], [], []
            for i in range(n):
                box, points = self.face_selection(
                    images[i].shape[:2],
                    all_det[i, : counts[i]],
                    all_kps[i, : counts[i]],
                    is_enroll=self.enroll,
                )
                if box is None:
                    if self.process_on_no_face:
                        staged.append((i, None, None))
                    continue
                results[i].selected_face_box = box
                m = self.face_alignment.estimate(points) if points is not None else None
                if m is None:  # degenerate landmarks: margin-crop fallback
                    staged.append((i, box, points))
                    continue
                m = m.copy()
                m[:, :2] /= scales[i]  # the canvas is the original times det_scale
                selected.append(i)
                matrices.append(m)
            if selected:
                idx = torch.tensor(selected, device=self.device)
                mats = torch.from_numpy(np.stack(matrices)).to(self.device)
                tracing.host_sync(self.device, 2)
            crops = [self.face_alignment(to_device(images[i], self.device), box, points)[None]
                     for i, box, points in staged]
        owners = selected + [i for i, _, _ in staged]
        top.set("faces", len(owners))
        if not owners:
            return results
        start = time.perf_counter_ns()
        with tracing.span("heads", start, self.device) as sp:
            faces = crops
            if selected:
                out_w, out_h = self.config.alignment.image_size
                faces = [warp_affine(canvases[idx].float(), mats, out_h, out_w)] + crops
            probs, embs = self.heads(torch.cat(faces))
            sp.device_end()
            probs, embs = probs.cpu().numpy(), embs.cpu().numpy()
            tracing.host_sync(self.device, 2)
            end = sp.end(time.perf_counter_ns())
        # One fused call; the statistics count the two calls the JAX
        # pipeline makes (the warped faces, then the crop-fallback faces),
        # the clock split between them by their face counts.
        per_face = (end - start) * 1e-9 / len(owners)
        for k in (len(selected), len(staged)):
            if k:
                self._record_heads(k, k * per_face)
        with tracing.span("pipeline.assemble"):
            for j, i in enumerate(owners):
                self._fill(results[i], probs[j], embs[j])
        return results
