"""Configuration dataclasses of the port.

The port's own copy of rs_face_detection_tpu/configs.py: the same frozen
dataclasses with the same fields and defaults, the same ``RPN_ANCHOR_CFG``
and the same ``FaceQualityClass`` members, so that the port imports nothing
of the JAX package.  tests/test_torch_configs.py holds every copy equal to
its original.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Dict, Tuple


class FaceQualityClass(enum.IntEnum):
    """Face-quality classes (reference: face_pipeline/pipeline.rs:25-30)."""

    BAD = 0
    GOOD = 1
    WEARING_MASK = 2
    WEARING_SUNGLASSES = 3


@dataclass(frozen=True)
class AnchorConfig:
    """Per-FPN-stride anchor enumeration config.

    Reference: src/processing/generate_anchors.rs:13-18 (AnchorConfig) with the
    values hardcoded in src/pipeline/module/face_detection.rs:56-80.
    """

    base_size: int = 16
    ratios: Tuple[float, ...] = (1.0,)
    scales: Tuple[float, ...] = ()
    allowed_border: int = 9999


#: stride -> anchor config; strides are iterated in DESCENDING order
#: (reference: generate_anchors_fpn2 sorts strides descending,
#: src/processing/generate_anchors.rs:123-124).
RPN_ANCHOR_CFG: Dict[int, AnchorConfig] = {
    32: AnchorConfig(scales=(32.0, 16.0)),
    16: AnchorConfig(scales=(8.0, 4.0)),
    8: AnchorConfig(scales=(2.0, 1.0)),
}


@dataclass(frozen=True)
class FaceDetectionConfig:
    """RetinaFace detector config (reference: face_pipeline/config.rs:22-33).

    Additions over the reference: `max_candidates` and `max_detections` fix
    the shapes of the decode+NMS stage (the reference's dynamic-length
    vectors become padded arrays with a validity count), and `backbone`
    selects the in-process network that replaces the remote Triton model.
    """

    model_name: str = "face_detection_retina"
    timeout: int = 20
    image_size: Tuple[int, int] = (640, 640)  # (width, height)
    max_batch_size: int = 1
    confidence_threshold: float = 0.7
    iou_threshold: float = 0.45
    # --- additions over the reference ---
    backbone: str = "mobilenet025"  # or "resnet50"
    # Top-k kept after the confidence filter.  NMS cost scales with
    # max_candidates^2; at the production 0.7 threshold, 128 simultaneous
    # candidates is already extreme (output caps at max_detections anyway).
    # Raise this (with a lower confidence_threshold) for dense-scene
    # evaluation such as WIDER-hard.
    max_candidates: int = 128
    max_detections: int = 100  # static post-NMS output rows
    # Candidate selection of the JAX package: "exact" (lax.top_k) or
    # "approx" (lax.approx_max_k).  The port always selects exactly, which
    # is what approx_max_k returns off the TPU.
    candidate_selection: str = "exact"
    feat_strides: Tuple[int, ...] = (32, 16, 8)
    bbox_stds: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    landmark_std: float = 1.0
    pixel_means: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # RGB
    pixel_stds: Tuple[float, float, float] = (1.0, 1.0, 1.0)  # RGB
    pixel_scale: float = 1.0
    dense_anchor: bool = False


@dataclass(frozen=True)
class FaceAlignmentConfig:
    """5-point alignment config (reference: face_pipeline/config.rs:42-55)."""

    image_size: Tuple[int, int] = (112, 112)
    # ArcFace 112x112 template landmarks, rows ordered
    # [left_eye, right_eye, nose, left_mouth, right_mouth].
    standard_landmarks: Tuple[Tuple[float, float], ...] = (
        (38.2946, 51.6963),
        (73.5318, 51.5014),
        (56.0252, 71.7366),
        (41.5493, 92.3655),
        (70.7299, 92.2041),
    )


@dataclass(frozen=True)
class FaceIdentificationConfig:
    """ArcFace embedding config (reference: face_pipeline/config.rs:65-74)."""

    model_name: str = "face_identification"
    timeout: int = 20
    image_size: Tuple[int, int] = (112, 112)
    batch_size: int = 1
    embedding_dim: int = 512
    backbone: str = "iresnet50"


@dataclass(frozen=True)
class FaceQualityConfig:
    """4-class quality head config (reference: face_pipeline/config.rs:85-95)."""

    model_name: str = "face_quality"
    timeout: int = 20
    image_size: Tuple[int, int] = (112, 112)
    batch_size: int = 1
    threshold: float = 0.5
    num_classes: int = 4


@dataclass(frozen=True)
class FaceSelectionConfig:
    """Heuristic face-selection config (reference: face_pipeline/config.rs:107-118)."""

    margin_center_left_ratio: float = 0.3
    margin_center_right_ratio: float = 0.3
    margin_edge_ratio: float = 0.1
    minimum_face_ratio: float = 0.0075
    minimum_width_height_ratio: float = 0.65
    maximum_width_height_ratio: float = 1.1
    # Enroll-mode width/image-width acceptance ratio.  The reference hardcodes
    # 0.25 and ignores `minimum_face_ratio` there (face_selection.rs:69).
    enroll_min_width_ratio: float = 0.25


@dataclass(frozen=True)
class FaceAntiSpoofingConfig:
    """MiniFAS ensemble config (reference: face_pipeline/config.rs:130-151)."""

    model_names: Tuple[str, ...] = (
        "miniFAS_4",
        "miniFAS_2_7",
        "miniFAS_2",
        "miniFAS_1",
    )
    scales: Tuple[float, ...] = (4.0, 2.7, 2.0, 1.0)
    image_sizes: Tuple[Tuple[int, int], ...] = (
        (80, 80),
        (80, 80),
        (256, 256),
        (128, 128),
    )
    threshold: float = 0.55
    timeout: int = 20
    batch_size: int = 1


@dataclass(frozen=True)
class FaceQualityAssessmentConfig:
    """Scalar quality-assessment config (reference: face_pipeline/config.rs:163-172).

    The reference model name carries a typo ("assetment"); we keep it as the
    registry key for drop-in parity.
    """

    model_name: str = "face_quality_assetment"
    timeout: int = 20
    image_size: Tuple[int, int] = (112, 112)
    batch_size: int = 1
    threshold: float = 55.0


@dataclass(frozen=True)
class FacePipelineConfig:
    """Top-level pipeline config bundling every module's defaults."""

    detection: FaceDetectionConfig = field(default_factory=FaceDetectionConfig)
    selection: FaceSelectionConfig = field(default_factory=FaceSelectionConfig)
    alignment: FaceAlignmentConfig = field(default_factory=FaceAlignmentConfig)
    quality: FaceQualityConfig = field(default_factory=FaceQualityConfig)
    identification: FaceIdentificationConfig = field(
        default_factory=FaceIdentificationConfig
    )
    antispoofing: FaceAntiSpoofingConfig = field(
        default_factory=FaceAntiSpoofingConfig
    )
    quality_assessment: FaceQualityAssessmentConfig = field(
        default_factory=FaceQualityAssessmentConfig
    )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


# ---------------------------------------------------------------------------
# eKYC pipeline configs (reference: src/pipeline/ekyc_pipeline/config.rs).
# The reference left this pipeline as an unfinished stub naming a different
# model family (SCRFD detector, CLIP-L14 anti-spoofing, attribute head).  We
# carry the same config surface so the scope is preserved.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EkycFaceDetectionConfig:
    model_name: str = "scrfd"
    timeout: int = 20
    mean: float = 127.5
    scale: float = 0.00784313725490196


@dataclass(frozen=True)
class EkycFaceIDConfig:
    model_name: str = "face_id"
    timeout: int = 20
    mean: float = 127.5
    scale: float = 0.00784313725490196
    threshold_same_ekyc: float = 0.3
    threshold_same_person: float = 0.4
    imsize: int = 112


@dataclass(frozen=True)
class EkycFaceAttributeConfig:
    model_name: str = "face_attribute"
    timeout: int = 20
    mean: float = 127.5
    scale: float = 1.0 / 127.5
    threshold_face_mask: float = 0.5
    imsize: int = 128


@dataclass(frozen=True)
class EkycFaceQualityConfig:
    model_name: str = "face_quality_vp"
    timeout: int = 20
    mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    scale: Tuple[float, float, float] = (
        1.0 / (0.229 * 255.0),
        1.0 / (0.224 * 255.0),
        1.0 / (0.225 * 255.0),
    )
    threshold_cover: float = 0.5
    threshold_all: float = 0.5
    imsize: int = 112


@dataclass(frozen=True)
class EkycFASCropConfig:
    model_name: str = "face_anti_spoofing_crop_l14"
    timeout: int = 20
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    threshold: float = 0.58
    imsize: int = 224


@dataclass(frozen=True)
class EkycFASFullConfig:
    model_name: str = "face_anti_spoofing_fi_l14"
    timeout: int = 20
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    threshold: float = 0.48
    imsize: int = 224
