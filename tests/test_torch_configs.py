"""The port's configs.py: every copy equal to its original in the JAX package."""

import dataclasses

import pytest

from rs_face_detection_tpu import configs as jconfigs
from rs_face_detection_tpu_torch import configs

DATACLASSES = [
    "AnchorConfig",
    "FaceDetectionConfig",
    "FaceAlignmentConfig",
    "FaceIdentificationConfig",
    "FaceQualityConfig",
    "FaceSelectionConfig",
    "FaceAntiSpoofingConfig",
    "FaceQualityAssessmentConfig",
    "FacePipelineConfig",
    "EkycFaceDetectionConfig",
    "EkycFaceIDConfig",
    "EkycFaceAttributeConfig",
    "EkycFaceQualityConfig",
    "EkycFASCropConfig",
    "EkycFASFullConfig",
]


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", DATACLASSES)
def test_dataclass_copy_equals_original(name):
    port, ref = getattr(configs, name), getattr(jconfigs, name)
    assert port is not ref
    assert _fields(port) == _fields(ref)
    # Defaults, nested configs included, compared field by field.
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
    assert port.__dataclass_params__.frozen == ref.__dataclass_params__.frozen


def test_anchor_table_config_equal():
    assert set(configs.RPN_ANCHOR_CFG) == set(jconfigs.RPN_ANCHOR_CFG)
    for stride, cfg in configs.RPN_ANCHOR_CFG.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfigs.RPN_ANCHOR_CFG[stride])


def test_quality_class_members_equal():
    assert configs.FaceQualityClass is not jconfigs.FaceQualityClass
    assert [(m.name, m.value) for m in configs.FaceQualityClass] == [
        (m.name, m.value) for m in jconfigs.FaceQualityClass
    ]


def test_pipeline_config_json_round_trip():
    cfg = configs.FacePipelineConfig()
    assert cfg.to_json() == jconfigs.FacePipelineConfig().to_json()
