"""The port never imports JAX, nor any module of the JAX package: every
module loads in a process without them.  Its entry points run on the card
unless asked for the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import rs_face_detection_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
reference = sorted(m for m in sys.modules if m.split(".")[0] == "rs_face_detection_tpu")
print(json.dumps({"modules": names, "jax": loaded, "reference": reference}))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["jax"] == []
    assert report["reference"] == [], "the port imported the JAX package"
    for name in (
        "configs", "kernels.build", "kernels.nms", "kernels.stem", "kernels.attention",
        "kernels.int8_matmul", "ops.nms", "ops.image", "ops.stem", "ops.attention",
        "ops.quantize", "models.resnet", "models.retinaface", "models.scrfd", "models.vit",
        "models.minifas", "models.quantized", "models.weights", "pipeline.detection",
        "pipeline.face_pipeline", "pipeline.ekyc_pipeline", "pipeline.extraction",
        "pipeline.quality", "pipeline.quality_assessment", "pipeline.antispoofing",
        "serving.detection_server", "utils.image_io",
    ):
        assert f"rs_face_detection_tpu_torch.{name}" in report["modules"]


@pytest.mark.parametrize(
    "entry",
    [
        "RetinaFaceDetection", "FacePipeline", "SCRFDDetection", "EKYCPipeline",
        "FaceExtraction", "FaceQuality", "FaceQualityAssessment", "FaceAntiSpoofing",
    ],
)
def test_entry_points_default_to_the_card(entry):
    """Built without a device on a host without CUDA, an entry point raises
    before it builds a model: nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    from rs_face_detection_tpu_torch.pipeline import (
        antispoofing,
        detection,
        ekyc_pipeline,
        extraction,
        face_pipeline,
        quality,
        quality_assessment,
    )

    cls = {
        "RetinaFaceDetection": detection.RetinaFaceDetection,
        "FacePipeline": face_pipeline.FacePipeline,
        "SCRFDDetection": ekyc_pipeline.SCRFDDetection,
        "EKYCPipeline": ekyc_pipeline.EKYCPipeline,
        "FaceExtraction": extraction.FaceExtraction,
        "FaceQuality": quality.FaceQuality,
        "FaceQualityAssessment": quality_assessment.FaceQualityAssessment,
        "FaceAntiSpoofing": antispoofing.FaceAntiSpoofing,
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls()
