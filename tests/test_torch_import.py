"""The port never imports JAX, nor any module of the JAX package: every
module loads in a process without them (and without ml_dtypes, and the
package without grpc), and so does the file of the kernels' card tests.  Its entry points run on the card unless asked for the
CPU."""

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
        "serving.detection_server", "utils.image_io", "models.heads", "models.registry",
        "models.checkpoint_maps", "models.clip_import", "models.scrfd_import", "models.checkpoint_io",
        "ops.matching", "ops.eval", "ops.wider", "ops.wider_split", "pipeline.tracking",
        "pipeline.multiscale", "pipeline.tta", "utils.synthetic", "utils.fixtures", "tools.eval_wider",
        "ops.int8_conv", "runtime.native", "runtime.proto3", "runtime.shm", "runtime.batcher",
        "runtime.repository", "runtime.wire", "runtime.server", "runtime.http", "runtime.__main__",
        "runtime.aot", "utils.coordinate", "utils.debug", "parallel.train", "parallel.data",
        "parallel.checkpoint", "tools.train_detector", "parallel.mesh", "parallel.tp",
    ):
        assert f"rs_face_detection_tpu_torch.{name}" in report["modules"]


#: Import every module of the package with some top-level packages made
#: unimportable (a None entry in sys.modules raises ImportError).
_BLOCKED_PROBE = """
import importlib, json, pkgutil, sys
for name in sys.argv[1:]:
    sys.modules[name] = None
import rs_face_detection_tpu_torch as pkg
from rs_face_detection_tpu_torch.runtime import server, wire
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"modules": names, "grpc": server._HAS_GRPC}))
"""


@pytest.mark.parametrize("blocked", [("jax", "flax", "ml_dtypes"), ("grpc",)], ids=["no-jax", "no-grpc"])
def test_package_imports_with_modules_blocked(blocked):
    """The serving runtime imports with JAX, flax and ml_dtypes unimportable,
    and the whole package imports without grpc (grpc is needed at ``serve``
    and by the clients, not at import)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_PROBE, *blocked], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("proto3", "shm", "batcher", "repository", "wire", "server", "http", "aot", "__main__"):
        assert f"rs_face_detection_tpu_torch.runtime.{name}" in report["modules"]
    assert report["grpc"] is (blocked != ("grpc",))


#: Collect the card tests as the card's machine runs them: no JAX, no flax,
#: and no tests/conftest.py (it imports JAX).
_COLLECT_GPU_TESTS = """
import sys
sys.modules["jax"] = sys.modules["flax"] = None
import pytest
sys.exit(pytest.main(["--noconftest", "--collect-only", "-q", "-p", "no:cacheprovider",
                      "tests/test_torch_kernels_gpu.py"]))
"""

#: The four kernels' card tests moved there (34 cases) and the K1 cases
#: added beside them (38).
GPU_TEST_CASES = 34 + 38


def test_kernel_card_tests_collect_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _COLLECT_GPU_TESTS], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    cases = [ln for ln in proc.stdout.splitlines() if ln.startswith("tests/test_torch_kernels_gpu.py::")]
    assert len(cases) >= GPU_TEST_CASES, proc.stdout


@pytest.mark.parametrize(
    "entry",
    [
        "RetinaFaceDetection", "FacePipeline", "SCRFDDetection", "EKYCPipeline",
        "FaceExtraction", "FaceQuality", "FaceQualityAssessment", "FaceAntiSpoofing", "Gallery",
        "DetectionServer", "ModelRegistry", "standard_registry", "default_registry",
        "MultiScaleDetection", "TTADetection", "VideoPipeline", "load_trained_detector", "eval_wider",
        "quantize_retinaface", "runtime", "export_detector", "load_detector", "Trainer", "train_detector",
        "initialize_distributed", "make_mesh", "make_tp_vit_fn", "DetectionServer(mesh)", "export_tp_vit",
        "load_tp_vit",
    ],
)
def test_entry_points_default_to_the_card(entry):
    """Built without a device on a host without CUDA, an entry point raises
    before it builds a model: nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    from rs_face_detection_tpu_torch.models import registry
    from rs_face_detection_tpu_torch.models.retinaface import RetinaFace
    from rs_face_detection_tpu_torch.ops import matching, quantize
    from rs_face_detection_tpu_torch.models.vit import ViT
    from rs_face_detection_tpu_torch.parallel import mesh, tp, train
    from rs_face_detection_tpu_torch.pipeline import (
        antispoofing,
        detection,
        ekyc_pipeline,
        extraction,
        face_pipeline,
        quality,
        quality_assessment,
    )
    from rs_face_detection_tpu_torch.pipeline import multiscale, tracking, tta
    from rs_face_detection_tpu_torch.runtime import __main__ as runtime_main
    from rs_face_detection_tpu_torch.runtime import aot
    from rs_face_detection_tpu_torch.serving import detection_server
    from rs_face_detection_tpu_torch.tools import eval_wider, train_detector
    from rs_face_detection_tpu_torch.utils import fixtures

    ckpt = os.path.join(REPO, "tests", "fixtures", "trained_mnet64.npz")
    cls = {
        "RetinaFaceDetection": detection.RetinaFaceDetection,
        "FacePipeline": face_pipeline.FacePipeline,
        "SCRFDDetection": ekyc_pipeline.SCRFDDetection,
        "EKYCPipeline": ekyc_pipeline.EKYCPipeline,
        "FaceExtraction": extraction.FaceExtraction,
        "FaceQuality": quality.FaceQuality,
        "FaceQualityAssessment": quality_assessment.FaceQualityAssessment,
        "FaceAntiSpoofing": antispoofing.FaceAntiSpoofing,
        "Gallery": matching.Gallery,
        "DetectionServer": detection_server.DetectionServer,
        "ModelRegistry": registry.ModelRegistry,
        "standard_registry": registry.standard_registry,
        "default_registry": registry.default_registry,
        "MultiScaleDetection": multiscale.MultiScaleDetection,
        "TTADetection": tta.TTADetection,
        "VideoPipeline": tracking.VideoPipeline,
        "load_trained_detector": lambda: fixtures.load_trained_detector(ckpt),
        "eval_wider": lambda: eval_wider.main(["--root", REPO, "--checkpoint", ckpt]),
        "quantize_retinaface": lambda: quantize.quantize_retinaface(RetinaFace(), (64, 64)),
        "runtime": lambda: runtime_main.main(["--port", "0", "--http-port", "0"]),
        "export_detector": lambda: aot.export_detector(detection.RetinaFaceDetection()),
        "load_detector": lambda: aot.load_detector(b""),
        "Trainer": train.Trainer,
        "train_detector": lambda: train_detector.main(["--labels", ckpt, "--images", REPO, "--out", ckpt]),
        "initialize_distributed": lambda: mesh.initialize_distributed("localhost:1", 1, 0),
        "make_mesh": mesh.make_mesh,
        "make_tp_vit_fn": lambda: tp.make_tp_vit_fn(ViT("clip_tiny_test", image_size=32), None),
        "DetectionServer(mesh)": lambda: detection_server.DetectionServer(
            fixtures.load_trained_detector(ckpt, device="cpu"), mesh=["cuda", "cuda"]),
        "export_tp_vit": lambda: aot.export_tp_vit(ViT("clip_tiny_test", image_size=32), None, 8, (32, 32)),
        "load_tp_vit": lambda: aot.load_tp_vit(b"", None),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls()


@pytest.mark.parametrize("entry", ["FacePipeline", "EKYCPipeline", "FaceExtraction", "SCRFDDetection"])
def test_registry_built_entry_points_raise_before_building(entry):
    """Given a registry and no device, an entry point raises on a host
    without CUDA before any builder runs."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device is valid here")
    from rs_face_detection_tpu_torch.models.registry import ModelRegistry
    from rs_face_detection_tpu_torch.pipeline import ekyc_pipeline, extraction, face_pipeline

    built = []
    registry = ModelRegistry("cpu")
    for name in ("face_detection_retina", "face_quality", "face_identification", "scrfd", "face_id",
                 "face_attribute", "face_quality_vp", "face_anti_spoofing_crop_l14", "face_anti_spoofing_fi_l14"):
        registry.register_builder(name, lambda name=name: built.append(name))
    cls = {
        "FacePipeline": face_pipeline.FacePipeline,
        "EKYCPipeline": ekyc_pipeline.EKYCPipeline,
        "FaceExtraction": extraction.FaceExtraction,
        "SCRFDDetection": ekyc_pipeline.SCRFDDetection,
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(registry=registry)
    assert built == [] and registry.index()[0]["state"] == "UNAVAILABLE"
