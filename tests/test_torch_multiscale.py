"""The port's MultiScaleDetection (pipeline/multiscale.py) against the JAX
package's, at buckets (64, 64), (96, 64) and (128, 96).

  - ``pick_bucket`` routes a grid of sizes as JAX does;
  - every bucket's detector holds the same module (``is``), its own anchor
    table, and the first detector's registry, so the statistics count the
    calls of every bucket;
  - on ``trained_mnet64.npz`` each routed call equals JAX's (counts equal,
    boxes and landmarks within 1e-3 px, scores within 1e-5: the networks sum
    in other orders);
  - an SCRFD ladder built through ``detector_factory`` equals JAX's within
    the same bounds;
  - ``DEFAULT_BUCKETS`` are JAX's.
"""

import os

import jax
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.configs import FaceDetectionConfig as JFaceDetectionConfig
from rs_face_detection_tpu.models.scrfd import init_scrfd
from rs_face_detection_tpu.pipeline import multiscale as jms
from rs_face_detection_tpu.pipeline.ekyc_pipeline import SCRFDDetection as JSCRFDDetection
from rs_face_detection_tpu.utils.fixtures import load_trained_detector as jload
from rs_face_detection_tpu.utils.synthetic import synth_scene
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.registry import DETECTION_OUTPUT_SPEC, ModelRegistry, ModelSpec
from rs_face_detection_tpu_torch.pipeline import multiscale as pms
from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import SCRFDDetection
from test_torch_detection import _assert_same

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TRAINED = os.path.join(FIXTURES, "trained_mnet64.npz")
BUCKETS = ((128, 96), (64, 64), (96, 64))  # unsorted on purpose
FIELDS = dict(confidence_threshold=0.3, max_candidates=64, max_detections=8)


@pytest.fixture(scope="module")
def ladders():
    """(port, JAX) ladders on the trained fixture; the port's module is
    served by a CPU registry, so its statistics can be read."""
    family = "retinaface_mobilenet025"
    cfg = FaceDetectionConfig(**FIELDS)
    registry = ModelRegistry("cpu")
    registry.register(
        ModelSpec(cfg.model_name, (64, 64, 3), DETECTION_OUTPUT_SPEC),
        weights.load_model(family, weights.state_dict_from_jax(family, TRAINED)),
    )
    port = pms.MultiScaleDetection(BUCKETS, cfg, registry=registry, device="cpu")
    jdet = jload(TRAINED)
    ref = jms.MultiScaleDetection(BUCKETS, JFaceDetectionConfig(**FIELDS), model=jdet.model, variables=jdet.variables)
    return port, ref, registry


def _images():
    """Synthetic scenes that route to each bucket, and one larger than all."""
    rng = np.random.default_rng(0)
    out = []
    for h, w, lo, hi in ((50, 60, 14, 28), (60, 90, 14, 28), (90, 120, 16, 32), (200, 300, 40, 70)):
        img, _, _, _ = synth_scene(rng, h, w, max_faces=2, min_size=lo, max_size=hi)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def test_default_buckets_and_routing_equal_jax(ladders):
    port, ref, _ = ladders
    assert pms.DEFAULT_BUCKETS == jms.DEFAULT_BUCKETS
    assert port.buckets == ref.buckets == [(64, 64), (96, 64), (128, 96)]
    for h in range(1, 220, 7):
        for w in range(1, 220, 9):
            assert port.pick_bucket(h, w) == ref.pick_bucket(h, w), (h, w)
    with pytest.raises(ValueError, match="at least one bucket"):
        pms.MultiScaleDetection(buckets=(), device="cpu")


def test_buckets_share_one_module_and_the_registry(ladders):
    port, _, registry = ladders
    dets = [port.detectors[b] for b in port.buckets]
    assert all(d.model is dets[0].model for d in dets)
    assert dets[0].model is registry.get(FaceDetectionConfig().model_name)
    assert all(d._registry is registry for d in dets)
    sizes = [d.anchors.shape[0] for d in dets]
    assert sizes == sorted(sizes) and len(set(sizes)) == 3
    assert [tuple(d.cfg.image_size) for d in dets] == port.buckets
    assert all(d.cfg.confidence_threshold == 0.3 and d.cfg.max_detections == 8 for d in dets)


def test_detections_equal_jax_and_statistics_count_every_bucket(ladders):
    port, ref, registry = ladders
    name = FaceDetectionConfig().model_name
    before = registry.statistics(name).inference_count
    found = 0
    for img in _images():
        got, want = port(img), ref(img)
        _assert_same(*got, *want)
        found += len(got[0])
    assert found >= 4
    assert registry.statistics(name).inference_count == before + 4


def test_scrfd_ladder_through_the_factory_equals_jax():
    jmodel, jvars = init_scrfd((64, 64), width=8, seed=0)
    jvars = jax.tree.map(np.asarray, jvars)
    model = weights.load_model("scrfd", weights.state_dict_from_jax("scrfd", jvars))
    port = pms.MultiScaleDetection(
        BUCKETS, model=model, detector_factory=lambda size, m: SCRFDDetection(model=m, device="cpu", image_size=size)
    )
    ref = jms.MultiScaleDetection(
        BUCKETS, model=jmodel, variables=jvars,
        detector_factory=lambda size, m, v: JSCRFDDetection(model=m, variables=v, image_size=size, registry=None),
    )
    assert all(d.model is model for d in port.detectors.values())
    assert [d.image_size for d in port.detectors.values()] == port.buckets
    found = 0
    for img in _images():
        got, want = port(img), ref(img)
        _assert_same(*got, *want)
        found += len(got[0])
    assert found >= 1
