"""The port's DetectionServer split over replicas (``mesh=``, a sequence of
devices) against the JAX package's mesh-sharded server on its 8-device
virtual CPU mesh.  On the CPU every replica sits on the one device, so the
replicas share the detector there and the split, the per-part staging and
detect, and the in-order gather are what is exercised.

- JAX's test_detection_server_sharded_batch: the mnet at 64x64 from JAX's
  init, threshold 0.3, 64 candidates, 16 detections, 8 random images of
  96x80; the port over ``["cpu"] * 2`` and ``["cpu"] * 4`` against JAX's
  ``DetectionServer(mesh=make_mesh(8))`` at rtol 1e-4 / atol 1e-3 (that
  test's bound) and against the port's unsharded server (counts equal,
  boxes and landmarks within 1e-3 px, scores within 1e-5);
- JAX's SCRFD case (width 8, 64x64, threshold 0.4, 4 images) over two
  replicas, against JAX's mesh server at the same bound;
- ``batch_size`` not divisible by the replicas raises;
- a swapped module (``detector.model`` replaced) is served by every
  replica, equal to an unsharded server on the new weights; a replica
  copied onto a device (``replica_on``) detects as the detector does;
- ``detect_stream`` over replicas equals ``detect_batch`` bit for bit, with
  a short last batch that leaves a replica without a share, and each batch
  is one ``record_traffic`` in the registry's statistics.
"""

import os

import numpy as np
import pytest
import torch

from rs_face_detection_tpu.configs import FaceDetectionConfig as JaxConfig
from rs_face_detection_tpu.models.retinaface import init_retinaface
from rs_face_detection_tpu.models.scrfd import init_scrfd
from rs_face_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rs_face_detection_tpu.parallel.serving import DetectionServer as JDetectionServer
from rs_face_detection_tpu.pipeline.detection import RetinaFaceDetection as JRetinaFaceDetection
from rs_face_detection_tpu.pipeline.ekyc_pipeline import SCRFDDetection as JSCRFDDetection
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.registry import DETECTION_OUTPUT_SPEC, ModelRegistry, ModelSpec
from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import SCRFDDetection
from rs_face_detection_tpu_torch.serving.detection_server import DetectionServer, replica_on
from test_torch_detection import _assert_same
from test_torch_mesh import flat_leaves

torch.set_num_threads(2)

FIELDS = dict(image_size=(64, 64), confidence_threshold=0.3, max_candidates=64, max_detections=16)
FAMILY = "retinaface_mobilenet025"
TRAINED = os.path.join(os.path.dirname(__file__), "fixtures", "trained_mnet64.npz")


@pytest.fixture(scope="module")
def mnet():
    model, variables = init_retinaface("mobilenet025", (64, 64), seed=0)
    jdet = JRetinaFaceDetection(JaxConfig(**FIELDS), model=model, variables=variables)
    port = RetinaFaceDetection(FaceDetectionConfig(**FIELDS), weights.load_model(
        FAMILY, weights.state_dict_from_jax(FAMILY, flat_leaves(variables))), device="cpu")
    return jdet, port


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 255, size=(96, 80, 3), dtype=np.uint8) for _ in range(8)]


def _same_results(got, want):
    assert len(got) == len(want)
    for (gd, gk), (wd, wk) in zip(got, want):
        _assert_same(gd, gk, wd, wk)


def _jax_close(got, want):
    assert len(got) == len(want)
    for (gd, gk), (wd, wk) in zip(got, want):
        assert gd.shape == wd.shape
        np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(gk, wk, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("replicas", [2, 4])
def test_replica_server_matches_jax_mesh_server(mnet, images, replicas):
    jdet, port = mnet
    with JDetectionServer(jdet, mesh=jax_make_mesh(8), batch_size=8) as ref:
        want = ref.detect_batch(images)
    with DetectionServer(port, mesh=["cpu"] * replicas, batch_size=8) as server, \
            DetectionServer(port, batch_size=8) as single:
        assert len(server.replicas()) == replicas
        got = server.detect_batch(images)
        unsharded = single.detect_batch(images)
    assert all(boxes.ndim == 2 and boxes.shape[1] == 5 for boxes, _ in got)
    _jax_close(got, want)
    _same_results(got, unsharded)


def test_replica_server_serves_scrfd(images):
    model, variables = init_scrfd((64, 64), width=8, seed=0)
    jdet = JSCRFDDetection(model=model, variables=variables, image_size=(64, 64), confidence_threshold=0.4,
                           registry=None)
    port = SCRFDDetection(model=weights.load_model("scrfd", weights.state_dict_from_jax("scrfd", flat_leaves(
        variables))), device="cpu", image_size=(64, 64), confidence_threshold=0.4)
    batch = [img[:64, :64].copy() for img in images[:4]]
    with JDetectionServer(jdet, mesh=jax_make_mesh(8), batch_size=8, use_native_loader=False) as ref:
        want = ref.detect_batch(batch)
    with DetectionServer(port, mesh=["cpu", "cpu"], batch_size=4, use_native_loader=False) as server:
        got = server.detect_batch(batch)
    _jax_close(got, want)


def test_batch_size_not_divisible_by_replicas_raises(mnet):
    _, port = mnet
    with pytest.raises(ValueError, match="not divisible by 3 replicas"):
        DetectionServer(port, mesh=["cpu"] * 3, batch_size=8)
    with pytest.raises(ValueError, match="no device"):
        DetectionServer(port, mesh=[], batch_size=8)


def test_swapped_weights_reach_every_replica(images):
    """Replace the detector's module: the next batch is detected on the new
    weights by both replicas, as an unsharded server on them detects it."""
    cfg = FaceDetectionConfig(**FIELDS)
    det = RetinaFaceDetection(cfg, weights.load_model(FAMILY, weights.init_state(FAMILY, 0)), device="cpu")
    with DetectionServer(det, mesh=["cpu", "cpu"], batch_size=8) as server:
        before = server.detect_batch(images)
        new = weights.load_model(FAMILY, weights.state_dict_from_jax(FAMILY, TRAINED))
        det.model = new
        assert all(rep.model is new for rep in server.replicas())
        after = server.detect_batch(images)
    fresh = RetinaFaceDetection(cfg, weights.load_model(
        FAMILY, weights.state_dict_from_jax(FAMILY, TRAINED)), device="cpu")
    with DetectionServer(fresh, batch_size=8) as single:
        want = single.detect_batch(images)
    _same_results(after, want)
    assert any(len(a) != len(b) or not np.array_equal(a, b) for (a, _), (b, _) in zip(after, before))


def test_replica_on_copies_the_detector(mnet, images):
    _, port = mnet
    copy = replica_on(port, torch.device("cpu"))
    assert copy.model is not port.model and copy.device == port.device
    assert all(torch.equal(a, b) for a, b in zip(copy.model.state_dict().values(), port.model.state_dict().values()))
    canvases = torch.from_numpy(np.stack([img[:64, :64] for img in images]))
    scales = torch.ones(len(images))
    got, want = copy.detect_batch(canvases, scales), port.detect_batch(canvases, scales)
    assert torch.equal(got.count, want.count) and torch.equal(got.det, want.det)


def test_replica_stream_and_statistics(mnet, images):
    _, port = mnet
    registry = ModelRegistry("cpu")
    cfg = FaceDetectionConfig(**FIELDS)
    registry.register(ModelSpec(cfg.model_name, (64, 64, 3), DETECTION_OUTPUT_SPEC), port.model)
    det = RetinaFaceDetection(cfg, device="cpu", registry=registry)
    payloads = images + images[:2]  # 10 images: batches of 4, 4 and 2 (the second replica idle)
    with DetectionServer(det, mesh=["cpu", "cpu"], batch_size=4) as server:
        streamed = list(server.detect_stream(iter(payloads)))
        direct = [server.detect_batch(payloads[i : i + 4]) for i in range(0, len(payloads), 4)]
    assert [len(b) for b in streamed] == [4, 4, 2]
    for got, want in zip(streamed, direct):
        for (gd, gk), (wd, wk) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gk, wk)
    stats = registry.statistics(cfg.model_name)
    assert stats.execution_count == 6 and stats.inference_count == 20
    assert stats.batch_size_counts == {4: 4, 2: 2}
