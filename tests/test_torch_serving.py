"""The port's single-device DetectionServer.

  - ``detect_batch`` equals the detector's per-image ``__call__`` on frames
    the letterbox keeps as they are (counts equal, boxes and landmarks within
    1e-3 px, scores within 1e-5: the batch path's uint8 canvas and the host
    call's float frame hold the same values, the networks sum in other
    orders);
  - ``detect_batch`` equals the JAX DetectionServer (same bounds) with
    either loader: without the native one on frames it must resize (arrays
    and PNG bytes), since both letterbox with OpenCV's uint8 arithmetic;
    with the default native JPEG loader on the 20 JPEG collages of
    tests/test_torch_eval_wider.py's tree, at that file's eval settings;
  - ``detect_stream`` equals ``detect_batch`` per batch, bit for bit, with a
    partial last batch, on the R50 detector (fused stem path);
  - a producer error reaches the consumer after the batches already staged;
  - an mmdet-layout SCRFD (the eKYC detector) is served too, per image equal
    to its single-image path at the same bounds;
  - ``detect_batch`` and ``detect_stream`` count every batch in the
    detector's registry statistics, and a streamed batch's duration leaves
    out the time it waits for a slow consumer.
"""

import os
import time

import numpy as np
import pytest
import torch

from rs_face_detection_tpu.configs import FaceDetectionConfig
from rs_face_detection_tpu.parallel.serving import DetectionServer as JDetectionServer
from rs_face_detection_tpu.utils.fixtures import load_trained_detector
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.registry import DETECTION_OUTPUT_SPEC, ModelRegistry, ModelSpec
from rs_face_detection_tpu_torch.models.scrfd_import import load_scrfd_state_dict
from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import SCRFDDetection
from rs_face_detection_tpu_torch.serving.detection_server import DetectionServer
from test_torch_detection import _assert_same
from torch_mirrors import SCRFDMirror, randomize_state_dict

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TRAINED = os.path.join(FIXTURES, "trained_mnet64.npz")
CFG = FaceDetectionConfig(
    image_size=(64, 64), confidence_threshold=0.3, max_candidates=64, max_detections=8
)


@pytest.fixture(scope="module")
def mnet():
    family = "retinaface_mobilenet025"
    model = weights.load_model(family, weights.state_dict_from_jax(family, TRAINED))
    return RetinaFaceDetection(CFG, model, device="cpu")


@pytest.fixture(scope="module")
def r50():
    family = "retinaface_resnet50"
    cfg = FaceDetectionConfig(backbone="resnet50", image_size=(64, 64))
    return RetinaFaceDetection(cfg, weights.load_model(family, weights.init_state(family, 0)), device="cpu")


@pytest.fixture(scope="module")
def frames():
    with np.load(os.path.join(FIXTURES, "ap_eval_set.npz")) as d:
        ap = list(d["images"][:6])
    with np.load(os.path.join(FIXTURES, "golden_trained_scene.npz")) as g:
        scene = g["image"]
    return [scene, *ap]


def _same_results(got, want):
    assert len(got) == len(want)
    for (gd, gk), (wd, wk) in zip(got, want):
        _assert_same(gd, gk, wd, wk)


def test_detect_batch_equals_per_image_call(mnet, frames):
    with DetectionServer(mnet, batch_size=8) as server:
        got = server.detect_batch(frames)
    assert sum(len(d) for d, _ in got) >= len(frames)
    _same_results(got, [mnet(f) for f in frames])


def _collage_jpegs(tmp_path_factory):
    """The JPEG bytes of tests/test_torch_eval_wider.py's collage tree."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "tools", "make_collage_set.py")
    spec = importlib.util.spec_from_file_location("make_collage_set", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path_factory.mktemp("collage_jpegs"))
    tool.build_collage_set(out, FIXTURES, seed=0, n_images=20)
    images = os.path.join(out, "WIDER_val", "images", "0--Collage")
    payloads = []
    for name in sorted(os.listdir(images)):
        with open(os.path.join(images, name), "rb") as f:
            payloads.append(f.read())
    return payloads


@pytest.mark.parametrize("use_native_loader", [False, True], ids=["cv2", "native"])
def test_detect_batch_matches_jax_server(mnet, frames, use_native_loader, tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    if not use_native_loader:
        batch = [cv2.resize(f, (97, 99), interpolation=cv2.INTER_LINEAR) for f in frames[:4]]
        batch.append(cv2.resize(frames[4], (128, 128), interpolation=cv2.INTER_LINEAR))
        ok, png = cv2.imencode(".png", frames[5])
        assert ok
        batch.append(png.tobytes())
        ref = JDetectionServer(load_trained_detector(TRAINED, CFG), batch_size=8, use_native_loader=False)
        with ref, DetectionServer(mnet, batch_size=8, use_native_loader=False) as server:
            _same_results(server.detect_batch(batch), ref.detect_batch(batch))
        assert server.loader_batches == {"native": 0, "cv2": 1}
        return
    from rs_face_detection_tpu_torch.configs import FaceDetectionConfig as PortConfig
    from rs_face_detection_tpu_torch.utils.fixtures import load_trained_detector as port_detector

    payloads = _collage_jpegs(tmp_path_factory)
    assert len(payloads) == 20
    fields = dict(image_size=(64, 64), confidence_threshold=0.02, max_candidates=256)
    ckpt = os.path.join(FIXTURES, "trained_real64.npz")
    ref = JDetectionServer(load_trained_detector(ckpt, FaceDetectionConfig(**fields)), batch_size=8)
    port = port_detector(ckpt, PortConfig(**fields), device="cpu")
    with ref, DetectionServer(port, batch_size=8) as server:
        assert server._native is not None, server.native_unavailable
        assert ref._native is not None
        for i in range(0, len(payloads), 8):
            _same_results(server.detect_batch(payloads[i : i + 8]), ref.detect_batch(payloads[i : i + 8]))
    assert server.loader_batches == {"native": 3, "cv2": 0}


def test_detect_stream_equals_detect_batch(r50, frames):
    payloads = frames + frames[:3]  # 10 frames: batches of 4, 4 and 2
    with DetectionServer(r50, batch_size=4) as server:
        streamed = list(server.detect_stream(iter(payloads), prefetch=2))
        direct = [server.detect_batch(payloads[i : i + 4]) for i in range(0, len(payloads), 4)]
    assert [len(b) for b in streamed] == [4, 4, 2]
    for got, want in zip(streamed, direct):
        for (gd, gk), (wd, wk) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gk, wk)


def test_detect_stream_reraises_producer_error_after_draining(mnet, frames):
    def payloads():
        yield from frames[:6]
        raise RuntimeError("decoder failed")

    emitted = []
    with DetectionServer(mnet, batch_size=3) as server:
        with pytest.raises(RuntimeError, match="decoder failed"):
            for batch in server.detect_stream(payloads()):
                emitted.append(batch)
        want = [server.detect_batch(frames[:3]), server.detect_batch(frames[3:6])]
    assert len(emitted) == 2
    for got, ref in zip(emitted, want):
        for (gd, _), (wd, _) in zip(got, ref):
            np.testing.assert_array_equal(gd, wd)


def test_batch_limits_and_close(mnet, frames):
    server = DetectionServer(mnet, batch_size=2)
    assert server.detect_batch([]) == []
    with pytest.raises(ValueError, match="larger"):
        server.detect_batch(frames[:3])
    server.close()
    with pytest.raises(RuntimeError):
        server.detect_batch(frames[:1])


def _registry_detector(mnet):
    registry = ModelRegistry("cpu")
    registry.register(ModelSpec(CFG.model_name, (64, 64, 3), DETECTION_OUTPUT_SPEC), mnet.model)
    return registry, RetinaFaceDetection(CFG, device="cpu", registry=registry)


def test_scrfd_served_equals_single_image_path(frames):
    mirror = randomize_state_dict(SCRFDMirror(width=8), seed=5)
    model, _ = load_scrfd_state_dict({k: v.detach().numpy() for k, v in mirror.state_dict().items()})
    registry = ModelRegistry("cpu")
    registry.register(ModelSpec("scrfd", (64, 64, 3), "scrfd maps"), model)
    det = SCRFDDetection(device="cpu", image_size=(64, 64), registry=registry)
    with DetectionServer(det, batch_size=4) as server:
        assert server.image_size == (64, 64)
        got = server.detect_batch(frames[:4])
        streamed = [r for batch in server.detect_stream(iter(frames[:6])) for r in batch]
    registry.unload("scrfd")  # the per-image reference calls are not counted below
    want = [det(f) for f in frames[:6]]
    assert sum(len(d) for d, _ in want) > 0
    _same_results(got, want[:4])
    _same_results(streamed, want)


def test_batches_are_counted_in_registry_statistics(mnet, frames):
    registry, det = _registry_detector(mnet)
    with DetectionServer(det, batch_size=3) as server:
        server.detect_batch(frames[:2])
        assert [len(b) for b in server.detect_stream(iter(frames))] == [3, 3, 1]
    stats = registry.statistics(CFG.model_name)
    assert stats.inference_count == 2 + len(frames)
    assert stats.execution_count == 4
    assert stats.batch_size_counts == {2: 1, 3: 2, 1: 1}
    assert stats.cumulative_duration_s > 0


def test_stream_duration_leaves_out_the_consumers_wait(mnet, frames):
    """The JAX server times a streamed batch from dispatch to fetch, so a
    consumer that holds batch k lengthens batch k+1 by its wait; the port
    times each batch's dispatch and its fetch, which lie outside the
    consumer's waits and apart from each other, so the recorded durations
    and the waits add up to no more than the wall time, however fast the
    host runs."""
    registry, det = _registry_detector(mnet)
    wait = 0.2
    with DetectionServer(det, batch_size=2) as server:
        start = time.perf_counter()
        for _ in server.detect_stream(iter(frames[:6])):
            time.sleep(wait)
        wall = time.perf_counter() - start
    stats = registry.statistics(CFG.model_name)
    assert stats.execution_count == 3
    assert 0 < stats.cumulative_duration_s <= wall - 3 * wait, (stats.cumulative_duration_s, wall)
