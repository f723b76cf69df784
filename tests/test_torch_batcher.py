"""The port's DynamicBatcher (runtime/batcher.py) over its DetectionServer.

Ports of JAX tests/test_batcher.py on the CPU: concurrent single-image
submits coalesce into batches without changing a result (boxes and
landmarks within 1e-3 px of ``detect_batch`` on each image alone, which
tests/test_torch_serving.py holds against the JAX server), a bad payload
fails alone, close drains and then refuses, a cancelled future does not
kill the worker, the facade's Detect runs through the batcher, and an SCRFD
server coalesces too.  The statistics carry the JAX batcher's keys but
its sampled percentiles.  The kernels' launch counters are bumped under a lock: counts from concurrent
threads are exact, and a library's ctypes signatures are set once before
any thread can call it.
"""

import ctypes
import ctypes.util
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from rs_face_detection_tpu.runtime.batcher import DynamicBatcher as JDynamicBatcher
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import SCRFDDetection
from rs_face_detection_tpu_torch.runtime.batcher import DynamicBatcher
from rs_face_detection_tpu_torch.serving.detection_server import DetectionServer
from deadlines import in_threads

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TRAINED = os.path.join(FIXTURES, "trained_mnet64.npz")
FIELDS = dict(image_size=(64, 64), confidence_threshold=0.3, max_candidates=64, max_detections=16)
TOL = 1e-3


@pytest.fixture(scope="module")
def server():
    family = "retinaface_mobilenet025"
    det = RetinaFaceDetection(FaceDetectionConfig(**FIELDS),
                              weights.load_model(family, weights.state_dict_from_jax(family, TRAINED)), device="cpu")
    with DetectionServer(det, batch_size=8) as srv:
        yield srv


@pytest.fixture(scope="module")
def images():
    """The fixture scene and eval frames, resized so the letterbox works."""
    cv2 = pytest.importorskip("cv2")
    with np.load(os.path.join(FIXTURES, "ap_eval_set.npz")) as d:
        frames = list(d["images"][:12])
    with np.load(os.path.join(FIXTURES, "golden_trained_scene.npz")) as g:
        frames.append(g["image"])
    return [cv2.resize(f, (80 + 4 * (i % 5), 96), interpolation=cv2.INTER_LINEAR) for i, f in enumerate(frames)]


def assert_same(got, want):
    assert len(got) == len(want)
    for (b, k), (eb, ek) in zip(got, want):
        assert b.shape == eb.shape
        np.testing.assert_allclose(b, eb, rtol=0, atol=TOL)
        np.testing.assert_allclose(k, ek, rtol=0, atol=TOL)


def burst(batcher, payloads, threads=8):
    futs = in_threads(lambda w: [batcher.submit(p) for p in payloads[w::threads]], threads, "submitting client")
    return [futs[i % threads][i // threads].result(timeout=120) for i in range(len(payloads))]


def test_concurrent_submits_coalesce_and_match(server, images):
    imgs = images * 2  # 26 requests through an 8-wide server
    expected = [server.detect_batch([im])[0] for im in imgs]
    with DynamicBatcher(server, max_delay_ms=50.0) as batcher:
        results = burst(batcher, imgs)
        stats = batcher.stats()
    assert sum(len(b) for b, _ in results) >= len(images)
    assert_same(results, expected)
    assert stats["requests"] == len(imgs)
    assert stats["batches"] < len(imgs) and any(int(k) > 1 for k in stats["batch_size_counts"])
    assert stats["cumulative_compute_s"] > 0 and stats["cumulative_queue_s"] >= 0
    # the port keeps no sampled percentiles: a traced session's
    # runtime.queue and runtime.batch spans carry the distributions
    with JDynamicBatcher(batch_fn=lambda items: items, batch_size=2) as jb:
        jb.submit(1).result(timeout=10)
        assert set(jb.stats()) - {"queue_ms", "compute_ms"} == set(stats)


def test_bad_payload_isolated(server, images):
    with DynamicBatcher(server, max_delay_ms=50.0) as batcher:
        f_good1 = batcher.submit(images[0])
        f_bad = batcher.submit(b"definitely not a jpeg")
        f_good2 = batcher.submit(images[0])
        b1, _ = f_good1.result(timeout=120)
        b2, _ = f_good2.result(timeout=120)
        with pytest.raises(Exception):
            f_bad.result(timeout=120)
    np.testing.assert_array_equal(b1, b2)


def test_close_rejects_and_drains(server):
    batcher = DynamicBatcher(server, max_delay_ms=1.0)
    img = np.zeros((64, 64, 3), np.uint8)
    fut = batcher.submit(img)
    batcher.close()
    boxes, _ = fut.result(timeout=120)  # already-queued work completes
    assert boxes.ndim == 2
    with pytest.raises(RuntimeError):
        batcher.submit(img)
    batcher.close()  # idempotent


def test_cancelled_future_does_not_kill_worker(server):
    img = np.zeros((64, 64, 3), np.uint8)
    with DynamicBatcher(server, max_delay_ms=200.0) as batcher:
        doomed = batcher.submit(img)
        assert doomed.cancel()
        ok = batcher.submit(img)
        assert ok.result(timeout=120)[0].ndim == 2
        assert batcher.detect(img, timeout=120)[0].ndim == 2


def test_facade_detect_through_batcher(server, images):
    """The unary Detect verb with dynamic_batching=True keeps the JSON
    contract and reports the coalescing statistics in ServerMetadata."""
    cv2 = pytest.importorskip("cv2")
    from rs_face_detection_tpu_torch.models.registry import ModelRegistry
    from rs_face_detection_tpu_torch.runtime.server import FacePipelineServicer

    servicer = FacePipelineServicer(None, ModelRegistry("cpu"), dynamic_batching=True, batch_delay_ms=1.0)
    servicer._stream_server = server
    ok, enc = cv2.imencode(".png", images[-1])
    out = json.loads(servicer.detect(enc.tobytes()))
    (want,) = server.detect_batch([images[-1]])
    assert np.asarray(out["boxes"]).shape == want[0].shape and len(out["boxes"]) >= 1
    np.testing.assert_allclose(np.asarray(out["boxes"]), want[0], rtol=0, atol=TOL)
    meta = json.loads(servicer.server_metadata(b""))
    assert meta["dynamic_batching"] is True and meta["dynamic_batching_stats"]["requests"] == 1
    servicer._stream_server = None  # the module fixture closes the server
    servicer.close()


def test_batcher_over_scrfd_server():
    det = SCRFDDetection(model=weights.load_model("scrfd", weights.init_state("scrfd", 0, 2)),
                         device="cpu", image_size=(64, 64), confidence_threshold=0.4)
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 255, size=(64, 64, 3), dtype=np.uint8) for _ in range(8)]
    expected = [det(im) for im in imgs]
    with DetectionServer(det, batch_size=4, use_native_loader=False) as srv:
        with DynamicBatcher(srv, max_delay_ms=50.0) as batcher:
            results = burst(batcher, imgs)
            stats = batcher.stats()
    assert_same(results, expected)
    assert stats["batches"] < 8


@pytest.mark.parametrize("kernel", ["nms", "stem", "attention", "int8_matmul"])
def test_launch_counts_are_exact_under_threads(kernel):
    mod = importlib.import_module(f"rs_face_detection_tpu_torch.kernels.{kernel}")
    before, per, n = mod.launches, 20000, 8
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        in_threads(lambda _: [mod.count_launch() for _ in range(per)], n, "counting")
    finally:
        sys.setswitchinterval(switch)
    assert mod.launches == before + per * n
    mod.launches = before


def test_library_setup_runs_once_before_any_caller(monkeypatch):
    from rs_face_detection_tpu_torch.kernels import build

    libm = ctypes.util.find_library("m")  # stands in for a kernel library
    assert libm is not None
    monkeypatch.setattr(build, "build", lambda name: libm)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_set_up", set())
    calls = []

    def setup(lib):
        calls.append(lib)
        lib.cos.restype = ctypes.c_double
        lib.cos.argtypes = [ctypes.c_double]

    seen = in_threads(lambda _: build.load("standin", setup).cos(0.0), 8, "first-call")
    assert len(calls) == 1 and seen == [1.0] * 8
    assert build.load("standin") is calls[0]  # a load without setup keeps the library
