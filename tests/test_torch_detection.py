"""The port's detector against the JAX RetinaFaceDetection on bridged weights.

Both sides run the same weights on the same frames, through the host call
and the batched path.  Required: equal counts, boxes and landmarks within
1e-3 px, scores within 1e-5; and the JAX package's golden fixtures.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.configs import RPN_ANCHOR_CFG, FaceDetectionConfig
from rs_face_detection_tpu.models.retinaface import init_retinaface
from rs_face_detection_tpu.ops.anchors import full_anchor_table
from rs_face_detection_tpu.pipeline.detection import RetinaFaceDetection as JDetection
from rs_face_detection_tpu.pipeline.detection import topk_decode_and_nms
from rs_face_detection_tpu.utils.fixtures import load_trained_detector
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.pipeline import detection
from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TRAINED = os.path.join(FIXTURES, "trained_mnet64.npz")
CFG = FaceDetectionConfig(
    image_size=(64, 64), confidence_threshold=0.3, max_candidates=64, max_detections=8
)


def _port(cfg, source):
    family = "retinaface_mobilenet025"
    return RetinaFaceDetection(
        cfg, weights.load_model(family, weights.state_dict_from_jax(family, source)), device="cpu"
    )


def _assert_same(got_det, got_kps, want_det, want_kps):
    got_det, want_det = np.asarray(got_det), np.asarray(want_det)
    assert got_det.shape == want_det.shape
    np.testing.assert_allclose(got_det[:, :4], want_det[:, :4], atol=1e-3)
    np.testing.assert_allclose(got_det[:, 4], want_det[:, 4], atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_kps), np.asarray(want_kps), atol=1e-3)


#: The ABI version JAX's runtime/native.py::load accepts.
JAX_NATIVE_ABI = 4


def _native_library_state(path, quiet_s=1.0):
    """None when the library at ``path`` is complete, else why not: absent,
    written less than ``quiet_s`` ago (a build may still be writing it), or
    a copy of it does not load with JAX's ABI in a child process (a
    truncated library can kill the process that maps it with SIGBUS)."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return "absent"
    age = time.time() - st.st_mtime
    if age < quiet_s:
        return f"written {age:.2f} s ago ({st.st_size} bytes), maybe still growing"
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, os.path.basename(path))
        shutil.copyfile(path, copy)
        if os.stat(path).st_mtime != st.st_mtime:
            return "rewritten while it was copied"
        probe = "import ctypes, sys; print(ctypes.CDLL(sys.argv[1]).rsfd_abi_version())"
        proc = subprocess.run([sys.executable, "-c", probe, copy], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or proc.stdout.strip() != str(JAX_NATIVE_ABI):
        return (f"a copy of its {st.st_size} bytes does not load with ABI {JAX_NATIVE_ABI} "
                f"(rc {proc.returncode}: {proc.stderr.strip()[-200:]})")
    return None


def load_jax_native(monkeypatch, timeout_s=120.0):
    """JAX's native library (rs_face_detection_tpu/runtime/native.py),
    loaded even when another test process is building it at this moment.

    JAX's ``load()`` memoizes a failure for the life of the process, and a
    process that maps ``native/librsfd_native.so`` while ``make`` writes it
    in place fails.  So when ``load()`` returns None, wait until the file is
    complete, clear the memo for this test only and load again; fail with
    the reason after ``timeout_s``.  Never skips and never accepts cv2."""
    from rs_face_detection_tpu.runtime import native as jnative

    deadline = time.monotonic() + timeout_s
    absent_since = time.monotonic()
    lib = jnative.load()
    while lib is None:
        reason = _native_library_state(jnative._LIB_PATH)
        if reason != "absent":
            absent_since = time.monotonic()
        # Absent for 10 s: nobody is building it, so load() builds it.
        if reason is None or time.monotonic() - absent_since > 10.0:
            monkeypatch.setattr(jnative, "_load_failed", False)
            lib = jnative.load()
            if lib is not None:
                break
            reason = reason or "complete, but JAX's load() returned None"
        if time.monotonic() > deadline:
            pytest.fail(f"JAX's native library did not load within {timeout_s} s: {reason}")
        time.sleep(0.2)
    return lib


def test_p10_jax_native_loads_after_a_concurrent_build(tmp_path, monkeypatch):
    """A library still being written fails JAX's load(), which memoizes the
    failure; load_jax_native waits for the whole file and loads it."""
    from rs_face_detection_tpu.runtime import native as jnative

    whole = open(load_jax_native(monkeypatch)._name, "rb").read()
    native_dir = tmp_path / "native"
    shutil.copytree(os.path.dirname(jnative._LIB_PATH), native_dir)
    so = native_dir / "librsfd_native.so"
    so.write_bytes(whole[:64])  # the ELF header alone: what a build writes first
    monkeypatch.setattr(jnative, "_NATIVE_DIR", str(native_dir))
    monkeypatch.setattr(jnative, "_LIB_PATH", str(so))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_failed", False)
    assert jnative.load() is None and jnative._load_failed  # the memoized failure

    def finish():
        time.sleep(0.5)
        so.write_bytes(whole)

    writer = threading.Thread(target=finish)
    writer.start()
    try:
        lib = load_jax_native(monkeypatch, timeout_s=30.0)
    finally:
        writer.join()
    assert lib is not None and lib is jnative._lib and lib._name == str(so)
    assert lib.rsfd_abi_version() == JAX_NATIVE_ABI


@pytest.fixture(scope="module")
def frames():
    with np.load(os.path.join(FIXTURES, "ap_eval_set.npz")) as d:
        ap = d["images"][:6]
    with np.load(os.path.join(FIXTURES, "golden_trained_scene.npz")) as g:
        scene = g["image"]
    rng = np.random.default_rng(0)
    odd = rng.integers(0, 256, size=(96, 80, 3), dtype=np.uint8)
    return [scene, *ap, odd]


@pytest.fixture(scope="module")
def pair():
    return load_trained_detector(TRAINED, CFG), _port(CFG, TRAINED)


@pytest.mark.parametrize("nms_mode", ["fixpoint", "pallas"])
def test_host_call_matches_jax(frames, nms_mode):
    ref = load_trained_detector(TRAINED, CFG)
    ref = JDetection(CFG, model=ref.model, variables=ref.variables, nms_mode=nms_mode)
    port = _port(CFG, TRAINED)
    for img in frames:
        _assert_same(*port(img), *ref(img))


def test_batched_matches_jax(pair, frames):
    ref, port = pair
    imgs = np.stack([f for f in frames if f.shape[:2] == (64, 64)])
    scales = np.linspace(0.5, 1.5, len(imgs)).astype(np.float32)
    want = ref.make_batched_fn()(ref.variables, jnp.asarray(imgs), jnp.asarray(scales))
    got = port.detect_batch(imgs, scales)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    for i, n in enumerate(np.asarray(want.count)):
        _assert_same(got.det[i, :n], got.kps[i, :n], want.det[i, :n], want.kps[i, :n])


def test_detect_padded_matches_jax(pair, frames):
    ref, port = pair
    got, want = port.detect_padded(frames[-1]), ref.detect_padded(frames[-1])
    assert int(got.count) == int(want.count)
    assert got.det.shape == want.det.shape and got.kps.shape == want.kps.shape


def test_golden_detect_v1():
    cfg = FaceDetectionConfig(
        image_size=(64, 64), confidence_threshold=0.3, max_candidates=64, max_detections=16
    )
    _, variables = init_retinaface("mobilenet025", cfg.image_size, seed=0)
    img = np.random.default_rng(42).integers(0, 255, size=(96, 80, 3), dtype=np.uint8)
    boxes, kps = _port(cfg, variables)(img)
    with np.load(os.path.join(FIXTURES, "golden_detect_v1.npz")) as expected:
        assert boxes.shape == expected["boxes"].shape
        np.testing.assert_allclose(boxes, expected["boxes"], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(kps, expected["kps"], rtol=1e-4, atol=1e-3)


def test_golden_trained_scene():
    with np.load(os.path.join(FIXTURES, "golden_trained_scene.npz")) as g:
        image, want_boxes, want_kps = g["image"], g["det_boxes"], g["det_kps"]
    boxes, kps = _port(CFG, TRAINED)(image)
    assert boxes.shape == want_boxes.shape
    np.testing.assert_allclose(boxes, want_boxes, rtol=1e-3, atol=5e-2)
    np.testing.assert_allclose(kps, want_kps, rtol=1e-3, atol=5e-2)


def test_tail_stable_top_k_with_ties():
    """More above-threshold anchors than max_candidates, with exact score
    ties: the top-k must keep ties in index order, as jax.lax.top_k does."""
    cfg = FaceDetectionConfig(
        image_size=(96, 96), confidence_threshold=0.5, max_candidates=128, max_detections=20
    )
    anchors, level_info = full_anchor_table(cfg.image_size, RPN_ANCHOR_CFG)
    assert anchors.shape[0] > cfg.max_candidates
    rng = np.random.default_rng(11)
    b = 3
    net_out = {}
    for stride, fh, fw, a in level_info:
        score = rng.choice(np.float32([0.2, 0.6, 0.75, 0.9]), size=(b, fh, fw, a))
        net_out[stride] = {
            "score": score.astype(np.float32),
            "bbox": rng.normal(0, 0.3, size=(b, fh, fw, a * 4)).astype(np.float32),
            "landmark": rng.normal(0, 0.5, size=(b, fh, fw, a * 10)).astype(np.float32),
        }
    assert sum((v["score"][0] >= 0.5).sum() for v in net_out.values()) > cfg.max_candidates
    port_out = {s: {k: torch.from_numpy(v) for k, v in d.items()} for s, d in net_out.items()}
    got = detection.nms_and_compact(
        detection.select_candidates(port_out, torch.from_numpy(anchors), level_info, cfg), cfg
    )
    for i in range(b):
        single = {s: {k: jnp.asarray(v[i]) for k, v in d.items()} for s, d in net_out.items()}
        want = topk_decode_and_nms(single, jnp.asarray(anchors), level_info, cfg, "fixpoint")
        n = int(want.count)
        assert int(got.count[i]) == n
        _assert_same(got.det[i, :n], got.kps[i, :n], want.det[:n], want.kps[:n])


def test_cuda_device_refused_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetinaFaceDetection(CFG, device="cuda")
