"""The port's native host entry points (runtime/native.py: ``nms``,
``decode_letterbox``, ``ensure_built``) against the JAX package's on the same
inputs: ports of tests/test_native.py.

- ``nms`` on JAX's 200 random boxes (4 seeds x 3 thresholds) equals the
  port's ``ops/nms.py::nms_numpy`` and JAX's ``native.nms``; JAX's golden
  keep list [2, 1, 0]; a shape other than (N, 5) raises ValueError;
- ``decode_letterbox`` on JAX's 320x200 JPEG: the pad is zero, the scale is
  exact, the pixels are within mean 2 / p99 6 of the port's cv2 letterbox
  (``parallel/data.py::letterbox_host``; decoders differ by a few LSBs), and
  the canvas is equal to JAX's ``decode_letterbox`` on the same bytes and to
  its row of the port's ``decode_letterbox_batch``; a bad JPEG raises
  ValueError;
- ``ensure_built`` returns the path of the library ``load`` maps, and
  rebuilds it under the same name when forced;
- without the library, ``nms`` and ``decode_letterbox`` raise RuntimeError
  with the reason, and ``load`` returns None.

JAX's library is reached through tests/test_torch_detection.py::
load_jax_native (a load racing another process's build).
"""

import os

import numpy as np
import pytest

from rs_face_detection_tpu_torch.ops.nms import nms_numpy
from rs_face_detection_tpu_torch.runtime import native

cv2 = pytest.importorskip("cv2")

pytestmark = pytest.mark.skipif(not native.available(), reason=f"native library: {native.unavailable_reason()}")


@pytest.fixture
def jax_native(monkeypatch):
    from rs_face_detection_tpu.runtime import native as jnative
    from test_torch_detection import load_jax_native

    load_jax_native(monkeypatch)
    return jnative


def _random_dets(seed, n=200):
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(0, 500, size=(n, 2)).astype(np.float32)
    wh = rng.uniform(5, 150, size=(n, 2)).astype(np.float32)
    return np.concatenate([ctr - wh / 2, ctr + wh / 2, rng.uniform(0, 1, (n, 1)).astype(np.float32)], axis=1)


def _jpeg(rng, h, w):
    img = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
    return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_native_nms_matches_oracle(seed, jax_native):
    dets = _random_dets(seed)
    for thresh in (0.3, 0.45, 0.6):
        keep = native.nms(dets, thresh)
        assert keep == nms_numpy(dets, thresh)
        assert keep == jax_native.nms(dets, thresh)
        assert len(keep) > 1


def test_native_nms_golden(jax_native):
    dets = np.array(
        [
            [100.0, 100.0, 210.0, 210.0, 0.72],
            [250.0, 250.0, 420.0, 420.0, 0.8],
            [220.0, 220.0, 320.0, 330.0, 0.92],
            [100.0, 100.0, 210.0, 210.0, 0.6],
        ],
        dtype=np.float32,
    )
    assert native.nms(dets, 0.4) == [2, 1, 0] == jax_native.nms(dets, 0.4)
    assert native.nms(dets[:0], 0.4) == []


@pytest.mark.parametrize("shape", [(8, 4), (8, 6), (5,), (2, 8, 5)])
def test_native_nms_refuses_other_shapes(shape):
    with pytest.raises(ValueError, match=r"\(N, 5\)"):
        native.nms(np.zeros(shape, np.float32), 0.4)


def test_native_decode_letterbox_matches_host(jax_native):
    from rs_face_detection_tpu_torch.parallel.data import letterbox_host

    rng = np.random.default_rng(0)
    payload = _jpeg(rng, 200, 320)
    out, scale = native.decode_letterbox(payload, 640, 640)
    assert out.shape == (640, 640, 3) and out.dtype == np.uint8
    new_h = int(640 * 200 / 320)
    assert scale == pytest.approx(new_h / 200)
    assert (out[new_h:, :] == 0).all()

    decoded = cv2.imdecode(np.frombuffer(payload, np.uint8), cv2.IMREAD_UNCHANGED)
    expected, escale = letterbox_host(decoded, 640, 640)
    assert escale == pytest.approx(scale)
    diff = np.abs(out.astype(int) - expected.astype(int))
    assert np.mean(diff) < 2.0
    assert np.percentile(diff, 99) <= 6

    jout, jscale = jax_native.decode_letterbox(payload, 640, 640)
    np.testing.assert_array_equal(out, jout)
    assert scale == jscale

    payloads = [_jpeg(rng, 120, 160), payload, _jpeg(rng, 90, 300)]
    imgs, scales, ok = native.decode_letterbox_batch(payloads, 640, 640, num_threads=2)
    assert ok.all()
    for i, p in enumerate(payloads):
        single, s = native.decode_letterbox(p, 640, 640)
        np.testing.assert_array_equal(imgs[i], single)
        assert scales[i] == np.float32(s)


def test_native_decode_garbage_raises(jax_native):
    with pytest.raises(ValueError, match="decode failed"):
        native.decode_letterbox(b"garbage", 64, 64)
    with pytest.raises(ValueError):
        jax_native.decode_letterbox(b"garbage", 64, 64)


def test_ensure_built_returns_the_loaded_library():
    path = native.ensure_built()
    assert path == str(native.library_path()) and os.path.samefile(path, native.load()._name)
    before = os.stat(path).st_ino
    assert native.ensure_built(force=True) == path
    assert os.stat(path).st_ino != before, "force did not rebuild"
    assert native.nms(_random_dets(0), 0.45) == nms_numpy(_random_dets(0), 0.45)


def test_entry_points_raise_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", "g++ failed on rsfd_native.cc")
    assert native.load() is None and not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.nms(_random_dets(0), 0.45)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.decode_letterbox(b"garbage", 64, 64)
