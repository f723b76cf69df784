"""The batch decode on host threads (utils/image_io.py::decode_images).

Over a mixed batch (640x480 and 1280x720 JPEGs, a PNG with alpha, a
grayscale PNG, arrays among the bytes) the pool gives the serial decode's
arrays, bit for bit and in order, and ``FacePipeline.extract_batch`` on
bytes answers as on the same images decoded beforehand.  An undecodable
payload raises as the serial decode does, the first in payload order;
behind a ``DynamicBatcher`` only its request fails.  Fewer than two byte
payloads decode on the calling thread.  Many callers share the pool at once
and a forked child builds its own.
"""

import multiprocessing
import os
import sys
import threading
import time

import numpy as np
import pytest

from rs_face_detection_tpu_torch.runtime.batcher import DynamicBatcher
from rs_face_detection_tpu_torch.utils import image_io, tracing
from rs_face_detection_tpu_torch.utils.image_io import decode_image_bytes, decode_images, decode_workers
from deadlines import RPC_S, in_threads
from test_torch_tracing import encoded_frames, make_pipeline, profiled, same_results

cv2 = pytest.importorskip("cv2")


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
    return np.clip(ramp + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def _encode(ext, img, *params):
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok
    return buf.tobytes()


@pytest.fixture(scope="module")
def mixed():
    bgra = np.concatenate([_scene(120, 160, 3), np.full((120, 160, 1), 128, np.uint8)], axis=2)
    return [
        _encode(".jpg", _scene(480, 640, 1), cv2.IMWRITE_JPEG_QUALITY, 90),
        _scene(64, 64, 5),
        _encode(".jpg", _scene(720, 1280, 2), cv2.IMWRITE_JPEG_QUALITY, 90),
        _encode(".png", bgra),
        bytearray(_encode(".png", _scene(90, 70, 4)[:, :, 0])),
        _scene(32, 48, 6),
        _encode(".jpg", _scene(480, 640, 7), cv2.IMWRITE_JPEG_QUALITY, 75),
    ]


@pytest.fixture(scope="module")
def pipe():
    return make_pipeline("cpu")[0]


@pytest.fixture(scope="module")
def payloads():
    return encoded_frames()


def test_pooled_decode_equals_the_serial_decode_in_order(mixed):
    got = decode_images(mixed)
    assert len(got) == len(mixed)
    for payload, image in zip(mixed, got):
        if isinstance(payload, np.ndarray):
            assert image is payload
        else:
            want = decode_image_bytes(payload)
            assert image.dtype == np.uint8 and image.shape == want.shape and image.shape[2] == 3
            np.testing.assert_array_equal(image, want)
    assert decode_workers(mixed) == min(5, len(os.sched_getaffinity(0)))


def test_extract_batch_on_bytes_answers_as_on_decoded_arrays(pipe, payloads):
    six = payloads[:6]
    assert len(six) == 6
    same_results(pipe.extract_batch(six), pipe.extract_batch([decode_image_bytes(p) for p in six]))


def test_a_bad_payload_raises_as_the_serial_decode_does(mixed):
    batch = [mixed[0], mixed[2], b"not an image", mixed[3], mixed[6]]
    with pytest.raises(ValueError, match="could not decode image bytes"):
        [decode_image_bytes(p) for p in batch]
    with pytest.raises(ValueError, match="could not decode image bytes"):
        decode_images(batch)


def test_the_first_bad_payload_in_order_raises(monkeypatch):
    """The earlier bad payload raises even when a later one fails first."""

    def decode(p):
        if p.startswith(b"bad"):
            time.sleep(0.2 if p == b"bad-first" else 0.0)
            raise ValueError(p.decode())
        return np.zeros((2, 2, 3), np.uint8)

    monkeypatch.setattr(image_io, "decode_image_bytes", decode)
    with pytest.raises(ValueError, match="^bad-first$"):
        decode_images([b"ok", b"bad-first", b"ok", b"bad-second", b"ok"])


def test_only_the_bad_request_fails_behind_the_batcher(pipe, payloads):
    batch = [payloads[0], payloads[1], b"not an image", payloads[2], payloads[3]]
    with DynamicBatcher(batch_fn=pipe.extract_batch, batch_size=8, max_delay_ms=500.0) as batcher:
        futures = [batcher.submit(p) for p in batch]
        done = [f.exception(RPC_S) for f in futures]
        stats = batcher.stats()
    assert isinstance(done[2], ValueError)
    assert [e is None for e in done] == [True, True, False, True, True]
    # one batch of five, then each request alone
    good = [f.result(RPC_S) for i, f in enumerate(futures) if i != 2]
    same_results(good, [pipe.extract_batch([p])[0] for i, p in enumerate(batch) if i != 2])
    assert stats["batch_size_counts"] == {"5": 1} and stats["requests"] == 5


def test_one_byte_payload_decodes_on_the_calling_thread(monkeypatch, mixed, pipe, payloads):
    threads = []

    def decode(p):
        threads.append(threading.current_thread().name)
        return decode_image_bytes(p)

    monkeypatch.setattr(image_io, "decode_image_bytes", decode)
    image = mixed[1]
    got = decode_images([mixed[0], image])
    assert threads == [threading.current_thread().name] and got[1] is image
    assert decode_workers([mixed[0], image]) == 0
    threads.clear()
    decode_images([mixed[0], mixed[2]])
    assert len(threads) == 2 and all(t.startswith("rsfd-decode") for t in threads)

    with profiled():
        pipe.extract_batch(payloads[:1])
    (top,) = tracing.read().named("pipeline.extract_batch")
    (decode_span,) = tracing.read().named("pipeline.decode")
    assert top.counts == {"decode_pooled": 0} and decode_span.attrs == {"workers": 0}


def test_callers_share_the_pool():
    """More calling threads than cores, a short switch interval: every call
    gets its own payloads back, in order."""
    small = [_encode(".jpg", _scene(24, 32, s)) for s in range(8)]
    want = [decode_image_bytes(p) for p in small]
    callers, each = 4 * (os.cpu_count() or 1), 10
    wrong = []

    def work(k):
        for j in range(each):
            order = [(k + j + i) % len(small) for i in range(2 + (k + j) % 5)]
            for i, image in zip(order, decode_images([small[i] for i in order])):
                if not np.array_equal(image, want[i]):
                    wrong.append((k, j, i))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        in_threads(work, callers, "decoding")
    finally:
        sys.setswitchinterval(old)
    assert wrong == []


def _decode_in_child(payloads, want):
    got = decode_images(payloads)
    sys.exit(0 if all(np.array_equal(a, b) for a, b in zip(got, want)) else 1)


def test_a_forked_child_builds_its_own_pool(mixed):
    decode_images(mixed)  # the parent's pool has threads
    want = [decode_image_bytes(p) if not isinstance(p, np.ndarray) else p for p in mixed]
    child = multiprocessing.get_context("fork").Process(target=_decode_in_child, args=(mixed, want))
    child.start()
    child.join(RPC_S)
    if child.is_alive():
        child.kill()
    assert child.exitcode == 0
