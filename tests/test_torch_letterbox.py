"""The port's uint8 letterbox against the JAX batch path's host letterbox.

rs_face_detection_tpu/parallel/serving.py::letterbox_host resizes with
OpenCV's INTER_LINEAR on uint8 (11-bit fixed-point weights, OpenCV's
rounding, an exact 2x downscale as a 2x2 area mean).  The port's
ops/image.py::letterbox_u8 (and letterbox_u8_batch, which the batched
paths call) reproduces it in torch integer ops; required: equal canvases,
bit for bit, and equal det_scale, on up- and downscales, exact 2x and 3x,
and 1xN / Nx1 images.
"""

import numpy as np
import pytest
import torch

from rs_face_detection_tpu.parallel.serving import cv2, letterbox_host
from rs_face_detection_tpu_torch.ops.image import letterbox_u8, letterbox_u8_batch, resize_u8_linear

torch.set_num_threads(2)

_RNG = np.random.default_rng(20)
#: (src_h, src_w): fixed corner cases, then random sizes (up and down).
SIZES = [
    (1, 1), (1, 37), (37, 1), (1, 900), (900, 1), (2, 2), (3, 213), (480, 640),
    (720, 1280), (1080, 1920), (99, 97), (300, 200), (1280, 1280), (1920, 640),
    *[tuple(int(v) for v in _RNG.integers(1, 1000, 2)) for _ in range(12)],
]


def _image(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.fixture(autouse=True)
def _needs_cv2():
    # letterbox_host falls back to PIL without cv2, which is not OpenCV's
    # resize; the comparison is against OpenCV.
    assert cv2 is not None, "OpenCV is the reference of these tests"


@pytest.mark.parametrize("dst", [(640, 640), (64, 64), (96, 80)])
def test_letterbox_u8_equals_letterbox_host(dst):
    for i, (h, w) in enumerate(SIZES):
        img = _image(h, w, i)
        want, want_scale = letterbox_host(img, *dst)
        got, got_scale = letterbox_u8(torch.from_numpy(img), *dst)
        assert got.dtype == torch.uint8 and got_scale == want_scale
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{(h, w)} -> {dst}")


@pytest.mark.parametrize(
    "src, dst",
    [
        ((128, 96), (64, 48)),  # exact 2x: OpenCV's 2x2 area mean
        ((1280, 1920), (640, 960)),
        ((192, 96), (64, 32)),  # exact 3x
        ((128, 96), (64, 32)),  # 2x rows, 3x columns
        ((128, 96), (43, 48)),  # 2x columns only
        ((7, 9), (14, 27)),  # exact 2x and 3x upscales
        ((1, 37), (2, 96)),
        ((37, 1), (96, 2)),
    ],
)
def test_resize_u8_linear_equals_cv2(src, dst):
    img = _image(*src, 7)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = resize_u8_linear(torch.from_numpy(img), *dst).numpy()
    np.testing.assert_array_equal(got, want.reshape(got.shape))


def test_letterbox_u8_batch_equals_letterbox_host():
    """Mixed sizes, numpy arrays and tensors, in one batch: each slot is its
    frame's letterbox_host canvas, padding included."""
    images = [_image(h, w, 30 + i) for i, (h, w) in enumerate(SIZES[6:12])]
    payloads = [torch.from_numpy(im) if i % 2 else im for i, im in enumerate(images)]
    got, got_scales = letterbox_u8_batch(payloads, 96, 80, torch.device("cpu"))
    assert got.shape == (len(images), 80, 96, 3) and got.dtype == torch.uint8
    for i, img in enumerate(images):
        want, want_scale = letterbox_host(img, 96, 80)
        assert got_scales[i] == want_scale
        np.testing.assert_array_equal(got[i].numpy(), want, err_msg=f"{img.shape}")


def test_repeated_sizes_reuse_their_taps_and_stay_equal_to_cv2():
    """The taps of each pair of sizes are uploaded once and reused: new
    frames of a size seen before, between frames of other sizes, still
    resize as cv2 does, and the cached taps are the ones made first."""
    from rs_face_detection_tpu_torch.ops.image import _linear_taps
    from rs_face_detection_tpu_torch.utils.device import device_arrays

    cpu = torch.device("cpu")
    first = device_arrays(_linear_taps, (1280, 640, True), cpu)
    for i, (src, dst) in enumerate([((720, 1280), (360, 640)), ((480, 640), (480, 640)), ((37, 99), (64, 21))] * 3):
        img = _image(*src, 50 + i)
        want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(resize_u8_linear(torch.from_numpy(img), *dst).numpy(), want.reshape(*dst, 3))
    again = device_arrays(_linear_taps, (1280, 640, True), cpu)
    assert all(a is b for a, b in zip(first, again))
    for cached, fresh in zip(again, _linear_taps(1280, 640, True)):
        np.testing.assert_array_equal(cached.numpy(), fresh)


def test_identity_size_is_a_copy():
    img = torch.from_numpy(_image(64, 64, 3))
    canvas, scale = letterbox_u8(img, 64, 64)
    assert scale == 1.0 and torch.equal(canvas, img) and canvas.data_ptr() != img.data_ptr()
