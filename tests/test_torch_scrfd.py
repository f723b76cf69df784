"""SCRFD: the port's anchor centers, distance decoders, network and
detector against the JAX package on the same bridged weights (width 8 at
96 px).

Maps within 1e-4 (f32 sums in another order; GroupNorm's variance formula
differs); detections: equal counts, boxes and landmarks within 1e-3 px,
scores within 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models.scrfd import init_scrfd
from rs_face_detection_tpu.ops.box_decode import distance2bbox as j_distance2bbox
from rs_face_detection_tpu.ops.box_decode import distance2kps as j_distance2kps
from rs_face_detection_tpu.pipeline.ekyc_pipeline import SCRFDDetection as JSCRFDDetection
from rs_face_detection_tpu.pipeline.ekyc_pipeline import scrfd_anchor_centers as j_centers
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.ops.anchors import scrfd_anchor_centers
from rs_face_detection_tpu_torch.ops.box_decode import distance2bbox, distance2kps
from rs_face_detection_tpu_torch.ops.image import letterbox_u8_batch
from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import SCRFDDetection

torch.set_num_threads(2)

SIZE = 96
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(scope="module")
def pair():
    model, variables = init_scrfd((SIZE, SIZE), width=8, seed=0)
    variables = jax.tree.map(np.asarray, variables)
    port = weights.load_model("scrfd", weights.state_dict_from_jax("scrfd", variables))
    ref = JSCRFDDetection(model=model, variables=variables, image_size=(SIZE, SIZE), registry=None)
    det = SCRFDDetection(model=port, device="cpu", image_size=(SIZE, SIZE))
    return model, variables, ref, det


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    face = np.load(os.path.join(FIXTURES, "real_face_crop.npz"))["face"]
    rows = (np.arange(130) * face.shape[0]) // 130
    cols = (np.arange(150) * face.shape[1]) // 150
    return [
        rng.integers(0, 255, size=(120, 100, 3), dtype=np.uint8),
        np.ascontiguousarray(face[rows][:, cols]),
        np.full((80, 90, 3), 128, np.uint8),
        rng.integers(0, 255, size=(SIZE, SIZE, 3), dtype=np.uint8),
    ]


@pytest.mark.parametrize("size", [(96, 96), (640, 640), (100, 72)])
def test_anchor_centers_equal_jax(size):
    got, got_levels = scrfd_anchor_centers(size)
    want, want_levels = j_centers(size)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    assert [tuple(l) for l in got_levels] == [tuple(l) for l in want_levels]


def test_distance_decoders_equal_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 640, size=(50, 2)).astype(np.float32)
    dist = rng.uniform(-5, 80, size=(50, 4)).astype(np.float32)
    kd = rng.uniform(-40, 40, size=(50, 5, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        distance2bbox(torch.from_numpy(pts), torch.from_numpy(dist)).numpy(),
        np.asarray(j_distance2bbox(jnp.asarray(pts), jnp.asarray(dist))),
    )
    np.testing.assert_array_equal(
        distance2kps(torch.from_numpy(pts), torch.from_numpy(kd)).numpy(),
        np.asarray(j_distance2kps(jnp.asarray(pts), jnp.asarray(kd))),
    )
    # Leading batch dimensions broadcast against one center table.
    batched = distance2bbox(torch.from_numpy(pts), torch.from_numpy(np.stack([dist, dist])))
    assert batched.shape == (2, 50, 4)


def test_bridge_reads_every_leaf(pair):
    _, variables, _, _ = pair
    assert weights.mapped_leaves("scrfd") == set(weights.flat_variables(variables))


def test_maps_match_flax(pair):
    model, variables, _, det = pair
    x = np.random.default_rng(2).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = det.model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    for stride in (8, 16, 32):
        for key in ("score", "bbox", "kps"):
            ref = np.asarray(want[stride][key])
            assert got[stride][key].shape == ref.shape
            np.testing.assert_allclose(got[stride][key].numpy(), ref, atol=1e-4, rtol=0)


def _same(got_det, got_kps, want_det, want_kps):
    assert got_det.shape == want_det.shape and got_kps.shape == want_kps.shape
    np.testing.assert_allclose(got_det[:, :4], want_det[:, :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_det[:, 4], want_det[:, 4], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_kps, want_kps, atol=1e-3, rtol=0)


def test_call_matches_jax(pair, images):
    _, _, ref, det = pair
    for img in images:
        got_det, got_kps = det(img)
        want_det, want_kps = ref(img)
        assert len(want_det) > 0  # the comparison covers the decode and NMS
        _same(got_det, got_kps, want_det, want_kps)


def test_detect_batch_matches_jax(pair, images):
    _, variables, ref, det = pair
    canvases, scales = letterbox_u8_batch(images, SIZE, SIZE, torch.device("cpu"))
    scales = np.asarray(scales, np.float32)
    out = det.detect_batch(canvases, torch.from_numpy(scales))
    want = ref.make_batched_fn(stem="xla")(variables, jnp.asarray(canvases.numpy()), jnp.asarray(scales))
    want_count = np.asarray(want.count)
    np.testing.assert_array_equal(out.count.numpy(), want_count)
    for i, n in enumerate(want_count):
        _same(out.det[i, :n].numpy(), out.kps[i, :n].numpy(), np.asarray(want.det[i, :n]), np.asarray(want.kps[i, :n]))


def test_no_candidate_gives_no_detection(pair, images):
    _, _, _, det = pair
    head = det.model.head.cls
    saved = head.bias.detach().clone()
    try:
        with torch.no_grad():
            head.bias.fill_(-1e3)
        got_det, got_kps = det(images[0])
    finally:
        with torch.no_grad():
            head.bias.copy_(saved)
    assert got_det.shape == (0, 5) and got_kps.shape == (0, 5, 2)
