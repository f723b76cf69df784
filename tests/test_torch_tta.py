"""The port's TTA (pipeline/tta.py) against the JAX package's.

  - ``flip_detections`` and ``bbox_vote`` are numpy copies: equal to JAX bit
    for bit on seeded inputs, degenerate boxes included;
  - ``TTADetection`` on ``trained_real64.npz`` and ``real_face.jpg`` (a
    portrait, so its letterbox scale at 64 and 96 is exact and the JAX
    code's fault F1 below does not touch it) equals JAX's within 1e-3 px and
    1e-5 in score, in both merge modes, flip-only and at two sizes: each view
    is letterboxed on the device with OpenCV's uint8 arithmetic (bit for bit
    the JAX host letterbox), and the networks sum in other orders;
  - the JAX package's own TTA properties hold for the port: the fixture face
    re-found (IoU >= 0.5 against single-scale), mirror invariance within
    1 px, the scale filter's partition, the NMS merge;
  - F1: JAX measures every view's zoom against the analytic scale
    ``min(base_w / width, base_h / height)``, while each view's scale is the
    truncated ``letterbox_geometry`` one.  On a 101x75 frame at 64 px the
    base view's zoom falls to 0.98897, and JAX's shrunk-view filter drops
    the base view's small face; the port measures zoom against the base
    view's own scale and keeps it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from rs_face_detection_tpu.pipeline import tta as jtta
from rs_face_detection_tpu.pipeline.detection import RetinaFaceDetection as JRetinaFaceDetection
from rs_face_detection_tpu.utils.fixtures import load_trained_detector as jload
from rs_face_detection_tpu_torch.pipeline import tta as ptta
from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
from rs_face_detection_tpu_torch.utils.fixtures import load_trained_detector
from test_torch_detection import _assert_same

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CKPT = os.path.join(FIXTURES, "trained_real64.npz")
JPG = os.path.join(FIXTURES, "real_face.jpg")


def _rows(rng, n, width=100):
    x1 = rng.integers(0, 50, n).astype(np.float32)
    y1 = rng.integers(0, 50, n).astype(np.float32)
    w = rng.integers(4, 40, n).astype(np.float32)
    score = (rng.integers(1, 5, n) / 4).astype(np.float32)  # ties
    return np.stack([x1, y1, x1 + w, y1 + w, score], 1), rng.uniform(0, width - 1, (n, 5, 2)).astype(np.float32)


def test_flip_and_vote_equal_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 20):
        dets, kps = _rows(rng, n)
        for a, b in zip(ptta.flip_detections(dets, kps, 100), jtta.flip_detections(dets, kps, 100)):
            np.testing.assert_array_equal(a, b)
        for thr in (0.2, 0.4):
            for k in (kps, None):
                got, want = ptta.bbox_vote(dets, k, thr), jtta.bbox_vote(dets, k, thr)
                np.testing.assert_array_equal(got[0], want[0])
                assert (got[1] is None) == (want[1] is None)
                if want[1] is not None:
                    np.testing.assert_array_equal(got[1], want[1])
    degenerate = np.array([[10, 10, 9, 9, 0.9], [np.nan, 0, 5, 5, 0.8], [20, 20, 40, 40, 0.5]], np.float32)
    np.testing.assert_array_equal(ptta.bbox_vote(degenerate)[0], jtta.bbox_vote(degenerate)[0])


@pytest.fixture(scope="module")
def detectors():
    """{size: (port, JAX)} fixture detectors at 64 and 96 sharing one module."""
    port64, jax64 = load_trained_detector(CKPT, device="cpu"), jload(CKPT)
    port96 = RetinaFaceDetection(dataclasses.replace(port64.cfg, image_size=(96, 96)), port64.model, "cpu")
    jax96 = JRetinaFaceDetection(
        dataclasses.replace(jax64.cfg, image_size=(96, 96)), model=jax64.model, variables=jax64.variables
    )
    return {64: (port64, jax64), 96: (port96, jax96)}


@pytest.fixture(scope="module")
def image():
    img = cv2.imread(JPG)
    assert img.shape == (600, 512, 3)  # portrait: the letterbox scale is exact at 64 and 96
    return img


@pytest.mark.parametrize(
    "sizes,flip,merge",
    [((64,), True, "nms"), ((64,), True, "vote"), ((64, 96), False, "nms"), ((64, 96), True, "nms"),
     ((64, 96), True, "vote")],
)
def test_tta_equals_jax(detectors, image, sizes, flip, merge):
    port = ptta.TTADetection([detectors[s][0] for s in sizes], flip=flip, merge=merge)
    ref = jtta.TTADetection([detectors[s][1] for s in sizes], flip=flip, merge=merge)
    for img in (image, np.ascontiguousarray(image[:, ::-1])):
        got, want = port(img), ref(img)
        assert len(want[0]) >= 1
        _assert_same(*got, *want)


def test_tta_refinds_the_face_and_is_mirror_invariant(detectors, image):
    det = detectors[64][0]
    tta = ptta.TTADetection([det], flip=True, merge="vote")
    boxes, kps = tta(image)
    assert boxes.shape[0] >= 1 and kps.shape == (boxes.shape[0], 5, 2)
    ref_boxes, _ = det(image)
    a, b = boxes[0], ref_boxes[0]
    inter = max(0.0, min(a[2], b[2]) - max(a[0], b[0]) + 1) * max(0.0, min(a[3], b[3]) - max(a[1], b[1]) + 1)
    area = lambda r: (r[2] - r[0] + 1) * (r[3] - r[1] + 1)  # noqa: E731
    assert inter / (area(a) + area(b) - inter) >= 0.5
    mboxes, mkps = tta(np.ascontiguousarray(image[:, ::-1]))
    ub, _ = ptta.flip_detections(mboxes, mkps, image.shape[1])
    assert ub.shape == boxes.shape
    np.testing.assert_allclose(
        ub[np.argsort(-ub[:, 4], kind="stable")], boxes[np.argsort(-boxes[:, 4], kind="stable")], atol=1.0
    )


class Fake:
    """A detector that reports fixed rows in its own letterboxed frame,
    scaled by size / 64 (a fully convolutional detector seeing the same
    faces at every scale)."""

    device = torch.device("cpu")

    def __init__(self, size, rows):
        self.image_size = (size, size)
        self.rows = np.asarray(rows, np.float32)
        self.z = size / 64.0

    def __call__(self, img):
        assert tuple(img.shape[:2]) == self.image_size[::-1]
        d = self.rows.copy()
        d[:, :4] *= self.z
        return d, np.zeros((len(d), 5, 2), np.float32)


def test_scale_filter_and_nms_merge():
    def scores(tta, img):
        return {round(float(s), 2) for s in tta(img)[0][:, 4]}

    img = np.zeros((64, 64, 3), np.uint8)
    faces = lambda s: [[0, 0, 40, 40, s], [20, 20, 30, 30, s - 0.5]]  # noqa: E731
    base, zoom_in, zoom_out = Fake(64, faces(0.9)), Fake(128, faces(0.95)), Fake(32, faces(0.95))
    assert scores(ptta.TTADetection([base, zoom_in], flip=False), img) == {0.9, 0.45}
    assert scores(ptta.TTADetection([base, zoom_in], flip=False, scale_filter=False), img) == {0.95, 0.45}
    assert scores(ptta.TTADetection([base, zoom_out], flip=False, large_faces_cut=0.25), img) == {0.95, 0.4}
    assert ptta.TTADetection([base], flip=False)(img)[0].shape[0] == 2
    dup = Fake(64, [[10, 10, 50, 50, 0.9], [12, 12, 52, 52, 0.6]])
    boxes, _ = ptta.TTADetection([dup], flip=False, merge_iou=0.4)(img)
    assert boxes.shape[0] == 1 and boxes[0, 4] == pytest.approx(0.9)
    with pytest.raises(ValueError, match="merge"):
        ptta.TTADetection([dup], merge="average")
    with pytest.raises(ValueError, match="at least one detector"):
        ptta.TTADetection([])


def test_f1_the_base_view_keeps_its_small_face():
    """101x75 at 64: the letterbox is 64x47, scale 47/75 = 0.62667, while
    JAX's analytic base scale is 64/101 = 0.63366.  A 3-px face in the view
    (4.79 px in the frame, 3.03 px in JAX's base frame) is under the
    shrunk-view cut of 0.0625 * 64 = 4 px: JAX drops it from its own base
    view; the port keeps it, as single-scale detection does."""
    img = np.zeros((75, 101, 3), np.uint8)
    rows = [[10, 10, 13, 13, 0.9], [30, 5, 60, 40, 0.8]]
    jfake = Fake(64, rows)
    want = jtta.TTADetection([jfake], flip=False)(img)[0]
    got = ptta.TTADetection([jfake], flip=False)(img)[0]
    assert want.shape[0] == 1 and want[0, 4] == pytest.approx(0.8)  # JAX lost the small face
    np.testing.assert_allclose(got, np.asarray(rows, np.float32) / np.float32([47 / 75] * 4 + [1]), rtol=1e-6)
