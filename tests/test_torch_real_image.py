"""The port's detector on the real photograph (tests/fixtures/real_face.jpg)
with the bridged 64-px trained checkpoint, under the checks of
tests/test_real_image.py: the face re-found (IoU >= 0.5 with the fixture's
face box) and the golden detections matched (rtol 1e-3, atol 0.5).  It also
holds the port within 1e-3 px of the JAX detector on the same bytes."""

import os

import numpy as np
import torch

from rs_face_detection_tpu.configs import FaceDetectionConfig as JFaceDetectionConfig
from rs_face_detection_tpu.utils.fixtures import load_trained_detector
from rs_face_detection_tpu.utils.image_io import decode_image_bytes as j_decode
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
from rs_face_detection_tpu_torch.utils.image_io import decode_image_bytes

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SETTINGS = dict(image_size=(64, 64), confidence_threshold=0.3, max_candidates=64, max_detections=8)


def _iou(boxes, box):
    """'+1' IoU of (N, 4) boxes with one box, the detector's convention."""
    ix1, iy1 = np.maximum(boxes[:, 0], box[0]), np.maximum(boxes[:, 1], box[1])
    ix2, iy2 = np.minimum(boxes[:, 2], box[2]), np.minimum(boxes[:, 3], box[3])
    inter = np.clip(ix2 - ix1 + 1, 0, None) * np.clip(iy2 - iy1 + 1, 0, None)
    area = lambda b: (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)  # noqa: E731
    return inter / (area(boxes) + area(box) - inter)


def test_port_finds_the_real_face_and_matches_the_golden():
    ckpt = os.path.join(FIXTURES, "trained_real64.npz")
    data = open(os.path.join(FIXTURES, "real_face.jpg"), "rb").read()
    family = "retinaface_mobilenet025"
    det = RetinaFaceDetection(
        FaceDetectionConfig(**SETTINGS),
        weights.load_model(family, weights.state_dict_from_jax(family, ckpt)),
        device="cpu",
    )
    img = decode_image_bytes(data)
    np.testing.assert_array_equal(img, j_decode(data))
    boxes, kps = det(img)
    with np.load(os.path.join(FIXTURES, "golden_real_face.npz")) as gold:
        assert len(boxes) >= 1
        assert _iou(boxes[:, :4], gold["face_box"]).max() >= 0.5
        np.testing.assert_allclose(boxes, gold["det_boxes"], rtol=1e-3, atol=0.5)
        np.testing.assert_allclose(kps, gold["det_kps"], rtol=1e-3, atol=0.5)
    ref_boxes, ref_kps = load_trained_detector(ckpt, JFaceDetectionConfig(**SETTINGS))(img)
    assert boxes.shape == np.asarray(ref_boxes).shape
    np.testing.assert_allclose(boxes[:, :4], np.asarray(ref_boxes)[:, :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(boxes[:, 4], np.asarray(ref_boxes)[:, 4], atol=1e-5, rtol=0)
    np.testing.assert_allclose(kps, np.asarray(ref_kps), atol=1e-3, rtol=0)
