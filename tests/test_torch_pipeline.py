"""The slice as a whole: the port's FacePipeline against the JAX FacePipeline.

Both run the trained 64-px detector (trained_mnet64.npz), a ResNet-18
quality head and an IResNet-18 embedding on the same bridged weights.  Most
frames are 64x64, where the letterbox is the identity; the real-resize test
feeds frames that the letterbox must down- or upscale, where the JAX batch
path resizes with OpenCV on uint8 (parallel/serving.py::letterbox_host) and
the port with its bit-exact counterpart (ops/image.py::letterbox_u8).
Required: equal face counts and quality classes, selected box within 1e-3
px, quality score within 1e-4, embedding cosine >= 0.9999.
"""

import os

import numpy as np
import pytest
import torch

from rs_face_detection_tpu.configs import (
    FaceDetectionConfig,
    FaceIdentificationConfig,
    FacePipelineConfig,
)
from rs_face_detection_tpu.models.arcface import init_arcface
from rs_face_detection_tpu.models.classifiers import init_resnet18_classifier
from rs_face_detection_tpu.models.registry import ModelRegistry, ModelSpec, _unflatten
from rs_face_detection_tpu.models.retinaface import init_retinaface
from rs_face_detection_tpu.pipeline.face_pipeline import FacePipeline as JFacePipeline
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.pipeline.face_pipeline import (
    FaceExtractionResult,
    FacePipeline,
)

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _config(confidence=0.3):
    return FacePipelineConfig(
        detection=FaceDetectionConfig(
            image_size=(64, 64),
            confidence_threshold=confidence,
            max_candidates=64,
            max_detections=8,
        ),
        identification=FaceIdentificationConfig(backbone="iresnet18"),
    )


@pytest.fixture(scope="module")
def variables():
    det_model, _ = init_retinaface("mobilenet025", (64, 64), seed=0)
    det_vars = _unflatten(weights.flat_variables(os.path.join(FIXTURES, "trained_mnet64.npz")))
    q_model, q_vars = init_resnet18_classifier(4, (112, 112), seed=1)
    e_model, e_vars = init_arcface("iresnet18", 512, (112, 112), seed=2)
    return {
        "face_detection_retina": ("retinaface_mobilenet025", det_model, det_vars),
        "face_quality": ("resnet18_classifier", q_model, q_vars),
        "face_identification": ("iresnet18", e_model, e_vars),
    }


def _pipelines(variables, confidence=0.3, process_on_no_face=False):
    reg = ModelRegistry()
    models = {}
    for name, (family, model, vs) in variables.items():
        reg.register(ModelSpec(name, (112, 112, 3), "test"), model, vs)
        models[name] = weights.load_model(family, weights.state_dict_from_jax(family, vs))
    cfg = _config(confidence)
    ref = JFacePipeline(cfg, registry=reg, process_on_no_face=process_on_no_face)
    port = FacePipeline(cfg, models=models, device="cpu", process_on_no_face=process_on_no_face)
    return ref, port


@pytest.fixture(scope="module")
def pipelines(variables):
    return _pipelines(variables)


@pytest.fixture(scope="module")
def frames():
    with np.load(os.path.join(FIXTURES, "golden_trained_scene.npz")) as g:
        scene = g["image"]
    with np.load(os.path.join(FIXTURES, "ap_eval_set.npz")) as d:
        ap = list(d["images"][:5])
    return [scene, *ap]


def _assert_same(got: FaceExtractionResult, want):
    assert got.face_count == want.face_count
    assert (got.selected_face_box is None) == (want.selected_face_box is None)
    if want.selected_face_box is not None:
        np.testing.assert_allclose(got.selected_face_box, want.selected_face_box, atol=1e-3)
    assert got.face_quality == want.face_quality
    assert (got.facial_feature is None) == (want.facial_feature is None)
    if want.facial_feature is not None:
        assert abs(got.quality_score - want.quality_score) <= 1e-4
        assert got.facial_feature.shape == want.facial_feature.shape == (512,)
        cos = float(np.dot(got.facial_feature, want.facial_feature))
        cos /= np.linalg.norm(got.facial_feature) * np.linalg.norm(want.facial_feature)
        assert cos >= 0.9999


def test_extract_image_matches_jax(pipelines, frames):
    ref, port = pipelines
    selected = 0
    for img in frames:
        got, want = port.extract_image(img), ref.extract_image(img)
        _assert_same(got, want)
        selected += want.facial_feature is not None
    assert selected >= 3  # the comparison covers the whole tail


def test_extract_bytes_matches_jax(pipelines, frames):
    cv2 = pytest.importorskip("cv2")
    ref, port = pipelines
    ok, buf = cv2.imencode(".png", frames[0])
    assert ok
    _assert_same(port.extract(buf.tobytes()), ref.extract(buf.tobytes()))


def test_extract_batch_matches_jax(pipelines, frames):
    ref, port = pipelines
    got, want = port.extract_batch(frames[:4]), ref.extract_batch(frames[:4])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_same(g, w)


def _resized(frames, h, w):
    cv2 = pytest.importorskip("cv2")
    return [cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR) for f in frames]


@pytest.mark.parametrize("hw", [(99, 97), (128, 128), (40, 52)])
def test_extract_batch_real_resize_matches_jax(pipelines, frames, hw):
    """Frames the batch letterbox must resize: 99x97 and 128x128 (exact 2x)
    are downscaled into the 64x64 detector, 40x52 is upscaled."""
    ref, port = pipelines
    batch = _resized(frames, *hw)
    got, want = port.extract_batch(batch), ref.extract_batch(batch)
    assert len(got) == len(want) == len(frames)
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert sum(w.facial_feature is not None for w in want) >= 2


def test_extract_batch_equals_single(pipelines, frames):
    _, port = pipelines
    for g, s in zip(port.extract_batch(frames), [port.extract_image(f) for f in frames]):
        _assert_same(g, s)


def test_no_face_compat_mode_matches_jax(variables, frames):
    ref, port = _pipelines(variables, confidence=1.1, process_on_no_face=True)
    got, want = port.extract_image(frames[1]), ref.extract_image(frames[1])
    assert got.face_count == 0 and got.facial_feature is not None
    _assert_same(got, want)
    _assert_same(port.extract_batch(frames[1:3])[1], ref.extract_batch(frames[1:3])[1])


def test_enroll_mode_selects_biggest(variables, frames):
    _, port = _pipelines(variables)
    port.enroll = True
    result = port.extract_image(frames[0])
    assert result.face_count >= 1 and result.selected_face_box is not None
    assert result.facial_feature is not None


def test_default_models_are_seeded():
    port = FacePipeline(_config(), device="cpu")
    assert port.embedding_model.fc.out_features == 512
    assert port.quality_model.fc.out_features == 4
    assert isinstance(port.extract_image(np.zeros((64, 64, 3), np.uint8)), FaceExtractionResult)
