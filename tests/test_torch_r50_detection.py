"""RetinaFace-R50 detection and FacePipeline: the port against the JAX package.

Both sides run the flax-initialised R50 at 64x64 (BatchNorm moved off
identity) on bridged weights, with ImageNet input normalization
(pixel_scale 255), so the scores spread instead of saturating.

  - ``detect_batch`` (plain K2 stem on the uint8 canvas, then the network
    from stage 1) against ``make_batched_fn(pre_s2d=True, stem="pallas")``
    (the Pallas stem in interpret mode) on the s2d layout of the same frames;
  - ``detect_padded`` / ``__call__`` (the float letterbox through the
    module's own stem) against the JAX host call, on 64x64 and odd sizes;
  - ``FacePipeline(backbone="resnet50")``: ``extract_image`` and
    ``extract_batch`` against the JAX FacePipeline on the same detector.

Required: equal counts, boxes and landmarks within 1e-3 px, scores within
1e-5 (tests/test_torch_detection.py's bounds); pipeline results within
tests/test_torch_pipeline.py's bounds.
"""

import dataclasses
import os

import jax.numpy as jnp
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
from rs_face_detection_tpu.ops.image import s2d_layout_host
from rs_face_detection_tpu.pipeline.detection import RetinaFaceDetection as JDetection
from rs_face_detection_tpu.pipeline.face_pipeline import FacePipeline as JFacePipeline
from rs_face_detection_tpu_torch.kernels import stem as kstem
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
from rs_face_detection_tpu_torch.pipeline.face_pipeline import FacePipeline
from test_torch_detection import _assert_same
from test_torch_models import _perturbed
from test_torch_pipeline import _assert_same as _assert_same_result

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FAMILY = "retinaface_resnet50"
CFG = FaceDetectionConfig(
    backbone="resnet50",
    image_size=(64, 64),
    confidence_threshold=0.7,
    max_candidates=64,
    max_detections=32,
    pixel_means=(0.485, 0.456, 0.406),
    pixel_stds=(0.229, 0.224, 0.225),
    pixel_scale=255.0,
)


@pytest.fixture(scope="module")
def r50():
    """Box and landmark heads scaled by 1/20, so that decoded boxes and
    landmarks lie near their anchors, at a trained detector's scale, and a
    px bound means what it means there."""
    model, variables = init_retinaface("resnet50", (64, 64), seed=0)
    flat = _perturbed(variables, 11)
    for k in flat:
        if k.startswith(("params/box", "params/ldm")):
            flat[k] = flat[k] / np.float32(20.0)
    return model, _unflatten(flat)


@pytest.fixture(scope="module")
def pair(r50):
    model, variables = r50
    port = weights.load_model(FAMILY, weights.state_dict_from_jax(FAMILY, variables))
    return JDetection(CFG, model=model, variables=variables), RetinaFaceDetection(CFG, port, device="cpu")


@pytest.fixture(scope="module")
def frames():
    with np.load(os.path.join(FIXTURES, "ap_eval_set.npz")) as d:
        ap = list(d["images"][:6])
    with np.load(os.path.join(FIXTURES, "golden_trained_scene.npz")) as g:
        scene = g["image"]
    return [scene, *ap]


def test_detect_batch_matches_jax_pallas_stem(pair, frames):
    ref, port = pair
    imgs = np.stack(frames)
    scales = np.linspace(0.5, 1.5, len(imgs)).astype(np.float32)
    fn = ref.make_batched_fn(pre_s2d=True, stem="pallas")
    want = fn(ref.variables, jnp.asarray(s2d_layout_host(imgs)), jnp.asarray(scales))
    before = kstem.launches
    got = port.detect_batch(imgs, scales)
    assert kstem.launches == before  # the CPU takes the plain stem
    counts = np.asarray(want.count)
    np.testing.assert_array_equal(got.count.numpy(), counts)
    assert counts.min() >= 1 and counts.max() < CFG.max_detections
    for i, n in enumerate(counts):
        _assert_same(got.det[i, :n], got.kps[i, :n], want.det[i, :n], want.kps[i, :n])


def test_host_call_matches_jax(pair, frames):
    ref, port = pair
    odd = np.random.default_rng(12).integers(0, 256, size=(96, 80, 3), dtype=np.uint8)
    for img in [*frames[:3], odd]:
        got, want = port(img), ref(img)
        assert len(want[0]) >= 1
        _assert_same(*got, *want)
        padded = port.detect_padded(img)
        assert int(padded.count) == len(want[0])


def test_odd_image_size_refuses_the_batched_path(pair, frames):
    """The fused stem takes even frame sizes only.  At an odd detector size
    detect_batch raises, as JAX's stem="pallas" does, rather than route the
    batch around the stem; the single-image path runs the module's own stem
    (its odd-size padding is held against flax in test_torch_resnet.py)."""
    _, port = pair
    odd = RetinaFaceDetection(dataclasses.replace(CFG, image_size=(63, 64)), port.model, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        odd.detect_batch(np.zeros((1, 64, 63, 3), np.uint8), np.ones(1, np.float32))
    det, kps = odd(frames[1])
    assert det.shape[1:] == (5,) and kps.shape[1:] == (5, 2) and np.isfinite(det).all()


@pytest.fixture(scope="module")
def pipelines(r50):
    det_model, det_vars = r50
    q_model, q_vars = init_resnet18_classifier(4, (112, 112), seed=1)
    e_model, e_vars = init_arcface("iresnet18", 512, (112, 112), seed=2)
    table = {
        "face_detection_retina": (FAMILY, det_model, det_vars),
        "face_quality": ("resnet18_classifier", q_model, q_vars),
        "face_identification": ("iresnet18", e_model, e_vars),
    }
    reg = ModelRegistry()
    models = {}
    for name, (family, model, vs) in table.items():
        reg.register(ModelSpec(name, (112, 112, 3), "test"), model, vs)
        models[name] = weights.load_model(family, weights.state_dict_from_jax(family, vs))
    cfg = FacePipelineConfig(detection=CFG, identification=FaceIdentificationConfig(backbone="iresnet18"))
    return JFacePipeline(cfg, registry=reg), FacePipeline(cfg, models=models, device="cpu")


def test_pipeline_extract_image_matches_jax(pipelines, frames):
    ref, port = pipelines
    for img in frames[:3]:
        _assert_same_result(port.extract_image(img), ref.extract_image(img))


def test_pipeline_extract_batch_matches_jax(pipelines, frames):
    ref, port = pipelines
    got, want = port.extract_batch(frames), ref.extract_batch(frames)
    assert len(got) == len(want) == len(frames)
    for g, w in zip(got, want):
        _assert_same_result(g, w)
    assert sum(w.facial_feature is not None for w in want) >= 3


def test_default_models_build_r50():
    cfg = FacePipelineConfig(detection=FaceDetectionConfig(backbone="resnet50", image_size=(64, 64)))
    port = FacePipeline(cfg, device="cpu")
    assert port.face_detection.model.backbone == "resnet50"
    assert port.face_detection.stem_consts is not None
    (result,) = port.extract_batch([np.zeros((48, 40, 3), np.uint8)])
    assert isinstance(result.face_count, int)
