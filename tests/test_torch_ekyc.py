"""The slice as a whole: the port's EKYCPipeline against the JAX
EKYCPipeline on the same bridged weights.

Small models, as tests/test_ekyc.py uses them: SCRFD width 8 at 96 px, an
IResNet-18 ``face_id``, ResNet-18 classifiers with 2 outputs at 128 and 112,
and ``clip_tiny_test`` anti-spoofing towers at 224, all in f32.  Required:
the same found flags and booleans, boxes within 1e-3 px, similarity and
selfie quality within 1e-4, and every head's probabilities within 1e-4 on
the same aligned selfie.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models.arcface import init_arcface
from rs_face_detection_tpu.models.classifiers import init_resnet18_classifier
from rs_face_detection_tpu.models.registry import ModelRegistry, ModelSpec
from rs_face_detection_tpu.models.scrfd import init_scrfd
from rs_face_detection_tpu.models.vit import init_vit
from rs_face_detection_tpu.pipeline.ekyc_pipeline import EKYCPipeline as JEKYCPipeline
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import EKYCPipeline, EKYCResult

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SIZE = 96


def _variables():
    """{registry name: (family, flax model, numpy variables)}."""
    built = {
        "scrfd": ("scrfd", *init_scrfd((SIZE, SIZE), width=8, seed=0)),
        "face_id": ("iresnet18", *init_arcface("iresnet18", 512, (112, 112), seed=1)),
        "face_attribute": ("resnet18_classifier", *init_resnet18_classifier(2, (128, 128), seed=2)),
        "face_quality_vp": ("resnet18_classifier", *init_resnet18_classifier(2, (112, 112), seed=3)),
        "face_anti_spoofing_crop_l14": ("clip_tiny_test", *init_vit("clip_tiny_test", 2, (224, 224), seed=4)),
        "face_anti_spoofing_fi_l14": ("clip_tiny_test", *init_vit("clip_tiny_test", 2, (224, 224), seed=5)),
    }
    return {k: (f, m, jax.tree.map(np.asarray, v)) for k, (f, m, v) in built.items()}


def _pipelines(variables):
    reg = ModelRegistry()
    models = {}
    for name, (family, model, vs) in variables.items():
        reg.register(ModelSpec(name, (SIZE, SIZE, 3), "test"), model, vs)
        models[name] = weights.load_model(family, weights.state_dict_from_jax(family, vs))
    ref = JEKYCPipeline(registry=reg, detector_image_size=(SIZE, SIZE))
    port = EKYCPipeline(models=models, device="cpu", detector_image_size=(SIZE, SIZE))
    return ref, port


@pytest.fixture(scope="module")
def variables():
    return _variables()


@pytest.fixture(scope="module")
def pipelines(variables):
    return _pipelines(variables)


@pytest.fixture(scope="module")
def images():
    """A card (the fixture face on a grey document) and three selfies."""
    rng = np.random.default_rng(0)
    face = np.load(os.path.join(FIXTURES, "real_face_crop.npz"))["face"]
    card = np.full((100, 150, 3), 200, np.uint8)
    card[20:80, 10:70] = face[(np.arange(60) * 160) // 60][:, (np.arange(60) * 160) // 60]
    selfie = np.ascontiguousarray(face[(np.arange(120) * 160) // 120][:, (np.arange(100) * 160) // 100])
    noise = rng.integers(0, 255, size=(120, 100, 3), dtype=np.uint8)
    return {"card": card, "selfie": selfie, "noise": noise}


def _assert_same(got: EKYCResult, want):
    assert got.card_face_found == want.card_face_found
    assert got.selfie_face_found == want.selfie_face_found
    for g, w in ((got.card_face_box, want.card_face_box), (got.selfie_face_box, want.selfie_face_box)):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.shape == w.shape == (5,)
            np.testing.assert_allclose(g[:4], w[:4], atol=1e-3, rtol=0)
    assert abs(got.similarity - want.similarity) <= 1e-4
    for field in ("same_person", "same_ekyc", "selfie_mask", "selfie_covered", "selfie_live_crop", "selfie_live_full"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.selfie_quality is None) == (want.selfie_quality is None)
    if want.selfie_quality is not None:
        assert abs(got.selfie_quality - want.selfie_quality) <= 1e-4


@pytest.mark.parametrize("pair", [("card", "selfie"), ("selfie", "noise")])
def test_verify_images_matches_jax(pipelines, images, pair):
    ref, port = pipelines
    card, selfie = images[pair[0]], images[pair[1]]
    got, want = port.verify_images(card, selfie), ref.verify_images(card, selfie)
    # Both faces found: the comparison covers embedding and every head.
    assert want.card_face_found and want.selfie_face_found
    assert want.selfie_live_full is not None
    _assert_same(got, want)


def test_verify_bytes_matches_jax(pipelines, images):
    ref, port = pipelines
    ok1, card = cv2.imencode(".jpg", images["card"])
    ok2, selfie = cv2.imencode(".jpg", images["selfie"])
    assert ok1 and ok2
    got = port.verify(card.tobytes(), selfie.tobytes())
    _assert_same(got, ref.verify(card.tobytes(), selfie.tobytes()))
    assert got.selfie_face_found


def test_same_image_is_the_same_person(pipelines, images):
    _, port = pipelines
    result = port.verify_images(images["selfie"], images["selfie"])
    assert result.similarity == pytest.approx(1.0, abs=1e-5)
    assert result.same_person and result.same_ekyc


@pytest.mark.parametrize("which", ["attribute", "quality", "fas_crop", "fas_full"])
def test_heads_match_jax(pipelines, images, which):
    """Each head's probabilities on the same aligned selfie (fas_full on the
    selfie resized to 224, as verify feeds it)."""
    ref, port = pipelines
    box, kps = ref._best_face(images["selfie"])
    if which == "fas_full":
        img = cv2.resize(images["selfie"], (224, 224), interpolation=cv2.INTER_LINEAR)
    else:
        img = ref.alignment(images["selfie"], box, kps)
    want = np.asarray(ref._run_head(which, img[None].astype(np.float32)))
    got = port.run_head(which, torch.from_numpy(np.array(img, np.float32))[None]).numpy()
    assert got.shape == want.shape == (1, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_no_face_returns_the_schema_defaults(variables, images):
    """A detector whose scores are all 0: no face on either side."""
    family, model, vs = variables["scrfd"]
    params = dict(vs["params"])
    head = dict(params["head"])
    head["cls"] = {**head["cls"], "bias": np.full_like(head["cls"]["bias"], -1e3)}
    params["head"] = head
    ref, port = _pipelines({**variables, "scrfd": (family, model, {**vs, "params": params})})
    got = port.verify_images(images["card"], images["selfie"])
    assert dataclasses.asdict(got) == dataclasses.asdict(EKYCResult())
    _assert_same(got, ref.verify_images(images["card"], images["selfie"]))


def test_scrfd_select_settings_match_jax(variables, images):
    """SCRFDDetection takes JAX's select and NMS settings: at the WIDER
    protocol's 0.02 with 256 candidates (378 anchors at 96, so the top-k
    truncates) every image's detections equal JAX's (counts equal, boxes and
    landmarks within 1e-3 px, scores within 1e-5); the defaults are JAX's."""
    from rs_face_detection_tpu.pipeline.ekyc_pipeline import SCRFDDetection as JSCRFDDetection
    from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import SCRFDDetection
    from test_torch_detection import _assert_same

    family, jmodel, vs = variables["scrfd"]
    model = weights.load_model(family, weights.state_dict_from_jax(family, vs))
    fields = dict(confidence_threshold=0.02, max_candidates=256)
    port = SCRFDDetection(model=model, device="cpu", image_size=(SIZE, SIZE), **fields)
    ref = JSCRFDDetection(model=jmodel, variables=vs, image_size=(SIZE, SIZE), registry=None, **fields)
    for img in images.values():
        got, want = port(img), ref(img)
        assert len(want[0]) > 0
        _assert_same(*got, *want)
    default = SCRFDDetection(model=model, device="cpu", image_size=(SIZE, SIZE)).sel_cfg
    jdefault = JSCRFDDetection(model=jmodel, variables=vs, image_size=(SIZE, SIZE), registry=None)._sel_cfg
    for field in ("confidence_threshold", "iou_threshold", "max_candidates", "max_detections"):
        assert getattr(default, field) == getattr(jdefault, field), field
    narrow = SCRFDDetection(model=model, device="cpu", image_size=(SIZE, SIZE), iou_threshold=0.3, max_detections=3)
    assert (narrow.sel_cfg.iou_threshold, narrow.sel_cfg.max_detections) == (0.3, 3)
