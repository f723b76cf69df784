"""The port's model registry against the JAX package's.

  - the verbs give JAX's results on the same sequence (lifecycle, health,
    lazy loads, a concurrent second load keeping the first entry, a
    builder's name check, record, infer, statistics snapshots, memory);
  - ``save_variables`` / ``load_variables`` files load in the other package;
  - with SmallCNN fast heads, as tests/conftest.py::attach_fast_head_builders
    puts into the JAX registry, FacePipeline and EKYCPipeline built through
    a registry equal ones built from the same modules, and ``ModelStats``'
    counts equal JAX's after the same calls;
  - with no checkpoint, the standard builders give the seeded modules the
    pipelines built before the registry (models/weights.py::init_state,
    seed 0), and the entry points with neither models nor a registry build
    from ``default_registry`` on their device, one per device and per way
    the configs shape the modules.
"""

import dataclasses
import os
import threading

import jax
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.configs import FaceDetectionConfig, FacePipelineConfig
from rs_face_detection_tpu.models import registry as jreg
from rs_face_detection_tpu.models.heads import init_small_cnn as j_init_small_cnn
from rs_face_detection_tpu.models.retinaface import init_retinaface
from rs_face_detection_tpu.models.scrfd import init_scrfd
from rs_face_detection_tpu.pipeline.ekyc_pipeline import EKYCPipeline as JEKYCPipeline
from rs_face_detection_tpu.pipeline.face_pipeline import FacePipeline as JFacePipeline
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig as PortDetectionConfig
from rs_face_detection_tpu_torch.configs import FacePipelineConfig as PortConfig
from rs_face_detection_tpu_torch.models import registry as preg
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.heads import SmallCNN, small_cnn_map
from rs_face_detection_tpu_torch.models.vit import cast_for_serving
from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import EKYCPipeline
from rs_face_detection_tpu_torch.pipeline.face_pipeline import FacePipeline
from deadlines import in_threads

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
WIDTHS = (8, 16)
SIZE = 64


def _small(num_outputs, size, softmax=True, seed=0):
    """(JAX SmallCNN, variables, the port's SmallCNN on the same weights)."""
    model, variables = j_init_small_cnn(num_outputs, size, softmax=softmax, widths=WIDTHS, seed=seed)
    variables = jax.tree.map(np.asarray, variables)
    port = SmallCNN(num_outputs, WIDTHS, softmax).eval()
    port.load_state_dict(weights.state_dict_from_jax("small_cnn", variables, mapping=small_cnn_map(WIDTHS)))
    return model, variables, port


def _pair(entries):
    """A JAX and a port registry holding the same models: {name: (family,
    JAX model, variables, port module)}."""
    j, p = jreg.ModelRegistry(), preg.ModelRegistry("cpu")
    for name, (_, model, variables, port) in entries.items():
        j.register(jreg.ModelSpec(name, (SIZE, SIZE, 3), "test"), model, variables)
        p.register(preg.ModelSpec(name, (SIZE, SIZE, 3), "test"), port)
    return j, p


def _counts(stats):
    return stats.inference_count, stats.execution_count, stats.batch_size_counts


# -- the verbs -----------------------------------------------------------------


def test_verbs_match_jax():
    jm, jv, port = _small(3, (32, 32))
    j, p = jreg.ModelRegistry(), preg.ModelRegistry("cpu")
    spec = dict(name="head", input_shape=(32, 32, 3), output_spec="(B, 3)")
    j.register_builder("head", lambda: (jreg.ModelSpec(**spec), jm, jv))
    p.register_builder("head", lambda: (preg.ModelSpec(**spec), port))
    j.register_builder("misnamed", lambda: (jreg.ModelSpec(**spec), jm, jv))
    p.register_builder("misnamed", lambda: (preg.ModelSpec(**spec), port))
    for reg in (j, p):
        assert reg.server_live() and reg.server_ready()
        assert reg.index() == [{"name": "head", "state": "UNAVAILABLE"}, {"name": "misnamed", "state": "UNAVAILABLE"}]
        assert not reg.model_ready("head")
        with pytest.raises(KeyError):
            reg.load("absent")
        with pytest.raises(KeyError):
            reg.get("absent")
        with pytest.raises(ValueError, match="spec.name"):
            reg.load("misnamed")
        reg.record("head", 4, 0.5)  # not loaded: ignored
        assert reg.spec("head").output_spec == "(B, 3)"  # a lazy load
        assert reg.model_ready("head")
        assert reg.index()[0] == {"name": "head", "state": "READY"}
        reg.record("head", 4, 0.5)
        reg.record("head", 2, 0.25)
    assert j.memory_usage_bytes("head") == p.memory_usage_bytes("head")
    assert p.get("head") is port
    assert set(p.variables("head")) == set(port.state_dict())
    x = np.random.default_rng(0).normal(size=(5, 32, 32, 3)).astype(np.float32)
    want = np.asarray(j.infer("head", x, train=False))
    got = p.infer("head", x.transpose(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    js, ps = j.statistics("head"), p.statistics("head")
    assert _counts(ps) == _counts(js) == (11, 3, {4: 1, 2: 1, 5: 1})
    assert ps.cumulative_duration_s >= 0.75 and ps.last_duration_s > 0
    ps.batch_size_counts[99] = 1  # a snapshot: the registry's counts stay
    assert 99 not in p.statistics("head").batch_size_counts
    for reg in (j, p):
        reg.unload("head")
        assert not reg.model_ready("head")
        reg.unload("head")  # idempotent


def test_concurrent_second_load_keeps_the_first_entry():
    built, barrier = [], threading.Barrier(2)

    def builder():
        module = SmallCNN(2, WIDTHS)
        built.append(module)
        barrier.wait(timeout=10)  # both loads build before either registers
        return preg.ModelSpec("head", (32, 32, 3), "test"), module

    reg = preg.ModelRegistry("cpu")
    reg.register_builder("head", builder)
    in_threads(lambda _: reg.load("head"), 2, "load", 30)
    assert len(built) == 2
    kept = reg.get("head")
    assert kept in built
    reg.record("head", 1, 0.1)
    reg.load("head")  # a later load keeps the entry and its statistics
    assert reg.get("head") is kept and reg.statistics("head").execution_count == 1


def test_variables_files_load_in_both_packages(tmp_path):
    _, variables, port = _small(2, (32, 32))
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jreg.save_variables(jpath, variables)
    preg.save_variables(ppath, {"params": {"fc": {"kernel": port.fc.weight.T, "bias": port.fc.bias}}})
    flat_j = preg._flatten(preg.load_variables(jpath))
    assert flat_j.keys() == jreg._flatten(variables).keys()
    for k, v in jreg._flatten(variables).items():
        np.testing.assert_array_equal(flat_j[k], v)
    back = jreg.load_variables(ppath)
    np.testing.assert_array_equal(back["params"]["fc"]["kernel"], variables["params"]["fc"]["kernel"])
    np.testing.assert_array_equal(back["params"]["fc"]["bias"], variables["params"]["fc"]["bias"])


# -- the pipelines through a registry ---------------------------------------


def _face_config():
    return FacePipelineConfig(
        detection=FaceDetectionConfig(image_size=(SIZE, SIZE), confidence_threshold=0.3, max_candidates=64, max_detections=8)
    )


@pytest.fixture(scope="module")
def face_entries():
    det_model, _ = init_retinaface("mobilenet025", (SIZE, SIZE), seed=0)
    det_vars = jreg._unflatten(weights.flat_variables(os.path.join(FIXTURES, "trained_mnet64.npz")))
    det_port = weights.load_model("retinaface_mobilenet025", weights.state_dict_from_jax("retinaface_mobilenet025", det_vars))
    return {
        "face_detection_retina": ("retinaface_mobilenet025", det_model, det_vars, det_port),
        "face_quality": ("small", *_small(4, (112, 112), seed=1)),
        "face_identification": ("small", *_small(512, (112, 112), softmax=False, seed=2)),
    }


@pytest.fixture(scope="module")
def frames():
    with np.load(os.path.join(FIXTURES, "golden_trained_scene.npz")) as g:
        scene = g["image"]
    with np.load(os.path.join(FIXTURES, "ap_eval_set.npz")) as d:
        ap = list(d["images"][:5])
    return [scene, *ap]


def _same_face_results(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert (g is None) == (w is None), f.name
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w, f.name


def test_face_pipeline_through_a_registry(face_entries, frames):
    """With ``process_on_no_face`` and a blank frame, a batch has warped
    faces and a crop-fallback face: the port's one fused heads call counts
    as JAX's two calls."""
    jr, pr = _pair(face_entries)
    cfg = _face_config()
    frames = [*frames, np.zeros_like(frames[1])]
    ref = JFacePipeline(cfg, registry=jr, process_on_no_face=True)
    served = FacePipeline(cfg, device="cpu", registry=pr, process_on_no_face=True)
    direct = FacePipeline(cfg, models={n: e[3] for n, e in face_entries.items()}, device="cpu", process_on_no_face=True)
    assert served.served == tuple(face_entries) and direct.served == ()
    got, want = served.extract_batch(frames), direct.extract_batch(frames)
    assert sum(r.facial_feature is not None for r in want) >= 4
    assert want[-1].face_count == 0 and want[-1].facial_feature is not None
    for g, w in zip(got, want):
        _same_face_results(g, w)
    for img in frames[:2]:
        _same_face_results(served.extract_image(img), direct.extract_image(img))
    ref.extract_batch(frames)
    for img in frames[:2]:
        ref.extract_image(img)
    for name in face_entries:
        assert _counts(pr.statistics(name)) == _counts(jr.statistics(name)), name
    assert pr.statistics("face_quality").batch_size_counts.get(1, 0) >= 3  # the fallback call and extract_image's


def test_face_pipeline_takes_part_of_its_models_from_a_registry(face_entries, frames):
    """models= entries win; the registry serves and counts the rest."""
    _, pr = _pair(face_entries)
    cfg = _face_config()
    quality = SmallCNN(4, WIDTHS).eval()
    pipe = FacePipeline(cfg, models={"face_quality": quality}, device="cpu", registry=pr)
    assert pipe.quality_model is quality and pipe.served == ("face_detection_retina", "face_identification")
    results = pipe.extract_batch(frames)
    k = sum(r.facial_feature is not None for r in results)
    assert _counts(pr.statistics("face_identification")) == (k, 1, {k: 1})
    assert pr.statistics("face_detection_retina").inference_count == len(frames)
    assert pr.statistics("face_quality").execution_count == 0  # not the registry's module


def _ekyc_entries():
    scrfd_model, scrfd_vars = init_scrfd((96, 96), width=8, seed=0)
    scrfd_vars = jax.tree.map(np.asarray, scrfd_vars)
    scrfd_port = weights.load_model("scrfd", weights.state_dict_from_jax("scrfd", scrfd_vars))
    return {
        "scrfd": ("scrfd", scrfd_model, scrfd_vars, scrfd_port),
        "face_id": ("small", *_small(512, (112, 112), softmax=False, seed=3)),
        "face_attribute": ("small", *_small(2, (128, 128), seed=4)),
        "face_quality_vp": ("small", *_small(2, (112, 112), seed=5)),
        "face_anti_spoofing_crop_l14": ("small", *_small(2, (224, 224), seed=6)),
        "face_anti_spoofing_fi_l14": ("small", *_small(2, (224, 224), seed=7)),
    }


def test_ekyc_pipeline_through_a_registry():
    entries = _ekyc_entries()
    jr, pr = _pair(entries)
    face = np.load(os.path.join(FIXTURES, "real_face_crop.npz"))["face"]
    card = np.full((100, 150, 3), 200, np.uint8)
    card[20:80, 10:70] = face[(np.arange(60) * 160) // 60][:, (np.arange(60) * 160) // 60]
    selfie = np.ascontiguousarray(face[(np.arange(120) * 160) // 120][:, (np.arange(100) * 160) // 100])
    served = EKYCPipeline(device="cpu", detector_image_size=(96, 96), registry=pr)
    direct = EKYCPipeline(models={n: e[3] for n, e in entries.items()}, device="cpu", detector_image_size=(96, 96))
    ref = JEKYCPipeline(registry=jr, detector_image_size=(96, 96))
    for c, s in ((card, selfie), (selfie, card)):
        got, want = served.verify_images(c, s), direct.verify_images(c, s)
        _same_face_results(got, want)
        ref.verify_images(c, s)
    served.detection(card)  # the single-image detector counts too
    ref.detection(card)
    for name in entries:
        assert _counts(pr.statistics(name)) == _counts(jr.statistics(name)), name
    assert pr.statistics("scrfd").inference_count == 5


@pytest.mark.parametrize("stage", ["quality", "assessment", "extraction", "antispoofing"])
def test_staged_modules_through_a_registry(stage):
    """Each staged module built through a registry equals one built from
    the same module, and counts the calls as JAX's does (the anti-spoofing
    ensemble counts none, in both packages)."""
    from rs_face_detection_tpu.configs import FaceAntiSpoofingConfig
    from rs_face_detection_tpu.pipeline import antispoofing as jas
    from rs_face_detection_tpu.pipeline import extraction as jex
    from rs_face_detection_tpu.pipeline import quality as jq
    from rs_face_detection_tpu.pipeline import quality_assessment as jqa
    from rs_face_detection_tpu_torch.pipeline import antispoofing, extraction, quality, quality_assessment

    crops = list(np.random.default_rng(0).integers(0, 255, size=(3, 112, 112, 3), dtype=np.uint8))
    if stage == "antispoofing":
        fas = FaceAntiSpoofingConfig()
        entries = {n: ("small", *_small(3, size, seed=i)) for i, (n, size) in enumerate(zip(fas.model_names, fas.image_sizes))}
        j, p = _pair(entries)
        imgs, boxes = crops[:2], [np.array([10, 12, 80, 90, 0.9], np.float32)] * 2
        served = antispoofing.FaceAntiSpoofing(device="cpu", registry=p)
        direct = antispoofing.FaceAntiSpoofing(models=[e[3] for e in entries.values()], device="cpu")
        got, want = served(imgs, boxes), direct(imgs, boxes)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        jas.FaceAntiSpoofing(registry=j)(imgs, boxes)
        with pytest.raises(ValueError, match="not both"):
            antispoofing.FaceAntiSpoofing(models=direct.models, device="cpu", registry=p)
        names = fas.model_names
    else:
        name, outs, softmax, port_cls, jax_cls, call = {
            "quality": ("face_quality", 4, True, quality.FaceQuality, jq.FaceQuality, lambda m: m.probabilities(crops)),
            "assessment": ("face_quality_assetment", 1, False, quality_assessment.FaceQualityAssessment,
                           jqa.FaceQualityAssessment, lambda m: m(crops)),
            "extraction": ("face_identification", 512, False, extraction.FaceExtraction, jex.FaceExtraction,
                           lambda m: m(crops)),
        }[stage]
        entries = {name: ("small", *_small(outs, (112, 112), softmax=softmax, seed=7))}
        j, p = _pair(entries)
        served, direct = port_cls(device="cpu", registry=p), port_cls(model=entries[name][3], device="cpu")
        for _ in range(2):
            got, want = call(served), call(direct)
            assert np.array_equal(np.asarray(got, dtype=object), np.asarray(want, dtype=object))
            call(jax_cls(registry=j))
        with pytest.raises(ValueError, match="not both"):
            port_cls(model=entries[name][3], device="cpu", registry=p)
        names = [name]
    for n in names:
        assert _counts(p.statistics(n)) == _counts(j.statistics(n)), n


# -- the standard builders ---------------------------------------------------


def _equal_state(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize(
    "name,family,num_outputs,kw",
    [
        ("face_detection_retina", "retinaface_mobilenet025", 4, {}),
        ("face_quality", "resnet18_classifier", 4, {}),
        ("face_quality_assetment", "resnet18_classifier", 1, {"softmax": False}),
        ("face_identification", "iresnet50", 4, {}),
        ("miniFAS_2_7", "minifasnet", 3, {"image_size": 80}),
        ("miniFAS_2", "minifasnet", 3, {"image_size": 256}),
        ("scrfd", "scrfd", 2, {}),
        ("face_attribute", "resnet18_classifier", 2, {}),
        ("face_id", "iresnet50", 2, {}),
    ],
)
def test_seeded_builders_equal_the_seeded_models(name, family, num_outputs, kw, monkeypatch):
    monkeypatch.delenv("RSFD_CHECKPOINT_DIR", raising=False)
    reg = preg.standard_registry("cpu")
    softmax = kw.pop("softmax", True)
    want = weights.load_model(family, weights.init_state(family, 0, num_outputs, **kw), softmax=softmax)
    got = reg.get(name)
    _equal_state(got.state_dict(), want.state_dict())
    assert type(got) is type(want) and not got.training
    if family == "resnet18_classifier":
        assert got.softmax == softmax


def test_seeded_tower_builder_casts_for_serving(monkeypatch):
    """The CLIP towers' builder at clip_tiny_test (the full tower is for the
    card): seeded, then bf16 but for the LayerNorms."""
    monkeypatch.delenv("RSFD_CHECKPOINT_DIR", raising=False)
    real_init = weights.init_state
    monkeypatch.setattr(
        weights, "init_state", lambda family, *a, **k: real_init("clip_tiny_test" if family == "clip_l14" else family, *a, **k)
    )
    real_load = weights.load_model
    monkeypatch.setattr(
        weights, "load_model", lambda family, *a, **k: real_load("clip_tiny_test" if family == "clip_l14" else family, *a, **k)
    )
    reg = preg.standard_registry("cpu")
    tower = reg.get("face_anti_spoofing_crop_l14")
    want = cast_for_serving(real_load("clip_tiny_test", real_init("clip_tiny_test", 0, 2, image_size=224)))
    assert tower.conv1.weight.dtype == torch.bfloat16 and tower.ln_post.weight.dtype == torch.float32
    _equal_state(tower.state_dict(), want.state_dict())


def test_entry_points_default_to_the_registry():
    from rs_face_detection_tpu_torch.pipeline.quality import FaceQuality

    default = preg.default_registry("cpu")
    pipe = FacePipeline(device="cpu")
    assert pipe.registry is default and default.device == torch.device("cpu")
    assert pipe.quality_model is default.get("face_quality")  # served itself, not a copy
    other = FacePipeline(PortConfig(), device="cpu")
    assert other.registry is default  # equal configs share it
    r50_cfg = PortConfig(detection=PortDetectionConfig(backbone="resnet50"))
    heads = {"face_quality": pipe.quality_model, "face_identification": pipe.embedding_model}
    r50 = FacePipeline(r50_cfg, models=heads, device="cpu")
    assert r50.registry is not default and r50.registry is preg.default_registry("cpu", detection=r50_cfg.detection)
    assert r50.face_detection.model.backbone == "resnet50"
    again = FacePipeline(r50_cfg, models=heads, device="cpu")
    assert again.registry is r50.registry and again.face_detection.model is r50.face_detection.model
    with pytest.raises(ValueError, match="not both"):
        FaceQuality(model=SmallCNN(4, WIDTHS), registry=default, device="cpu")
    with pytest.raises(ValueError, match="keeps its modules on cpu"):
        FaceQuality(registry=default, device="meta")
