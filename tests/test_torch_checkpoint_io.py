"""The port's public-checkpoint import against the JAX package's.

For each of the seven public layouts, a torch mirror in that layout
(tests/torch_mirrors.py) is randomized and imported by both packages:

  - ``detect_kind`` and the meta (compared as JSON) equal JAX's;
  - the port's module, JAX's imported model and the mirror's own forward
    agree on the same seeded input, within 1e-4 of max|output| per map
    (f32 sums in other orders through up to ~60 layers);
  - a file from JAX ``save_imported`` loads in the port, and a file from the
    port's ``save_imported`` loads through JAX ``load_imported_model``, with
    the same outputs at the same tolerance;
  - ``strict`` raises on a missing and on an extra key;
  - ``maybe_serve_checkpoint`` serves ``$RSFD_CHECKPOINT_DIR/<name>.npz``.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models import checkpoint_io as jio
from rs_face_detection_tpu.models.registry import save_variables as jax_save_variables
from rs_face_detection_tpu_torch.models import checkpoint_io as pio
from rs_face_detection_tpu_torch.models.registry import save_variables

from torch_mirrors import (
    CLIPVisualMirror,
    IResNetMirror,
    MiniFASNetMirror,
    ResNet18ClassifierMirror,
    RetinaFaceMirror,
    SCRFDMirror,
    randomize_state_dict,
)

#: kind -> (mirror factory, input (width, height), import keywords)
#: (the JAX import initialises its model at the import's image size, 640 by
#: default for the detectors: the cases import at their input size)
CASES = {
    "retinaface_mnet025": (lambda: RetinaFaceMirror("mobilenet025"), (64, 64), {"image_size": (64, 64)}),
    "retinaface_resnet50": (lambda: RetinaFaceMirror("resnet50"), (64, 64), {"image_size": (64, 64)}),
    "iresnet": (lambda: IResNetMirror("iresnet18"), (112, 112), {}),
    "minifas": (lambda: MiniFASNetMirror(width=8), (80, 80), {}),
    "resnet18": (lambda: ResNet18ClassifierMirror(4), (64, 64), {"image_size": (64, 64)}),
    "clip_visual": (lambda: CLIPVisualMirror(input_res=32), (32, 32), {"image_size": (32, 32)}),
    "scrfd": (lambda: SCRFDMirror(width=8), (64, 64), {"image_size": (64, 64)}),
}
KINDS = tuple(CASES)
REL_TOL = 1e-4


def _maps(out):
    """A module's output as a list of (B, -1) arrays in a fixed order."""
    if isinstance(out, dict):  # per-stride maps, channels last
        return [
            np.asarray(out[s][key]).reshape(np.shape(out[s][key])[0], -1)
            for s in sorted(out) for key in sorted(out[s])
        ]
    if isinstance(out, torch.Tensor):
        return [out.detach().numpy().reshape(out.shape[0], -1)]
    return [np.asarray(out).reshape(np.shape(out)[0], -1)]


def _mirror_maps(kind, out):
    if kind.startswith("retinaface"):  # (scores, bboxes, ldms) per level
        scores, bboxes, ldms = out
        per = [(bboxes[i], ldms[i], scores[i]) for i in range(3)]  # sorted keys: bbox, landmark, score
    elif kind == "scrfd":  # (score, bbox, kps) NCHW per level
        per = [(b.permute(0, 2, 3, 1), k.permute(0, 2, 3, 1), s.permute(0, 2, 3, 1)) for s, b, k in out]
    elif kind in ("minifas", "resnet18", "clip_visual"):  # logits; the imports apply the softmax
        return _maps(torch.softmax(out, dim=-1))
    else:
        return _maps(out)
    return [t.detach().numpy().reshape(t.shape[0], -1) for level in per for t in level]


def _assert_maps(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"{what} map {i}: {g.shape} vs {w.shape}"
        np.testing.assert_allclose(g, w, rtol=0, atol=REL_TOL * float(np.abs(w).max()), err_msg=f"{what} map {i}")


@functools.lru_cache(maxsize=None)
def case(kind):
    """(state_dict, NCHW input, mirror maps, JAX (model, variables, meta), JAX maps)."""
    factory, (w, h), kwargs = CASES[kind]
    mirror = randomize_state_dict(factory(), seed=KINDS.index(kind) + 1)
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    x = np.random.default_rng(KINDS.index(kind)).uniform(0, 255, (2, 3, h, w)).astype(np.float32)
    if kind in ("clip_visual", "scrfd", "minifas"):
        x = (x - 127.5) / 64.0
    with torch.no_grad():
        mirror_maps = _mirror_maps(kind, mirror(torch.from_numpy(x)))
    model, variables, meta = jio.import_state_dict(sd, **kwargs)
    return sd, x, mirror_maps, (model, variables, meta), _maps(jax_apply(kind, model)(variables, x))


@functools.lru_cache(maxsize=None)
def jax_apply(kind, model):
    """One jitted JAX forward per kind (a model loaded from a file has the
    same architecture, so the compiled function is reused)."""
    fn = jax.jit(lambda v, x: model.apply(v, x, train=False))
    return lambda v, x: fn(v, jnp.asarray(x.transpose(0, 2, 3, 1)))


def _port_maps(model, x):
    with torch.no_grad():
        return _maps(model(torch.from_numpy(x)))


@pytest.mark.parametrize("kind", KINDS)
def test_detect_kind_matches_jax(kind):
    sd = case(kind)[0]
    assert pio.detect_kind(sd) == jio.detect_kind(sd) == kind
    prefixed = {f"module.{k}": v for k, v in sd.items()}
    assert pio.detect_kind(prefixed) == kind


def test_detect_kind_rejects_unknown_layouts():
    for detect in (pio.detect_kind, jio.detect_kind):
        with pytest.raises(ValueError, match="unrecognized"):
            detect({"totally.unknown.weight": np.zeros(3)})


@pytest.mark.parametrize("kind", KINDS)
def test_meta_matches_jax(kind):
    sd, _, _, (_, _, jax_meta), _ = case(kind)
    _, meta = pio.import_state_dict(sd, **CASES[kind][2])
    assert json.dumps(meta, sort_keys=True) == json.dumps(jax_meta, sort_keys=True)


@pytest.mark.parametrize("kind", KINDS)
def test_import_matches_jax_and_mirror(kind):
    """Tolerance: 1e-4 of max|map| per output map."""
    sd, x, mirror_maps, _, jax_maps = case(kind)
    model, _ = pio.import_state_dict({f"module.{k}": v for k, v in sd.items()}, **CASES[kind][2])
    got = _port_maps(model, x)
    _assert_maps(got, jax_maps, f"{kind} port vs JAX")
    _assert_maps(got, mirror_maps, f"{kind} port vs mirror")


@pytest.mark.parametrize("kind", KINDS)
def test_jax_file_loads_in_port(kind, tmp_path):
    """Tolerance: 1e-4 of max|map| per output map."""
    _, x, _, (_, variables, meta), jax_maps = case(kind)
    path = str(tmp_path / "model")  # no suffix: the exact path is written
    jio.save_imported(path, variables, meta)
    model, got_meta = pio.load_imported_model(path, return_meta=True)
    assert json.dumps(got_meta, sort_keys=True) == json.dumps(meta, sort_keys=True)
    _assert_maps(_port_maps(model, x), jax_maps, f"{kind} JAX file in the port")


@pytest.mark.parametrize("kind", KINDS)
def test_port_file_loads_in_jax(kind, tmp_path):
    """Tolerance: 1e-4 of max|map| per output map."""
    sd, x, _, (jax_model, _, _), _ = case(kind)
    model, meta = pio.import_state_dict(sd, **CASES[kind][2])
    want = _port_maps(model, x)
    path = str(tmp_path / "model.npz")
    pio.save_imported(path, model, meta)
    _, variables = jio.load_imported_model(path)  # the architecture of jax_model, rebuilt from meta
    _assert_maps(_maps(jax_apply(kind, jax_model)(variables, x)), want, f"{kind} port file in JAX")


@pytest.mark.parametrize("kind", KINDS)
def test_strict_raises_on_missing_and_extra_keys(kind):
    sd, kwargs = case(kind)[0], CASES[kind][2]
    extra = dict(sd, **{"unexpected.weight": np.zeros(3, np.float32)})
    if kind == "clip_visual":  # only visual.* keys count as unconsumed
        extra = dict(sd, **{"visual.unexpected": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="extra keys"):
        pio.import_state_dict(extra, **kwargs)
    assert pio.import_state_dict(extra, strict=False, **kwargs)[0] is not None
    victim = next(k for k in sorted(sd) if k.endswith(".weight") and not k.startswith("head."))
    missing = {k: v for k, v in sd.items() if k != victim}
    with pytest.raises((KeyError, ValueError)):  # the JAX maps raise a KeyError here too
        pio.import_state_dict(missing, **kwargs)


def test_iresnet_depth_matches_jax():
    sd = case("iresnet")[0]
    assert pio.iresnet_depth_from_state_dict(sd) == jio.iresnet_depth_from_state_dict(sd) == "iresnet18"


def test_maybe_serve_checkpoint_picks_up_the_directory(tmp_path, monkeypatch):
    sd, x, _, (_, _, meta), jax_maps = case("resnet18")
    monkeypatch.delenv(pio.CHECKPOINT_DIR_ENV, raising=False)
    assert pio.maybe_serve_checkpoint("face_quality") is None
    monkeypatch.setenv(pio.CHECKPOINT_DIR_ENV, str(tmp_path))
    assert pio.maybe_serve_checkpoint("face_quality") is None  # no file yet
    model, meta = pio.import_state_dict(sd)
    pio.save_imported(str(tmp_path / "face_quality.npz"), model, meta)
    served = pio.maybe_serve_checkpoint("face_quality", expect_family="resnet18")
    _assert_maps(_port_maps(served, x), jax_maps, "served resnet18")
    with pytest.raises(ValueError, match="expects"):
        pio.maybe_serve_checkpoint("face_quality", expect_family="iresnet")
    logits = pio.maybe_serve_checkpoint("face_quality", softmax=False)
    assert not logits.softmax


def test_plain_npz_loads_without_meta_but_is_refused_as_a_model(tmp_path):
    """load_imported takes a save_variables file (meta None), from either
    package; load_imported_model refuses it, as JAX does."""
    _, _, _, (_, variables, _), _ = case("resnet18")
    for i, save in enumerate((jax_save_variables, save_variables)):
        path = str(tmp_path / f"plain{i}.npz")
        save(path, jax.device_get(variables))
        tree, meta = pio.load_imported(path)
        assert meta is None
        np.testing.assert_array_equal(tree["params"]["fc"]["kernel"], np.asarray(variables["params"]["fc"]["kernel"]))
        for load in (pio.load_imported_model, jio.load_imported_model):
            with pytest.raises(ValueError, match="__meta__"):
                load(path)


def test_r50_natural_stem_file_loads_in_port(tmp_path):
    """A JAX R50 file with the natural 7x7 stem (stem_s2d=False) loads into
    the port's s2d stem (an exact re-expression).  Tolerance: 1e-4 of
    max|map| against the JAX s2d import's outputs."""
    sd, x, _, _, jax_maps = case("retinaface_resnet50")
    _, variables, meta = jio.import_state_dict(sd, stem_s2d=False, image_size=(64, 64))
    assert meta["stem_s2d"] is False
    path = str(tmp_path / "r50.npz")
    jio.save_imported(path, variables, meta)
    _assert_maps(_port_maps(pio.load_imported_model(path), x), jax_maps, "natural-stem R50")
    with pytest.raises(ValueError, match="s2d"):
        pio.import_state_dict(sd, stem_s2d=False)
