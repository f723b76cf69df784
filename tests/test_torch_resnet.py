"""RetinaFace-ResNet50 in the port against the flax model on bridged weights.

The port's RetinaFace("resnet50") runs the JAX package's s2d stem (a 4x4
conv on the 2x2 space-to-depth layout).  Required, in f32 on the CPU:

  - per-stride maps within atol 1e-4 (rtol 1e-4) of ``RetinaFace.apply`` on
    the same perturbed weights and normalized inputs, through the float path
    (``forward``) and through the uint8 stem path (``fused_stem_plain`` +
    ``forward_pooled``): the deep net sums in another order, about 1e-6 of
    the maps' magnitude (O(1) here);
  - the weight bridge round-trips exactly through the JAX package's own
    import map, and raises on a missing or an extra leaf;
  - a randomised biubug6 mirror loaded through ``load_retinaface_state_dict``
    gives the maps that the same mirror gives through the JAX package's
    ``load_retinaface_state_dict`` (the 7x7 stem mapped to the s2d form),
    at 128x128, within the bound of tests/test_checkpoint_maps.py;
  - the numpy copies of ``stem_to_s2d`` / ``s2d_stem_padding`` equal their
    originals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models.checkpoint_maps import (
    load_retinaface_state_dict,
    retinaface_resnet50_map,
)
from rs_face_detection_tpu.models.import_weights import apply_mapping
from rs_face_detection_tpu.models.import_weights import s2d_stem_padding as jax_padding
from rs_face_detection_tpu.models.import_weights import stem_to_s2d as jax_stem_to_s2d
from rs_face_detection_tpu.models.registry import _flatten, _unflatten
from rs_face_detection_tpu.models.retinaface import init_retinaface
from rs_face_detection_tpu_torch.models import resnet, weights
from rs_face_detection_tpu_torch.models.checkpoint_maps import load_retinaface_state_dict as port_load_retinaface
from rs_face_detection_tpu_torch.ops.stem import fused_stem_plain
from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
from rs_face_detection_tpu.configs import FaceDetectionConfig
from test_torch_models import _perturbed
from torch_mirrors import RetinaFaceMirror, randomize_state_dict

torch.set_num_threads(2)

FAMILY = "retinaface_resnet50"


@pytest.fixture(scope="module")
def flax_r50():
    """The flax R50 at 64x64 and its weights with BatchNorm moved off
    identity (flax init of the R50 takes most of this file's time)."""
    model, variables = init_retinaface("resnet50", (64, 64), seed=0)
    return model, _perturbed(variables, 10)


def _maps_close(got, want, atol=1e-4):
    for stride in (8, 16, 32):
        for key in ("score", "bbox", "landmark"):
            w = np.asarray(want[stride][key])
            g = got[stride][key].numpy()
            assert g.shape == w.shape, (stride, key)
            np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4, err_msg=f"{stride}/{key}")


def test_r50_float_path_matches_flax(flax_r50):
    model, flat = flax_r50
    x = np.random.default_rng(1).uniform(-2, 2, size=(2, 64, 64, 3)).astype(np.float32)
    want = model.apply(_unflatten(flat), jnp.asarray(x), train=False)
    port = weights.load_model(FAMILY, weights.state_dict_from_jax(FAMILY, flat))
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    _maps_close(got, want)


def test_r50_odd_size_float_path_matches_flax(flax_r50):
    """Odd H/W: both pad a high-side zero row/column before the s2d stem."""
    model, flat = flax_r50
    x = np.random.default_rng(2).uniform(-1, 1, size=(1, 67, 61, 3)).astype(np.float32)
    want = model.apply(_unflatten(flat), jnp.asarray(x), train=False)
    port = weights.load_model(FAMILY, weights.state_dict_from_jax(FAMILY, flat))
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    _maps_close(got, want)


def test_r50_u8_stem_path_matches_flax(flax_r50):
    """uint8 BGR frames: the detector's folded stem (plain K2) and
    forward_pooled against flax on the normalized RGB frames."""
    model, flat = flax_r50
    cfg = FaceDetectionConfig(
        backbone="resnet50", image_size=(64, 64),
        pixel_means=(0.485, 0.456, 0.406), pixel_stds=(0.229, 0.224, 0.225), pixel_scale=255.0,
    )
    imgs = np.random.default_rng(3).integers(0, 256, size=(2, 64, 64, 3), dtype=np.uint8)
    rgb = imgs[..., ::-1].astype(np.float32)
    mean = np.float32(cfg.pixel_scale) * np.asarray(cfg.pixel_means, np.float32)
    x = (rgb - mean) * (1.0 / np.asarray(cfg.pixel_stds, np.float32)) / np.float32(cfg.pixel_scale)
    want = model.apply(_unflatten(flat), jnp.asarray(x), train=False)
    det = RetinaFaceDetection(
        cfg, weights.load_model(FAMILY, weights.state_dict_from_jax(FAMILY, flat)), device="cpu"
    )
    with torch.no_grad():
        pooled = fused_stem_plain(torch.from_numpy(imgs), *det.stem_consts)
        got = det.model.forward_pooled(pooled)
    _maps_close(got, want)


def test_r50_bridge_round_trip(flax_r50):
    _, flat = flax_r50
    sd = {k: v.numpy() for k, v in weights.state_dict_from_jax(FAMILY, flat).items()}
    assert tuple(sd["body.conv1.weight"].shape) == (64, 12, 4, 4)
    jax_map = retinaface_resnet50_map(stem_s2d=False)  # the s2d kernel as it is
    back, unconsumed = apply_mapping(_unflatten(flat), sd, jax_map)
    assert unconsumed == []
    back = _flatten(back)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def test_r50_bridge_raises_on_missing_and_extra_leaves(flax_r50):
    _, flat = flax_r50
    extra = dict(flat, **{"params/body/extra/kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not mapped"):
        weights.state_dict_from_jax(FAMILY, extra)
    missing = {k: v for k, v in flat.items() if not k.startswith("params/body/s3b2/c3")}
    with pytest.raises(KeyError):
        weights.state_dict_from_jax(FAMILY, missing)


def test_r50_init_state_full_width():
    sd = weights.init_state(FAMILY, seed=0)
    model = weights.load_model(FAMILY, sd)
    assert tuple(sd["body.conv1.weight"].shape) == (64, 12, 4, 4)
    assert tuple(sd["body.layer4.2.conv3.weight"].shape) == (2048, 512, 1, 1)
    assert tuple(sd["fpn.merge1.0.weight"].shape) == (256, 256, 3, 3)
    assert model.uses_s2d_stem() and FAMILY in weights.FAMILIES
    assert all(torch.equal(sd[k], v) for k, v in weights.init_state(FAMILY, seed=0).items())


@pytest.mark.parametrize("k", [3, 7])
def test_stem_to_s2d_copy_equals_original(k):
    kernel = np.random.default_rng(k).normal(size=(k, k, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(resnet.stem_to_s2d(kernel), jax_stem_to_s2d(kernel))
    assert resnet.s2d_stem_padding(k) == jax_padding(k)


def test_biubug6_r50_loader_matches_jax_import(flax_r50):
    """The flax parameters do not depend on the image size, so the 64x64
    module serves 128x128; the import overwrites every leaf."""
    model, flat = flax_r50
    mirror = randomize_state_dict(RetinaFaceMirror("resnet50"), seed=1)
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    new_vars = load_retinaface_state_dict(_unflatten(flat), sd, "resnet50", stem_s2d=True)
    x = np.random.default_rng(1).uniform(0, 255, (1, 128, 128, 3)).astype(np.float32)
    want = model.apply(jax.tree.map(jnp.asarray, new_vars), jnp.asarray(x), train=False)
    prefixed = {f"module.{k}": v for k, v in sd.items()}
    port = weights.load_model(FAMILY, port_load_retinaface(prefixed, "resnet50"))
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    for stride in (8, 16, 32):
        for key in ("score", "bbox", "landmark"):
            w = np.asarray(want[stride][key])
            # tests/test_checkpoint_maps.py's bound: rtol 1e-3, atol scaled
            # to the map's magnitude (deep randomised nets cancel near 0).
            np.testing.assert_allclose(
                got[stride][key].numpy(), w, rtol=1e-3, atol=1e-3 * float(np.abs(w).max()),
                err_msg=f"{stride}/{key}",
            )
    with pytest.raises(ValueError, match="extra keys"):
        port_load_retinaface(dict(sd, **{"fpn.extra.weight": np.zeros(1)}), "resnet50")
    del sd["ClassHead.0.conv1x1.bias"]
    with pytest.raises(ValueError, match="missing keys"):
        port_load_retinaface(sd, "resnet50")
