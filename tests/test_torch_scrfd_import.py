"""mmdet-layout SCRFD: the port's import against the JAX package's.

The spec derived from a state_dict equals JAX's field by field for both
stride-key styles ("8" and "(8, 8)"), with and without keypoints, with a
GroupNorm and a BatchNorm head.  The per-stride maps of the imported
networks agree within 1e-4 of each map's magnitude (f32 sums in other
orders), and SCRFDDetection on the imported net gives JAX's detections:
equal counts, boxes and landmarks within 1e-3 px.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models import scrfd_import as jsi
from rs_face_detection_tpu.pipeline.ekyc_pipeline import SCRFDDetection as JSCRFDDetection
from rs_face_detection_tpu_torch.models import scrfd_import as psi
from rs_face_detection_tpu_torch.pipeline.ekyc_pipeline import SCRFDDetection

from torch_mirrors import SCRFDMirror, randomize_state_dict

SIZE = 64
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _state_dict(style="plain", use_kps=True, norm="gn", seed=3):
    """A randomized mmdet SCRFD state_dict; the BatchNorm head is the GN
    mirror's with its norms renamed ``bn`` and running statistics added."""
    mirror = randomize_state_dict(SCRFDMirror(width=8, use_kps=use_kps, stride_key_style=style), seed=seed)
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    if norm == "bn":
        rng = np.random.default_rng(seed)
        for key in [k for k in sd if ".gn." in k]:
            sd[key.replace(".gn.", ".bn.")] = sd.pop(key)
            if key.endswith("weight"):
                n = sd[key.replace(".gn.", ".bn.")].shape[0]
                base = key.replace(".gn.weight", ".bn")
                sd[f"{base}.running_mean"] = rng.normal(0, 0.1, n).astype(np.float32)
                sd[f"{base}.running_var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return sd


@pytest.mark.parametrize("norm", ["gn", "bn"])
@pytest.mark.parametrize("use_kps", [True, False])
@pytest.mark.parametrize("style", ["plain", "tuple"])
def test_spec_equals_jax(style, use_kps, norm):
    sd = _state_dict(style, use_kps, norm)
    got = psi.scrfd_spec_from_state_dict(sd)
    want = jsi.scrfd_spec_from_state_dict(sd)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.head_norm, got.use_kps, got.neck_in_start) == (norm, use_kps, 1)


def _jax_maps(sd):
    model, variables, spec = jsi.load_scrfd_state_dict(sd, image_size=(SIZE, SIZE))
    return model, variables, jax.jit(lambda v, x: model.apply(v, x, train=False))


@pytest.mark.parametrize("style,use_kps,norm", [("plain", True, "gn"), ("tuple", True, "bn"), ("plain", False, "gn")])
def test_maps_agree_with_jax(style, use_kps, norm):
    """Tolerance: 1e-4 of max|map| per map."""
    sd = _state_dict(style, use_kps, norm)
    model, spec = psi.load_scrfd_state_dict({f"module.{k}": v for k, v in sd.items()})
    assert spec == psi.scrfd_spec_from_state_dict(sd)
    _, variables, fn = _jax_maps(sd)
    x = np.random.default_rng(0).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    want = fn(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert set(got) == set(want) == {8, 16, 32}
    for stride in (8, 16, 32):
        assert set(got[stride]) == set(want[stride])
        for key, w in want[stride].items():
            w = np.asarray(w)
            np.testing.assert_allclose(
                got[stride][key].numpy(), w, rtol=0, atol=1e-4 * float(np.abs(w).max()), err_msg=f"{stride}/{key}"
            )


def test_detections_equal_jax():
    """Equal counts; boxes and landmarks within 1e-3 px, scores within 1e-5."""
    sd = _state_dict("tuple", True, "gn", seed=5)
    jmodel, variables, _ = _jax_maps(sd)
    ref = JSCRFDDetection(model=jmodel, variables=variables, image_size=(SIZE, SIZE), registry=None)
    port = SCRFDDetection(model=psi.load_scrfd_state_dict(sd)[0], device="cpu", image_size=(SIZE, SIZE))
    rng = np.random.default_rng(1)
    face = np.load(os.path.join(FIXTURES, "real_face_crop.npz"))["face"]
    images = [face, rng.integers(0, 255, size=(80, 50, 3), dtype=np.uint8)]
    total = 0
    for img in images:
        (got_det, got_kps), (want_det, want_kps) = port(img), ref(img)
        assert got_det.shape == want_det.shape
        total += len(want_det)
        np.testing.assert_allclose(got_det[:, :4], want_det[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got_det[:, 4], want_det[:, 4], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_kps, want_kps, rtol=0, atol=1e-3)
    assert total > 0


def test_stride_keys_renamed_and_strict():
    sd = _state_dict("tuple")
    model, spec = psi.load_scrfd_state_dict(sd)
    assert "bbox_head.stride_cls.16.weight" in model.state_dict()
    assert model.num_anchors == spec.num_anchors == 2
    with pytest.raises(ValueError, match="extra keys"):
        psi.load_scrfd_state_dict(dict(sd, **{"bbox_head.unknown.weight": np.zeros(3, np.float32)}))
    psi.load_scrfd_state_dict(dict(sd, **{"bbox_head.unknown.weight": np.zeros(3, np.float32)}), strict=False)
    with pytest.raises(ValueError, match="missing keys"):
        psi.load_scrfd_state_dict({k: v for k, v in sd.items() if "neck.fpn_convs.1" not in k})


def test_gn_groups_override():
    sd = _state_dict()
    _, spec = psi.load_scrfd_state_dict(sd, gn_groups=2)
    assert spec.gn_groups == 2
    assert jsi.load_scrfd_state_dict(sd, image_size=(32, 32), gn_groups=2)[2].gn_groups == 2
