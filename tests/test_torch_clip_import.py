"""OpenAI CLIP visual towers into the port's ViT, against the JAX import.

On the clip_tiny_test structure (patch 16, width 64, 2 blocks, projection
32) at 32 px: config detection equals JAX's, and the imported tower's
output equals JAX ``import_clip_visual``'s within 1e-4 of max|output| and
the mirror's own forward at the same bound (f32 sums in other orders),
with and without the softmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models import clip_import as jci
from rs_face_detection_tpu_torch.models import clip_import as pci

from torch_mirrors import CLIPVisualMirror, randomize_state_dict


@pytest.fixture(scope="module")
def mirror():
    return randomize_state_dict(
        CLIPVisualMirror(patch=16, width=64, depth=2, heads=2, proj_dim=32, input_res=32, num_classes=3), seed=11
    )


@pytest.fixture(scope="module")
def sd(mirror):
    return {k: v.detach().numpy() for k, v in mirror.state_dict().items()}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))


def test_config_detection_equals_jax(sd):
    assert pci.clip_config_from_state_dict(sd) == jci.clip_config_from_state_dict(sd) == "clip_tiny_test"
    wide = dict(sd, **{"visual.proj": np.zeros((64, 16), np.float32)})
    for detect in (pci.clip_config_from_state_dict, jci.clip_config_from_state_dict):
        with pytest.raises(ValueError, match="no clip_"):
            detect(wide)


@pytest.mark.parametrize("softmax", [True, False])
def test_tower_equals_jax_and_mirror(sd, mirror, softmax):
    """Tolerance: 1e-4 of max|output|."""
    model, meta = pci.import_clip_visual(sd, num_classes=3, image_size=(32, 32), softmax=softmax)
    jmodel, variables, jmeta = jci.import_clip_visual(sd, num_classes=3, image_size=(32, 32), softmax=softmax)
    assert meta == jmeta
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        logits = mirror(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    _close(got, want)
    _close(got, (torch.softmax(logits, -1) if softmax else logits).numpy())


def test_head_optional_text_keys_ignored_and_strict(sd):
    trunk = {k: v for k, v in sd.items() if not k.startswith("head.")}
    text = dict(trunk, **{"transformer.resblocks.0.ln_1.weight": np.zeros(4, np.float32), "logit_scale": np.ones(())})
    got = pci.load_clip_visual_state_dict(text, "clip_tiny_test", num_classes=2)
    assert got["head.weight"].shape == (2, 32)  # the seeded head
    np.testing.assert_array_equal(got["proj"].numpy(), sd["visual.proj"])
    bad = dict(trunk, **{"visual.unknown.weight": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="extra keys"):
        pci.load_clip_visual_state_dict(bad, "clip_tiny_test")
    pci.load_clip_visual_state_dict(bad, "clip_tiny_test", strict=False)
    with pytest.raises(ValueError, match="not CLIP-structured"):
        pci.load_clip_visual_state_dict(trunk, "vit_tiny_test")
