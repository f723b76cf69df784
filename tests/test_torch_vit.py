"""models/vit.py: the port's ViT against the JAX package's flax ViT on the
same bridged weights, with the port's attention on its plain version (the
CPU path of K4's dispatcher).

f32: probabilities within 1e-5 (f32 sums in another order).
bf16, the serving precision (JAX: ``clone(dtype=bf16)`` plus
``cast_kernels``; the port: ``cast_for_serving``): probabilities within
1e-2 (2.8e-3 is the largest difference these cases show).  The two round
at other places: flax scales q by 1/sqrt(D) in bf16, takes the softmax in
bf16 and rounds every einsum to bf16, while the port takes scores, softmax
and PV in f32 (as K4 does) and rounds once; bf16 keeps 8 bits, so each
rounding moves a value by up to 2^-9 of itself, and the difference grows
through the residual stream of every block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models.precision import cast_kernels
from rs_face_detection_tpu.models.vit import ViT as JViT
from rs_face_detection_tpu.models.vit import _CONFIGS as JCONFIGS
from rs_face_detection_tpu.models.vit import init_vit
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.vit import CONFIGS, ViT, cast_for_serving

torch.set_num_threads(2)

CASES = [("clip_tiny_test", 64), ("clip_tiny_test", 224), ("vit_tiny_test", 64), ("vit_tiny_test", 224)]


def _pair(config, size, seed=0):
    model, variables = init_vit(config, 2, (size, size), seed=seed)
    port = weights.load_model(config, weights.state_dict_from_jax(config, variables))
    return model, variables, port


def _inputs(size, seed=0):
    return np.random.default_rng(seed).normal(size=(2, size, size, 3)).astype(np.float32)


def _port_probs(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()


def test_configs_copy_the_jax_configs():
    assert {k: tuple(v) for k, v in CONFIGS.items()} == {k: tuple(v) for k, v in JCONFIGS.items()}


@pytest.mark.parametrize("config,size", CASES, ids=lambda c: str(c))
def test_vit_matches_flax_f32(config, size):
    model, variables, port = _pair(config, size)
    x = _inputs(size)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    got = _port_probs(port, x)
    assert got.shape == want.shape == (2, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("config,size", CASES, ids=lambda c: str(c))
def test_vit_matches_flax_bf16(config, size):
    model, variables, port = _pair(config, size, seed=1)
    x = _inputs(size, seed=1)
    jmodel = model.clone(dtype=jnp.bfloat16)
    want = np.asarray(jmodel.apply(cast_kernels(variables), jnp.asarray(x), train=False))
    cast_for_serving(port)
    assert port.conv1.weight.dtype == torch.bfloat16
    assert port.transformer.resblocks[0].attn.in_proj_weight.dtype == torch.bfloat16
    assert port.ln_post.weight.dtype == torch.float32
    got = _port_probs(port, x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)


def test_bridge_packs_qkv_in_order():
    """in_proj rows are q, k, v; each (heads, head_dim) head-major."""
    _, variables, port = _pair("clip_tiny_test", 64)
    attn = variables["params"]["block0"]["attn"]
    w = port.transformer.resblocks[0].attn.in_proj_weight.detach().numpy()
    for j, name in enumerate(("query", "key", "value")):
        kernel = np.asarray(attn[name]["kernel"])  # (W, H, D)
        np.testing.assert_array_equal(w[j * 64 : (j + 1) * 64], kernel.reshape(64, 64).T)


@pytest.mark.parametrize("config", ["clip_tiny_test", "vit_tiny_test"])
def test_bridge_reads_every_leaf(config):
    _, variables = init_vit(config, 2, (64, 64), seed=0)
    leaves = set(weights.flat_variables(jax.tree.map(np.asarray, variables)))
    assert weights.mapped_leaves(config) == leaves


def test_bridge_map_covers_clip_l14():
    """Every leaf of the full-size flax clip_l14 tower, by shapes only, and
    every parameter of the port's tower (built on the meta device)."""
    model = JViT(config="clip_l14", num_classes=2)
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False),
        jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32),
    )
    leaves = set()

    def walk(node, prefix):
        if isinstance(node, dict) or hasattr(node, "items"):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        else:
            leaves.add(prefix.rstrip("/"))

    walk(shapes, "")
    assert len(leaves) > 24 * 12
    assert weights.mapped_leaves("clip_l14") == leaves
    with torch.device("meta"):
        port = ViT("clip_l14", 2, 224)
    assert sum(p.numel() for p in port.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)
    )
    targets = {spec[0] for spec in weights.mapping_for("clip_l14").values()}
    for name, _ in port.named_parameters():
        assert any(name == t or name.startswith(t + ".") for t in targets), name
