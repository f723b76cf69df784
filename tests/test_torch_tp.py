"""The port's tensor-parallel ViT (parallel/tp.py) against the JAX package's
on its 8-device virtual CPU mesh; the port as 4 gloo ranks on the CPU, its
attention on K4's plain version.

- ``vit_tp_param_spec``: JAX's test_param_spec_rules cases on the CLIP
  names of the same parameters, the model axis of 1 replicating everything,
  and every parameter covered (6 sharded per block: the packed q/k/v weight
  and bias, ``out_proj.weight``, ``c_fc`` weight and bias, ``c_proj.weight``;
  JAX's 10 count q, k and v apart);
- the packed q/k/v split, checked by rows through models/weights.py's shard
  view of a JAX tree whose q, k and v kernels hold their output feature's
  index: rank r holds rows r W/tp .. (r + 1) W/tp of each of q, k and v;
- ``check_tp_compatible``: JAX's errors;
- ``make_tp_vit_fn`` on ``clip_tiny_test`` and ``vit_tiny_test`` (32x32, 8
  images) at (1, 2) and (2, 2), built from JAX's init through the shard
  view: the probabilities within 1e-5 / 1e-5 of JAX's ``make_tp_vit_fn`` on
  make_mesh(2 | 4, model_parallel=2) (tests/test_tp.py's bound), and the
  probabilities and logits within 1e-5 of the unsharded port module, on
  every rank.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rs_face_detection_tpu.models.vit import init_vit
from rs_face_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rs_face_detection_tpu.parallel.tp import check_tp_compatible as jax_check
from rs_face_detection_tpu.parallel.tp import make_tp_vit_fn as jax_make_tp_vit_fn
from rs_face_detection_tpu.parallel.tp import vit_tp_param_spec as jax_spec
from test_torch_mesh import flat_leaves, run_ranks

CONFIGS = ("clip_tiny_test", "vit_tiny_test")
SPEC_CASES = [  # (JAX path, CLIP name)
    (("block0", "attn", "query", "kernel"), "transformer.resblocks.0.attn.in_proj_weight"),
    (("block0", "attn", "key", "bias"), "transformer.resblocks.0.attn.in_proj_bias"),
    (("block0", "attn", "out", "kernel"), "transformer.resblocks.0.attn.out_proj.weight"),
    (("block0", "attn", "out", "bias"), "transformer.resblocks.0.attn.out_proj.bias"),
    (("block0", "fc1", "kernel"), "transformer.resblocks.0.mlp.c_fc.weight"),
    (("block0", "fc1", "bias"), "transformer.resblocks.0.mlp.c_fc.bias"),
    (("block0", "fc2", "kernel"), "transformer.resblocks.0.mlp.c_proj.weight"),
    (("block0", "fc2", "bias"), "transformer.resblocks.0.mlp.c_proj.bias"),
    (("block0", "ln1", "scale"), "transformer.resblocks.0.ln_1.weight"),
    (("patchify", "kernel"), "conv1.weight"),
]

_BODY = """
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.parallel.mesh import make_mesh
from rs_face_detection_tpu_torch.parallel.tp import (
    check_tp_compatible, make_tp_vit_fn, tp_shard_view, vit_tp_param_spec, vit_tp_shardings)

report = {}
mesh22 = make_mesh(4, model_parallel=2, device="cpu")
mesh12 = make_mesh(2, model_parallel=2, device="cpu")  # ranks 0 and 1
mesh41 = make_mesh(4, device="cpu")
names = json.loads(str(INPUTS["names"]))
report["specs"] = [list(vit_tp_param_spec(n, (4, 4), mesh22)) for n in names]
report["specs1"] = [list(vit_tp_param_spec(n, (4, 4), mesh41)) for n in names]
for args in ((16, 4096), (3, 4096), (16, 4095)):
    try:
        check_tp_compatible(*args, mesh22)
        report[str(args)] = None
    except ValueError as e:
        report[str(args)] = str(e)
marks = {k[len("marks/"):]: v for k, v in INPUTS.items() if k.startswith("marks/")}
view = tp_shard_view(weights.state_dict_from_jax("clip_tiny_test", marks), mesh22)
OUT["rows/w"] = view["transformer.resblocks.0.attn.in_proj_weight"][:, 0].numpy()
OUT["rows/b"] = view["transformer.resblocks.0.attn.in_proj_bias"].numpy()
images = torch.from_numpy(INPUTS["images"]).permute(0, 3, 1, 2).contiguous()
for config in ("clip_tiny_test", "vit_tiny_test"):
    variables = {k[len(config) + 1:]: v for k, v in INPUTS.items() if k.startswith(config + "/")}
    full = weights.load_model(config, weights.state_dict_from_jax(config, variables))
    plain = weights.load_model(config, weights.state_dict_from_jax(config, variables), softmax=False)
    report[config + "/sharded"] = sum("model" in s for s in vit_tp_shardings(full, mesh22).values())
    report[config + "/params"] = len(list(full.named_parameters()))
    with torch.no_grad():
        OUT[config + "/unsharded"] = full(images).numpy()
        OUT[config + "/unsharded_logits"] = plain(images).numpy()
    for tag, mesh in (("2x2", mesh22), ("1x2", mesh12)):
        if mesh.get_coordinate() is None:
            continue
        fn, sharded = make_tp_vit_fn(full, mesh, device="cpu")
        view = tp_shard_view(weights.state_dict_from_jax(config, variables), mesh)
        report[f"{config}/{tag}/view"] = all(torch.equal(p, view[n]) for n, p in sharded.named_parameters())
        report[f"{config}/{tag}/qkv_rows"] = sharded.transformer.resblocks[0].attn.in_proj_weight.shape[0]
        report[f"{config}/{tag}/heads"] = sharded.transformer.resblocks[0].attn.heads
        OUT[f"{config}/{tag}"] = fn(images).numpy()
        fn_logits, _ = make_tp_vit_fn(plain, mesh, device="cpu")
        OUT[f"{config}/{tag}/logits"] = fn_logits(images).numpy()
OUT["report"] = np.asarray(json.dumps(report))
"""


def _port_spec(path, spec):
    """JAX's spec of a flax leaf on the port's tensor: q/k/v kernels (W, H,
    D) and biases (H, D) pack head-major into the rows of ``in_proj_*``,
    the out kernel (H, D, W) into the columns of ``out_proj.weight``, and
    the dense kernels (in, out) transpose to (out, in)."""
    spec = list(spec)
    if "model" not in spec:
        return []
    proj, leaf = path[-2], path[-1]
    if proj in ("query", "key", "value"):
        return ["model", None] if leaf == "kernel" else ["model"]
    if proj == "out":
        return [None, "model"]
    return spec[::-1] if leaf == "kernel" else spec


def _marked_tree(variables):
    """JAX's clip_tiny_test tree with each q, k and v kernel and bias of
    block 0 holding its output feature's packed row index (q from 0, k from
    W, v from 2W)."""
    flat = dict(flat_leaves(variables))
    width, heads, dim = flat["params/block0/attn/query/kernel"].shape
    for i, proj in enumerate(("query", "key", "value")):
        rows = (i * width + np.arange(heads * dim, dtype=np.float32)).reshape(heads, dim)
        flat[f"params/block0/attn/{proj}/kernel"] = np.broadcast_to(rows, (width, heads, dim)).copy()
        flat[f"params/block0/attn/{proj}/bias"] = rows.copy()
    return flat, width


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    images = np.random.default_rng(0).normal(size=(8, 32, 32, 3)).astype(np.float32)
    inputs = {"images": images, "names": np.asarray(json.dumps([name for _, name in SPEC_CASES]))}
    jax_out = {}
    for config in CONFIGS:
        model, variables = init_vit(config, num_classes=2, image_size=(32, 32))
        for k, v in flat_leaves(variables).items():
            inputs[f"{config}/{k}"] = v
        for n in (2, 4):
            fwd, sharded_vars = jax_make_tp_vit_fn(model, variables, jax_make_mesh(n, model_parallel=2))
            jax_out[(config, n)] = np.asarray(fwd(sharded_vars, jnp.asarray(images)))
    marks, width = _marked_tree(init_vit("clip_tiny_test", num_classes=2, image_size=(32, 32))[1])
    inputs.update({f"marks/{k}": v for k, v in marks.items()})
    ranks = run_ranks(tmp_path_factory.mktemp("tp"), 4, _BODY, inputs, timeout=180)
    return jax_out, ranks, width


def test_param_spec_rules_match_jax(tp_runs):
    _, ranks, _ = tp_runs
    mesh = jax_make_mesh(8, model_parallel=2)
    jax_specs = [jax_spec(tuple(jax.tree_util.DictKey(n) for n in ("params", *path)), (4, 4), mesh)
                 for path, _ in SPEC_CASES]
    want = [_port_spec(path, spec) for (path, _), spec in zip(SPEC_CASES, jax_specs)]
    assert want[0] == ["model", None] and want[2] == [None, "model"] and want[8] == []
    for rank in ranks:
        report = json.loads(str(rank["report"]))
        assert report["specs"] == want
        assert report["specs1"] == [[]] * len(SPEC_CASES)


def test_packed_qkv_split_by_heads(tp_runs):
    """Rank r (model index r % 2) holds rows r W/2 .. (r + 1) W/2 of each of
    q, k and v, in that order, in the weight and in the bias."""
    _, ranks, width = tp_runs
    for r, rank in enumerate(ranks):
        half = width // 2
        lo = (r % 2) * half
        want = np.concatenate([i * width + np.arange(lo, lo + half) for i in range(3)]).astype(np.float32)
        np.testing.assert_array_equal(rank["rows/w"], want)
        np.testing.assert_array_equal(rank["rows/b"], want)


def test_check_tp_compatible_matches_jax(tp_runs):
    _, ranks, _ = tp_runs
    mesh = jax_make_mesh(8, model_parallel=2)
    for args in ((16, 4096), (3, 4096), (16, 4095)):
        try:
            jax_check(*args, mesh)
            want = None
        except ValueError as e:
            want = str(e)
        for rank in ranks:
            assert json.loads(str(rank["report"]))[str(args)] == want
    assert want is not None


@pytest.mark.parametrize("config", CONFIGS)
def test_tp_shardings_cover_all_params(tp_runs, config):
    _, ranks, _ = tp_runs
    report = json.loads(str(ranks[0]["report"]))
    assert report[config + "/sharded"] == 2 * 6
    assert report[config + "/params"] > 2 * 6


@pytest.mark.parametrize("tag,n", [("1x2", 2), ("2x2", 4)])
@pytest.mark.parametrize("config", CONFIGS)
def test_tp_forward_matches_jax_and_unsharded(tp_runs, config, tag, n):
    jax_out, ranks, _ = tp_runs
    want = jax_out[(config, n)]
    members = ranks if tag == "2x2" else ranks[:2]
    for rank in members:
        report = json.loads(str(rank["report"]))
        assert report[f"{config}/{tag}/view"]
        assert report[f"{config}/{tag}/heads"] == 1
        assert report[f"{config}/{tag}/qkv_rows"] == 3 * 64 // 2
        got = rank[f"{config}/{tag}"]
        assert got.shape == want.shape == (8, 2)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, rank[config + "/unsharded"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rank[f"{config}/{tag}/logits"], rank[config + "/unsharded_logits"],
                                   rtol=1e-5, atol=1e-5)
