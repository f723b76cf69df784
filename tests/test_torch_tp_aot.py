"""The tensor-parallel ViT's artifacts (runtime/aot.py::export_tp_vit /
load_tp_vit) against the JAX package's on the same weights: the port of
tests/test_tp.py::test_tp_vit_aot_roundtrip.

Two spawns of 4 gloo ranks on the CPU (tests/test_torch_mesh.py::run_ranks),
each under a deadline, on ``clip_tiny_test`` at 32x32, b8, built from JAX's
init through models/weights.py::state_dict_from_jax:

- the export job builds the (2, 2) mesh and, on ranks 0-1, the (1, 2) one,
  as tests/test_torch_tp.py does, and exports both; every rank gets the
  same bytes, and ranks 0-1 get them again from a second export of the
  (1, 2) mesh more than 2 s later (a zip's entries carry a date at 2 s
  resolution); a batch of 3 is refused ("divisible");
- the loader job is fresh processes that build the meshes in the same
  order, load each rank's program, prepare the unsharded state and run the
  whole batch: on every rank torch.equal to its live ``make_tp_vit_fn``
  forward and within 1e-5 of JAX's loaded ``export_tp_vit`` artifact on
  make_mesh(2 | 4, model_parallel=2) (tests/test_tp.py's bound); each
  program holds one ``rsfd::attention`` node per block and no constant of a
  weight's shape.  It then checks the refusals: a (2, 1) mesh ("mesh"), the
  axes in the other order, a state leaf of the wrong shape, one rank's
  program alone (a foreign blob), and, after a new process group whose
  meshes are built in the other order (names start again from the same
  counter, as in a fresh process), the group-name mismatch.
"""

import io
import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest

from rs_face_detection_tpu.models.vit import init_vit
from rs_face_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rs_face_detection_tpu.runtime.aot import export_tp_vit as jax_export_tp_vit
from rs_face_detection_tpu.runtime.aot import load_tp_vit as jax_load_tp_vit
from test_torch_mesh import flat_leaves, run_ranks

CONFIG = "clip_tiny_test"
DEPTH = 2
MESHES = {"1x2": 2, "2x2": 4}  # tag: devices, model_parallel=2

_EXPORT = """
import time

from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.parallel.mesh import make_mesh
from rs_face_detection_tpu_torch.runtime.aot import export_tp_vit

variables = {k[len("var/"):]: v for k, v in INPUTS.items() if k.startswith("var/")}
full = weights.load_model("clip_tiny_test", weights.state_dict_from_jax("clip_tiny_test", variables))
report = {}
meshes = {"2x2": make_mesh(4, model_parallel=2, device="cpu"), "1x2": make_mesh(2, model_parallel=2, device="cpu")}
for tag, mesh in meshes.items():
    if mesh.get_coordinate() is not None:
        OUT["blob/" + tag] = np.frombuffer(export_tp_vit(full, mesh, 8, (32, 32), device="cpu"), np.uint8)
if meshes["1x2"].get_coordinate() is not None:
    time.sleep(2.1)
    OUT["again/1x2"] = np.frombuffer(export_tp_vit(full, meshes["1x2"], 8, (32, 32), device="cpu"), np.uint8)
try:
    export_tp_vit(full, meshes["2x2"], 3, (32, 32), device="cpu")
except ValueError as e:
    report["divisible"] = str(e)
OUT["report"] = np.asarray(json.dumps(report))
"""

_LOAD = """
import io
import zipfile

from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from rs_face_detection_tpu_torch.parallel.tp import make_tp_vit_fn
from rs_face_detection_tpu_torch.runtime.aot import load_tp_vit

variables = {k[len("var/"):]: v for k, v in INPUTS.items() if k.startswith("var/")}
state = weights.state_dict_from_jax("clip_tiny_test", variables)
full = weights.load_model("clip_tiny_test", state)
images = torch.from_numpy(INPUTS["images"]).permute(0, 3, 1, 2).contiguous()
blobs = {tag: INPUTS["blob/" + tag].tobytes() for tag in ("2x2", "1x2")}
report = {}


def refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


meshes = {"2x2": make_mesh(4, model_parallel=2, device="cpu"), "1x2": make_mesh(2, model_parallel=2, device="cpu")}
for tag, mesh in meshes.items():
    if mesh.get_coordinate() is None:
        continue
    loaded = load_tp_vit(blobs[tag], mesh, device="cpu")
    out = loaded(state, images)
    again = loaded(state, images)
    fn, _ = make_tp_vit_fn(full, mesh, device="cpu")
    live = fn(images)
    OUT["out/" + tag] = out.numpy()
    nodes = [n for n in loaded.program.graph.nodes if n.op == "call_function"]
    shapes = {tuple(v.shape) for v in loaded.prepare_state(state).values()}
    report[tag] = {
        "equal_live": bool(torch.equal(out, live)),
        "equal_again": bool(torch.equal(out, again)),
        "coordinate": loaded.coordinate,
        "attention_nodes": sum(str(n.target) == "rsfd.attention.default" for n in nodes),
        "collectives": sorted({str(n.target) for n in nodes if "c10d" in str(n.target)}),
        "params_in_program": len(loaded.program.state_dict),
        "weight_constants": sum(tuple(getattr(c, "shape", ())) in shapes for c in loaded.program.constants.values()),
    }
mesh = meshes["2x2"]
bad = dict(state)
bad["transformer.resblocks.1.mlp.c_fc.weight"] = bad["transformer.resblocks.1.mlp.c_fc.weight"][:-2]
loaded = load_tp_vit(blobs["2x2"], mesh, device="cpu")
report["leaf"] = refusal(lambda: loaded.prepare_state(bad))
with zipfile.ZipFile(io.BytesIO(blobs["2x2"])) as z:
    one_program = z.read("program_0_0.pt2")
report["foreign"] = refusal(lambda: load_tp_vit(one_program, mesh, device="cpu"))
report["mesh"] = refusal(lambda: load_tp_vit(blobs["2x2"], make_mesh(4, device="cpu"), device="cpu"))
report["axes"] = refusal(lambda: load_tp_vit(
    blobs["2x2"], make_mesh(4, model_parallel=2, axis_names=("model", "data"), device="cpu"), device="cpu"))
# A new process group builds its meshes in the other order: the group names
# start from the same counter as in a fresh process, and bind other groups.
torch.distributed.destroy_process_group()
initialize_distributed("file://" + os.path.join(WORK, "store2"), WORLD, RANK, device="cpu")
other = make_mesh(2, model_parallel=2, device="cpu")
mesh = make_mesh(4, model_parallel=2, device="cpu")
report["group"] = refusal(lambda: load_tp_vit(blobs["2x2"], mesh, device="cpu"))
OUT["report"] = np.asarray(json.dumps(report))
"""


@pytest.fixture(scope="module")
def tp_aot(tmp_path_factory):
    model, variables = init_vit(CONFIG, num_classes=2, image_size=(32, 32))
    images = np.random.default_rng(7).normal(size=(8, 32, 32, 3)).astype(np.float32)
    jax_out, jax_meta = {}, {}
    for tag, n in MESHES.items():
        mesh = jax_make_mesh(n, model_parallel=2)
        loaded = jax_load_tp_vit(jax_export_tp_vit(model, variables, mesh, batch_size=8, image_size=(32, 32)), mesh)
        jax_out[tag] = np.asarray(loaded(loaded.prepare_variables(variables), jnp.asarray(images)))
        jax_meta[tag] = loaded.meta
    inputs = {f"var/{k}": v for k, v in flat_leaves(variables).items()}
    exported = run_ranks(tmp_path_factory.mktemp("tp_aot_export"), 4, _EXPORT, inputs, timeout=240)
    inputs.update({"images": images, "blob/2x2": exported[0]["blob/2x2"], "blob/1x2": exported[0]["blob/1x2"]})
    loaded = run_ranks(tmp_path_factory.mktemp("tp_aot_load"), 4, _LOAD, inputs, timeout=240)
    reports = [json.loads(str(r["report"])) for r in loaded]
    return {"jax_out": jax_out, "jax_meta": jax_meta, "exported": exported, "loaded": loaded, "reports": reports,
            "export_reports": [json.loads(str(r["report"])) for r in exported]}


def _members(tag):
    return range(MESHES[tag])  # (1, 2) holds ranks 0-1, (2, 2) all four


@pytest.mark.parametrize("tag", MESHES)
def test_every_rank_gets_one_artifact_with_jax_meta(tp_aot, tag):
    blobs = [r["blob/" + tag] for r in tp_aot["exported"] if "blob/" + tag in r]
    assert len(blobs) == MESHES[tag]
    assert all(np.array_equal(b, blobs[0]) for b in blobs)
    with zipfile.ZipFile(io.BytesIO(blobs[0].tobytes())) as z:
        meta = json.loads(z.read("rsfd_meta.json"))
        programs = sorted(n for n in z.namelist() if n.endswith(".pt2"))
    jax_meta = tp_aot["jax_meta"][tag]
    for key in ("config", "num_classes", "batch_size", "image_size", "mesh_shape", "mesh_axes", "nr_devices"):
        assert meta[key] == jax_meta[key], key
    assert meta["format"] == "rsfd-aot-tp-vit-v1" and meta["layout"] == "nchw" and meta["dtype"] == "float32"
    data = jax_meta["mesh_shape"]["data"]
    coords = [[d, m] for d in range(data) for m in range(2)]
    assert [r["coordinate"] for r in meta["ranks"]] == coords
    assert programs == sorted(f"program_{d}_{m}.pt2" for d, m in coords)
    for entry in meta["ranks"]:
        rank = 2 * entry["coordinate"][0] + entry["coordinate"][1]
        assert entry["groups"]["model"]["ranks"] == [rank - rank % 2, rank - rank % 2 + 1]
        assert entry["groups"]["data"]["ranks"] == list(range(rank % 2, 2 * data, 2))
        assert entry["device"] == "cpu" and len(entry["state"]) > 0


def test_export_is_reproducible(tp_aot):
    for r in _members("1x2"):
        got = tp_aot["exported"][r]
        assert np.array_equal(got["again/1x2"], got["blob/1x2"])


@pytest.mark.parametrize("tag", MESHES)
def test_loaded_programs_equal_live_and_match_jax(tp_aot, tag):
    want = tp_aot["jax_out"][tag]
    for r in _members(tag):
        report = tp_aot["reports"][r][tag]
        assert report["coordinate"] == [r // 2, r % 2]
        assert report["equal_live"] and report["equal_again"]
        got = tp_aot["loaded"][r]["out/" + tag]
        assert got.shape == want.shape == (8, 2)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tag", MESHES)
def test_programs_hold_k4_and_no_weights(tp_aot, tag):
    for r in _members(tag):
        report = tp_aot["reports"][r][tag]
        assert report["attention_nodes"] == DEPTH
        assert report["params_in_program"] == 0 and report["weight_constants"] == 0
        want = {"_c10d_functional.all_reduce.default", "_c10d_functional.wait_tensor.default"}
        if tag == "2x2":
            want.add("_c10d_functional.all_gather_into_tensor.default")
        assert set(report["collectives"]) == want


@pytest.mark.parametrize(
    "kind,match",
    [
        ("divisible", "divisible"),
        ("mesh", "mesh"),
        ("axes", "mesh axes"),
        ("group", "process group"),
        ("foreign", "not an rsfd rsfd-aot-tp-vit-v1 artifact"),
        ("leaf", "transformer.resblocks.1.mlp.c_fc.weight"),
    ],
)
def test_refusals(tp_aot, kind, match):
    reports = tp_aot["export_reports"] if kind == "divisible" else tp_aot["reports"]
    for report in reports:
        assert report[kind] is not None and match in report[kind], report[kind]
    if kind == "group":
        assert "'model'" in reports[0][kind] or "'data'" in reports[0][kind]
