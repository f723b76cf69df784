"""The port's Triton wire protocol (runtime/wire.py) against the JAX package's.

A JAX server and a port server on port 0 serve the same weights (the
trained 64-px detector of tests/fixtures/trained_mnet64.npz and two
SmallCNN heads, bridged by models/weights.py), and the JAX package's own
``TritonWireClient`` talks to both:

  - health, readiness, the gRPC health check, RepositoryIndex, Load and
    Unload, LogSettings and ModelConfig give equal answers (ModelConfig and
    ModelMetadata but for ``platform``/``backend``: Triton's
    "pytorch_libtorch" against "jax_xla");
  - ModelInfer (typed and raw contents), ModelStreamInfer, a shared-memory
    infer and an ensemble agree within the port's network tolerances:
    detection maps atol 1e-4 (tests/test_torch_models.py), SmallCNN
    outputs 1e-5 of max|output| (tests/test_torch_heads.py); the port's
    detection view equals its module's direct forward bit for bit;
  - the error cases give the same status codes and details, except the
    CUDA shared-memory refusal, whose detail in the JAX copy describes TPU
    memory: same code, the port's own text;
  - ModelStatistics counts are equal after the same traffic;
  - dynamic batching coalesces, and the two faults of the JAX copy are left
    out: after ``close()`` no batcher is created (F2), and loading an
    ensemble whose member is missing names the member (F3).
"""

import os
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

grpc = pytest.importorskip("grpc")

from rs_face_detection_tpu.models import registry as jreg
from rs_face_detection_tpu.models.heads import init_small_cnn as j_init_small_cnn
from rs_face_detection_tpu.models.retinaface import init_retinaface
from rs_face_detection_tpu.runtime import repository as jrepo
from rs_face_detection_tpu.runtime import wire as jwire
from rs_face_detection_tpu.runtime.server import serve as jserve
from rs_face_detection_tpu.runtime.shm import SharedRegion as JSharedRegion
from rs_face_detection_tpu.runtime.wire import TritonWireClient
from rs_face_detection_tpu_torch.models import registry as preg
from rs_face_detection_tpu_torch.models import weights
from rs_face_detection_tpu_torch.models.heads import SmallCNN, small_cnn_map
from rs_face_detection_tpu_torch.runtime import proto3 as pproto3
from rs_face_detection_tpu_torch.runtime import repository as prepo
from rs_face_detection_tpu_torch.runtime import wire as pwire
from rs_face_detection_tpu_torch.runtime.server import serve as pserve

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
WIDTHS = (8, 16)
DET = "face_detection_retina"
MAPS_ATOL = 1e-4
HEAD_RTOL = 1e-5


def small_pair(num_outputs, size, seed):
    """(JAX SmallCNN, its variables, the port's SmallCNN on the same weights)."""
    model, variables = j_init_small_cnn(num_outputs, size, widths=WIDTHS, seed=seed)
    variables = jax.tree.map(np.asarray, variables)
    port = SmallCNN(num_outputs, WIDTHS).eval()
    port.load_state_dict(weights.state_dict_from_jax("small_cnn", variables, mapping=small_cnn_map(WIDTHS)))
    return model, variables, port


def registries(spec_kw=None):
    """A JAX and a port (CPU) registry with the detector and two heads,
    registered as builders (loaded), as JAX's tests/test_wire.py serves."""
    det_model, _ = init_retinaface("mobilenet025", (64, 64), seed=0)
    det_vars = jreg._unflatten(weights.flat_variables(os.path.join(FIXTURES, "trained_mnet64.npz")))
    det_port = weights.load_model("retinaface_mobilenet025", weights.state_dict_from_jax("retinaface_mobilenet025", det_vars))
    entries = {
        DET: ((64, 64, 3), det_model, det_vars, det_port),
        "face_quality": ((32, 32, 3), *small_pair(4, (32, 32), 1)),
        "face_identification": ((32, 32, 3), *small_pair(16, (32, 32), 2)),
    }
    j, p = jreg.ModelRegistry(), preg.ModelRegistry("cpu")
    for name, (shape, model, variables, port) in entries.items():
        kw = dict(name=name, input_shape=shape, output_spec="test", **(spec_kw or {}).get(name, {}))
        j.register_builder(name, lambda kw=kw, m=model, v=variables: (jreg.ModelSpec(**kw), m, v))
        p.register_builder(name, lambda kw=kw, m=port: (preg.ModelSpec(**kw), m))
        j.load(name)
        p.load(name)
    return j, p


@pytest.fixture(scope="module")
def servers():
    j, p = registries()
    js, ps = jserve(None, j, port=0), pserve(None, p, port=0)
    jc, pc = TritonWireClient(f"localhost:{js._rsfd_port}", timeout_s=60), TritonWireClient(f"localhost:{ps._rsfd_port}", timeout_s=60)
    yield {"jax": (js, j, jc), "port": (ps, p, pc)}
    for c in (jc, pc):
        c.close()
    js.stop(0)
    ps.stop(0)


def both(servers, fn):
    """fn(client) on the JAX server and on the port's: (jax, port)."""
    return fn(servers["jax"][2]), fn(servers["port"][2])


def rpc_error(fn):
    """(code, details) of the RpcError fn() raises."""
    with pytest.raises(grpc.RpcError) as e:
        fn()
    return e.value.code(), e.value.details()


# -- health, config, metadata, repository --------------------------------------


def test_health_and_readiness_match(servers):
    for ask in (
        lambda c: c.server_live(),
        lambda c: c.server_ready(),
        lambda c: c.model_ready("face_quality"),
        lambda c: c.model_ready("nope"),
        lambda c: c.health_check(),
        lambda c: c.health_check(pwire.SERVICE),
        lambda c: c.health_check(pwire.HEALTH_SERVICE),
    ):
        j, p = both(servers, ask)
        assert j == p
    j, p = both(servers, lambda c: rpc_error(lambda: c.health_check("no.such.Service")))
    assert j == p and j[0] == grpc.StatusCode.NOT_FOUND


@pytest.mark.parametrize("name", [DET, "face_quality", "face_identification"])
def test_model_config_and_metadata_match(servers, name):
    jc, pc = both(servers, lambda c: c.model_config(name))
    assert (pc["platform"], pc["backend"]) == ("pytorch_libtorch", "rs_face_detection_tpu_torch")
    assert jc["platform"] == "jax_xla"
    drop = ("platform", "backend")
    assert {k: v for k, v in pc.items() if k not in drop} == {k: v for k, v in jc.items() if k not in drop}
    jm, pm = both(servers, lambda c: c.model_metadata(name))
    assert pm.pop("platform") == "pytorch_libtorch" and jm.pop("platform") == "jax_xla"
    assert pm == jm


def test_repository_verbs_and_log_settings_match(servers):
    j, p = both(servers, lambda c: c.repository_index())
    assert j == p
    assert both(servers, lambda c: c.repository_index(ready_only=True))[1] == p
    for c in (servers["jax"][2], servers["port"][2]):
        c.repository_model_unload("face_identification")
    j, p = both(servers, lambda c: (c.model_ready("face_identification"), c.repository_index()))
    assert j == p and j[0] is False
    for c in (servers["jax"][2], servers["port"][2]):
        c.repository_model_load("face_identification")
    j, p = both(servers, lambda c: (c.model_ready("face_identification"), c.repository_index(True)))
    assert j == p and j[0] is True
    j, p = both(servers, lambda c: rpc_error(lambda: c.repository_model_load("absent")))
    assert j == p and j[0] == grpc.StatusCode.NOT_FOUND
    j, p = both(servers, lambda c: c.log_settings())
    assert j == p
    j, p = both(servers, lambda c: rpc_error(lambda: c.log_settings({"no_such_setting": True})))
    assert j == p and j[0] == grpc.StatusCode.INVALID_ARGUMENT


# -- inference -----------------------------------------------------------------


def assert_outputs_close(got, want, atol=None):
    assert [(n, s) for n, s, _ in got] == [(n, s) for n, s, _ in want]
    for (_, _, g), (_, _, w) in zip(got, want):
        tol = atol if atol is not None else HEAD_RTOL * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("use_raw", [False, True], ids=["typed", "raw"])
@pytest.mark.parametrize("name", [DET, "face_quality", "face_identification"])
def test_model_infer_matches_jax(servers, name, use_raw):
    shape = (1, 3, 64, 64) if name == DET else (2, 3, 32, 32)
    x = np.random.default_rng(len(name)).normal(size=shape).astype(np.float32)
    j, p = both(servers, lambda c: c.model_infer(name, x, use_raw=use_raw))
    assert_outputs_close(p, j, MAPS_ATOL if name == DET else None)


def test_detection_view_equals_the_direct_forward(servers):
    """The reference's flow: ModelConfig, then ModelInfer with the config's
    dims; the 9 maps equal detection_triton_view of the module's own forward
    bit for bit."""
    _, reg, client = servers["port"]
    cfg = client.model_config(DET)
    (inp,) = cfg["input"]
    names = [o["name"] for o in cfg["output"]]
    x = np.random.default_rng(0).normal(size=inp["dims"]).astype(np.float32)
    outs = client.model_infer(DET, x, input_name=inp["name"], requested_outputs=names)
    assert [n for n, _, _ in outs] == names and len(names) == 9
    with torch.inference_mode():
        net = reg.get(DET)(torch.from_numpy(x))
    net = {s: {k: v.numpy() for k, v in maps.items()} for s, maps in net.items()}
    for (_, _, got), want in zip(outs, pwire.detection_triton_view(net, (32, 16, 8))):
        np.testing.assert_array_equal(got, want)


def test_stream_infer_matches_jax(servers):
    """ModelStreamInfer: results and a mid-stream error (the stream stays up)."""
    x = np.random.default_rng(5).normal(size=(1, 3, 32, 32)).astype(np.float32)
    good = {"model_name": "face_quality", "inputs": [{"name": "data", "datatype": "FP32", "shape": [1, 3, 32, 32],
                                                       "contents": {"fp32_contents": x.reshape(-1).tolist()}}]}
    bad = dict(good, model_name="absent")

    def stream(client_target):
        channel = grpc.insecure_channel(client_target)
        try:
            call = channel.stream_stream(
                f"/{pwire.SERVICE}/ModelStreamInfer",
                request_serializer=lambda m: pproto3.encode_message(pwire.MODEL_INFER_REQUEST, m),
                response_deserializer=lambda b: pproto3.decode_message(pwire.MODEL_STREAM_INFER_RESPONSE, b),
            )
            return list(call(iter([good, bad, good]), timeout=60))
        finally:
            channel.close()

    j = stream(f"localhost:{servers['jax'][0]._rsfd_port}")
    p = stream(f"localhost:{servers['port'][0]._rsfd_port}")
    assert [r["error_message"] for r in p] == [r["error_message"] for r in j]
    assert p[1]["error_message"].startswith("[NOT_FOUND]")
    for i in (0, 2):
        g = np.frombuffer(p[i]["infer_response"]["raw_output_contents"][0], "<f4")
        w = np.frombuffer(j[i]["infer_response"]["raw_output_contents"][0], "<f4")
        np.testing.assert_allclose(g, w, rtol=0, atol=HEAD_RTOL * float(np.abs(w).max()))


def test_shm_infer_equals_the_inline_infer(servers, tmp_path):
    """A system-shared-memory ModelInfer (input and output in the region)
    equals the inline one, in both servers; status and unregister match."""
    x = np.random.default_rng(6).normal(size=(1, 3, 32, 32)).astype(np.float32)
    for who in ("jax", "port"):
        _, _, client = servers[who]
        key = f"rsfd_wire_{who}_{os.getpid()}"
        with JSharedRegion.create(key, 1 << 16) as region:
            region.write_array(x)
            client.system_shared_memory_register("r0", key, 1 << 16)
            try:
                assert client.system_shared_memory_status() == {
                    "r0": {"name": "r0", "key": key, "offset": 0, "byte_size": 1 << 16}}
                ((_, shape, ref),) = client.model_infer_shm(
                    "face_quality", x, "r0", output_region=("r0", 4096), requested_outputs=["output"])
                assert ref == ("r0", 4096, 16)
                got = region.read_array(np.float32, shape, 4096)
                ((_, _, inline),) = client.model_infer("face_quality", x)
                np.testing.assert_array_equal(got, inline)
            finally:
                client.system_shared_memory_unregister("r0")
    j, p = both(servers, lambda c: rpc_error(lambda: c.system_shared_memory_unregister("r0")))
    assert j == p and j[0] == grpc.StatusCode.NOT_FOUND


def test_error_cases_match(servers):
    """Same status codes and details from both servers."""
    x = np.zeros((1, 3, 32, 32), np.float32)
    cases = {
        "unknown model config": lambda c: c.model_config("missing_model"),
        "unknown model infer": lambda c: c.model_infer("missing_model", x),
        "unknown model metadata": lambda c: c.model_metadata("missing_model"),
        "unknown model statistics": lambda c: c.model_statistics("missing_model"),
        "bad rank": lambda c: c.model_infer("face_quality", x[0]),
        "unknown output": lambda c: c.model_infer("face_quality", x, requested_outputs=["nope"]),
        "cuda shm status": lambda c: c.cuda_shared_memory_status("gpu0"),
        "shm not registered": lambda c: c.system_shared_memory_status("nope"),
    }
    for what, fn in cases.items():
        j, p = both(servers, lambda c: rpc_error(lambda: fn(c)))
        assert p[0] == j[0], what
        if what != "cuda shm status":  # the JAX detail names a TPU host
            assert p[1] == j[1], what
    bad_dtype = {"model_name": "face_quality", "inputs": [{"name": "data", "datatype": "FP8", "shape": [1]}],
                 "raw_input_contents": [b"\0"]}
    j, p = both(servers, lambda c: rpc_error(lambda: c._unary(
        "ModelInfer", pwire.MODEL_INFER_REQUEST, pwire.MODEL_INFER_RESPONSE, bad_dtype)))
    assert j == p and j[0] == grpc.StatusCode.INVALID_ARGUMENT
    # CUDA shared memory: refused with JAX's status; unregister-all is a no-op
    j, p = both(servers, lambda c: rpc_error(lambda: c.cuda_shared_memory_register("g", b"h", 0, 16)))
    assert p[0] == j[0] == grpc.StatusCode.UNIMPLEMENTED
    assert "system shared memory" in p[1] and "TPU" not in p[1]
    assert both(servers, lambda c: (c.cuda_shared_memory_status(), c.cuda_shared_memory_unregister()))[1] == ({}, None)


def test_statistics_match_after_the_same_traffic():
    j, p = registries()
    js, ps = jserve(None, j, port=0), pserve(None, p, port=0)
    clients = [TritonWireClient(f"localhost:{s._rsfd_port}", timeout_s=60) for s in (js, ps)]
    try:
        rng = np.random.default_rng(7)
        traffic = [("face_quality", (1, 3, 32, 32)), ("face_quality", (3, 3, 32, 32)), (DET, (1, 3, 64, 64)),
                   ("face_quality", (1, 3, 32, 32))]
        for name, shape in traffic:
            x = rng.normal(size=shape).astype(np.float32)
            for c in clients:
                c.model_infer(name, x)
        got = [c.model_statistics() for c in clients]

        def counts(stats):
            return [
                (s["name"], s["inference_count"], s["execution_count"],
                 [(b["batch_size"], b["compute_infer"]["count"]) for b in s["batch_stats"]],
                 s["inference_stats"]["success"]["count"], s["memory_usage"])
                for s in stats
            ]

        assert counts(got[1]) == counts(got[0])
        by_name = {c[0]: c for c in counts(got[1])}
        assert by_name["face_quality"][1:4] == (5, 3, [(1, 2), (3, 1)])
        assert by_name[DET][1:4] == (1, 1, [(1, 1)])
    finally:
        for c in clients:
            c.close()
        js.stop(0)
        ps.stop(0)


# -- ensembles, dynamic batching, the two faults --------------------------------


class ScaleNCHW(nn.Module):
    """Toy member: NCHW in, NCHW out, scaled by k (a parameter, so the
    wire casts to its dtype)."""

    def __init__(self, k):
        super().__init__()
        self.k = nn.Parameter(torch.tensor(float(k)), requires_grad=False)

    def forward(self, x):
        return x * self.k


class JScaleNCHW:
    """The same member for the JAX registry: the JAX wire hands it NHWC."""

    def __init__(self, k):
        self.k = float(k)

    def apply(self, variables, x):
        import jax.numpy as jnp

        return jnp.transpose(x * self.k, (0, 3, 1, 2))


def ensemble_config(members=("scale2", "scale3")):
    return jrepo.parse_pbtxt(
        'name: "ens6"\nplatform: "ensemble"\nmax_batch_size: 0\n'
        'input [ { name: "IMAGE" data_type: TYPE_FP32 dims: [1, 3, 8, 8] } ]\n'
        'output [ { name: "OUT" data_type: TYPE_FP32 dims: [1, 3, 8, 8] } ]\n'
        "ensemble_scheduling { step [\n"
        f'  {{ model_name: "{members[0]}" model_version: -1 input_map {{ key: "data" value: "IMAGE" }}'
        ' output_map { key: "output" value: "MID" } },\n'
        f'  {{ model_name: "{members[1]}" model_version: -1 input_map {{ key: "data" value: "MID" }}'
        ' output_map { key: "output" value: "OUT" } } ] }\n'
    )


def ensemble_registries():
    j, p = jreg.ModelRegistry(), preg.ModelRegistry("cpu")
    for name, k in (("scale2", 2.0), ("scale3", 3.0)):
        j.register(jreg.ModelSpec(name, (8, 8, 3), "image"), JScaleNCHW(k), {})
        p.register(preg.ModelSpec(name, (8, 8, 3), "image"), ScaleNCHW(k))
    cfg = ensemble_config()
    j.register(jreg.ModelSpec("ens6", (8, 8, 3), "ensemble"), jrepo.parse_ensemble("ens6", cfg), {})
    p.register(preg.ModelSpec("ens6", (8, 8, 3), "ensemble"), prepo.parse_ensemble("ens6", cfg))
    return j, p


def test_ensemble_matches_jax_and_f3_names_the_member():
    j, p = ensemble_registries()
    assert p.memory_usage_bytes("ens6") == 0 and p.variables("ens6") == {}
    js, ps = jserve(None, j, port=0), pserve(None, p, port=0)
    jc, pc = (TritonWireClient(f"localhost:{s._rsfd_port}", timeout_s=60) for s in (js, ps))
    try:
        x = np.random.default_rng(0).random((1, 3, 8, 8), np.float32)
        jo, po = (c.model_infer("ens6", x, input_name="IMAGE") for c in (jc, pc))
        assert [(n, s) for n, s, _ in po] == [(n, s) for n, s, _ in jo] == [("OUT", [1, 3, 8, 8])]
        np.testing.assert_array_equal(po[0][2], jo[0][2])
        np.testing.assert_allclose(po[0][2], 6.0 * x, rtol=1e-6)
        jcfg, pcfg = jc.model_config("ens6"), pc.model_config("ens6")
        assert pcfg == jcfg and pcfg["platform"] == "ensemble"
        for name in ("ens6", "scale2", "scale3"):
            assert p.statistics(name).inference_count == j.statistics(name).inference_count == 1
        errs = [rpc_error(lambda c=c: c.model_infer("ens6", x, input_name="WRONG")) for c in (jc, pc)]
        assert errs[0] == errs[1] and errs[0][0] == grpc.StatusCode.INVALID_ARGUMENT
        two_blobs = {"model_name": "ens6", "inputs": [{"name": "IMAGE", "datatype": "FP32", "shape": [1, 3, 8, 8]}],
                     "raw_input_contents": [x.tobytes(), x.tobytes()]}
        errs = [rpc_error(lambda c=c: c._unary("ModelInfer", pwire.MODEL_INFER_REQUEST, pwire.MODEL_INFER_RESPONSE,
                                               two_blobs)) for c in (jc, pc)]
        assert errs[0] == errs[1] and errs[0][0] == grpc.StatusCode.INVALID_ARGUMENT and "2 blobs" in errs[0][1]

        # F3: a member unloaded after the ensemble went READY, then a load of
        # the ensemble.  JAX names the ensemble; the port names the member.
        j.unload("scale3")
        p.unload("scale3")
        (jcode, jdetail), (pcode, pdetail) = (rpc_error(lambda c=c: c.repository_model_load("ens6")) for c in (jc, pc))
        assert jcode == pcode == grpc.StatusCode.NOT_FOUND
        assert "scale3" not in jdetail and "'ens6'" in jdetail
        assert pdetail == "Request for unknown model: 'scale3' (member of ensemble 'ens6') is not found"
        # an infer names the member in both
        (jcode, jdetail), (pcode, pdetail) = (rpc_error(lambda c=c: c.model_infer("ens6", x, input_name="IMAGE"))
                                              for c in (jc, pc))
        assert jcode == pcode == grpc.StatusCode.NOT_FOUND and jdetail == pdetail and "scale3" in pdetail
    finally:
        jc.close()
        pc.close()
        js.stop(0)
        ps.stop(0)


def test_dynamic_batching_coalesces():
    """A model whose spec asks for dynamic batching: concurrent single-item
    infers coalesce into fewer executions, each reply equal to the module's
    own forward on that item."""
    spec_kw = {"face_quality": dict(max_batch_size=4, dynamic_batching=True, max_queue_delay_us=50000)}
    _, p = registries(spec_kw)
    server = pserve(None, p, port=0)
    client = TritonWireClient(f"localhost:{server._rsfd_port}", timeout_s=60)
    try:
        xs = [np.random.default_rng(10 + i).normal(size=(1, 3, 32, 32)).astype(np.float32) for i in range(8)]
        client.model_infer("face_quality", xs[0])
        with ThreadPoolExecutor(max_workers=8) as pool:
            results = list(pool.map(lambda x: client.model_infer("face_quality", x)[0][2], xs))
        module = p.get("face_quality")
        for x, got in zip(xs, results):
            with torch.inference_mode():
                want = module(torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=HEAD_RTOL * float(np.abs(want).max()))
        stats = p.statistics("face_quality")
        assert stats.inference_count == 9
        assert stats.execution_count < 9 and any(b > 1 for b in stats.batch_size_counts)
    finally:
        client.close()
        server.stop(0)
    assert not server._rsfd_wire._batchers  # stop closed the workers


def test_f2_no_batcher_is_created_after_close():
    """JAX's copy creates a batcher after close() that nobody closes; the
    port's refuses the request and creates none."""
    x = np.random.default_rng(9).random((1, 3, 4, 4), np.float32)
    spec = dict(name="m", input_shape=(4, 4, 3), output_spec="image", max_batch_size=2,
                dynamic_batching=True, max_queue_delay_us=500)
    p = preg.ModelRegistry("cpu")
    p.register(preg.ModelSpec(**spec), ScaleNCHW(2.0))
    port = pwire.TritonWireServicer(p)
    np.testing.assert_allclose(port._dynamic_forward("m", x), 2.0 * x, rtol=1e-6)
    assert len(port._batchers) == 1
    port.close()
    before = {t for t in threading.enumerate() if t.name == "rsfd-dynamic-batcher"}
    with pytest.raises(RuntimeError, match="closed"):
        port._dynamic_forward("m", x)
    assert port._batchers == {}
    assert {t for t in threading.enumerate() if t.name == "rsfd-dynamic-batcher"} <= before

    j = jreg.ModelRegistry()
    j.register(jreg.ModelSpec(**spec), JScaleNCHW(2.0), {})
    jax_servicer = jwire.TritonWireServicer(j)
    jax_servicer.close()
    jax_servicer._dynamic_forward("m", np.transpose(x, (0, 2, 3, 1)))
    leaked = list(jax_servicer._batchers.values())
    assert len(leaked) == 1  # the fault, kept in the JAX package
    jax_servicer.close()


def test_trace_setting_through_the_wire(servers, tmp_path):
    """TraceSetting toggles the facade's torch.profiler session and returns
    its directory, which holds the Chrome trace after the stop."""
    _, _, client = servers["port"]
    assert client.trace_setting() == {"trace_level": ["OFF"]}
    started = client.trace_setting({"trace_level": ["TIMESTAMPS"]})
    assert started["trace_level"] == ["TIMESTAMPS"]
    client.model_infer("face_quality", np.zeros((1, 3, 32, 32), np.float32))
    stopped = client.trace_setting({"trace_level": ["OFF"]})
    assert stopped["trace_level"] == ["OFF"] and stopped["trace_file"] == started["trace_file"]
    assert os.path.getsize(os.path.join(stopped["trace_file"][0], "trace.json")) > 0
    code, _ = rpc_error(lambda: client.trace_setting({"trace_level": ["OFF"]}))
    assert code == grpc.StatusCode.FAILED_PRECONDITION
