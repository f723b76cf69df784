"""The port's KServe-v2 HTTP/REST endpoint (runtime/http.py) against the JAX package's.

A JAX server and a port server, each from ``serve(None, registry, port=0,
http_port=0)``, serve the same weights (tests/test_torch_wire.py's
``registries``: the trained 64-px detector and two SmallCNN heads, bridged
by models/weights.py).  Every test of tests/test_http.py runs against the
port's endpoint with that file's stock http.client helpers, the bytes a
``tritonclient.http`` user sends, and asks JAX's endpoint the same:

  - status codes and ``{"error": ...}`` details are equal, apart from the
    ``platform``/``backend`` strings ("pytorch_libtorch" against "jax_xla")
    and the CUDA shared-memory refusal's text (JAX's names TPU memory);
  - infer outputs equal the port module's own forward bit for bit (JSON
    carries float32 exactly) and JAX's within 1e-5 of max|output| per
    tensor, the SmallCNN bound of tests/test_torch_heads.py, which the
    detection maps meet too (1.6e-6 of max|map| measured on this CPU);
  - each package's ``TritonHTTPClient`` gets the same answers from the
    other package's server as from its own.
"""

import json
import uuid

import numpy as np
import pytest
import torch

pytest.importorskip("grpc")

from rs_face_detection_tpu.runtime.http import TritonHTTPClient as JClient
from rs_face_detection_tpu.runtime.server import serve as jserve
from rs_face_detection_tpu_torch.runtime.http import TritonHTTPClient, TritonHTTPError
from rs_face_detection_tpu_torch.runtime.server import serve as pserve
from rs_face_detection_tpu_torch.runtime.shm import SharedRegion
from rs_face_detection_tpu_torch.runtime.wire import TritonWireClient
from test_http import _get, _post
from test_torch_wire import DET, HEAD_RTOL, registries

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def servers():
    j, p = registries()
    js, ps = jserve(None, j, port=0, http_port=0), pserve(None, p, port=0, http_port=0)
    yield {"jax": (js._rsfd_http_port, js._rsfd_port, j), "port": (ps._rsfd_http_port, ps._rsfd_port, p)}
    js.stop(0)
    ps.stop(0)


def both(servers, fn):
    """fn(http port) on the JAX server and on the port's: (jax, port)."""
    return fn(servers["jax"][0]), fn(servers["port"][0])


def _status_and_error(reply):
    status, _, body = reply
    return status, (json.loads(body).get("error") if body else None)


def _direct(reg, name, x):
    """The port registry's module on x, as float32 numpy."""
    with torch.inference_mode():
        return reg.get(name)(torch.from_numpy(x)).float().numpy()


def _close_to_jax(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=HEAD_RTOL * float(np.abs(want).max()))


def _json_infer(name, x):
    return {"inputs": [{"name": "data", "shape": list(x.shape), "datatype": "FP32", "data": x.reshape(-1).tolist()}]}


# -- health / metadata ----------------------------------------------------------


def test_http_health_and_ready(servers):
    paths = ["/v2/health/live", "/v2/health/ready", "/v2/models/face_quality/ready",
             "/v2/models/face_quality/versions/1/ready", "/v2/models/nope/ready"]
    port = servers["port"][0]
    assert [_get(port, p)[0] for p in paths] == [200, 200, 200, 200, 400]
    j, p = both(servers, lambda hp: [_get(hp, path)[0] for path in paths])
    assert j == p


def test_http_server_metadata(servers):
    j, p = both(servers, lambda hp: _get(hp, "/v2"))
    assert p[0] == j[0] == 200
    meta, jmeta = json.loads(p[2]), json.loads(j[2])
    assert meta["name"] == "rs_face_detection_tpu_torch"
    assert "model_repository" in meta["extensions"]
    assert meta["extensions"] == jmeta["extensions"]


def test_http_model_metadata_and_config(servers):
    j, p = both(servers, lambda hp: _get(hp, f"/v2/models/{DET}"))
    assert p[0] == j[0] == 200
    meta, jmeta = json.loads(p[2]), json.loads(j[2])
    assert meta.pop("platform") == "pytorch_libtorch" and jmeta.pop("platform") == "jax_xla"
    assert meta == jmeta
    assert meta["inputs"][0] == {"name": "data", "datatype": "FP32", "shape": [1, 3, 64, 64]}
    assert len(meta["outputs"]) == 9

    j, p = both(servers, lambda hp: _get(hp, f"/v2/models/{DET}/config"))
    assert p[0] == j[0] == 200
    cfg, jcfg = json.loads(p[2]), json.loads(j[2])
    assert cfg["input"][0]["data_type"] == "TYPE_FP32"
    assert cfg["input"][0]["format"] == "FORMAT_NCHW"
    assert cfg["output"][0]["name"] == "face_rpn_cls_prob_reshape_stride32"
    assert (cfg["platform"], cfg["backend"]) == ("pytorch_libtorch", "rs_face_detection_tpu_torch")
    drop = ("platform", "backend")
    assert {k: v for k, v in cfg.items() if k not in drop} == {k: v for k, v in jcfg.items() if k not in drop}


def test_http_unknown_model_and_version_404(servers):
    for path in ("/v2/models/missing_model", "/v2/models/face_quality/versions/7", "/v2/nonsense"):
        j, p = both(servers, lambda hp: _status_and_error(_get(hp, path)))
        assert p == j and p[0] == 404 and p[1], path
    assert "missing_model" in _status_and_error(_get(servers["port"][0], "/v2/models/missing_model"))[1]


# -- inference --------------------------------------------------------------------


def test_http_infer_json_data(servers):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 3, 32, 32)).astype(np.float32)
    body = dict(_json_infer("face_quality", x), id="req-1")
    j, p = both(servers, lambda hp: _post(hp, "/v2/models/face_quality/infer", obj=body))
    assert p[0] == j[0] == 200, p[2]
    out, jout = json.loads(p[2]), json.loads(j[2])
    assert out["model_name"] == "face_quality" and out["id"] == "req-1"
    (tensor,) = out["outputs"]
    assert (tensor["name"], tensor["datatype"]) == ("output", "FP32")
    got = np.asarray(tensor["data"], np.float32).reshape(tensor["shape"])
    np.testing.assert_array_equal(got, _direct(servers["port"][2], "face_quality", x))
    (jtensor,) = jout["outputs"]
    assert {k: v for k, v in tensor.items() if k != "data"} == {k: v for k, v in jtensor.items() if k != "data"}
    _close_to_jax(got, np.asarray(jtensor["data"], np.float32).reshape(jtensor["shape"]))


def _binary_infer(hp, name, x):
    header = json.dumps({
        "inputs": [{"name": "data", "shape": list(x.shape), "datatype": "FP32",
                    "parameters": {"binary_data_size": x.nbytes}}],
        "outputs": [{"name": "output", "parameters": {"binary_data": True}}],
    }).encode()
    status, headers, body = _post(hp, f"/v2/models/{name}/infer", raw=header + x.tobytes(),
                                  headers={"Inference-Header-Content-Length": str(len(header))})
    assert status == 200, body
    jlen = int(headers["Inference-Header-Content-Length"])
    (tensor,) = json.loads(body[:jlen])["outputs"]
    assert "data" not in tensor
    nbytes = tensor["parameters"]["binary_data_size"]
    return np.frombuffer(body[jlen : jlen + nbytes], "<f4").reshape(tensor["shape"])


def test_http_infer_binary_extension(servers):
    """The tritonclient.http default path: binary request tensor after the
    JSON header, binary response tensor after the response header."""
    x = np.random.default_rng(1).normal(size=(1, 3, 32, 32)).astype("<f4")
    j, p = both(servers, lambda hp: _binary_infer(hp, "face_identification", x))
    np.testing.assert_array_equal(p, _direct(servers["port"][2], "face_identification", x))
    _close_to_jax(p, j)


def test_http_infer_detection_names(servers):
    """Detection over HTTP returns the mxnet-RetinaFace tensor set in
    model-config order."""
    x = np.random.default_rng(2).normal(size=(1, 3, 64, 64)).astype(np.float32)
    j, p = both(servers, lambda hp: _post(hp, f"/v2/models/{DET}/infer", obj=_json_infer(DET, x)))
    assert p[0] == j[0] == 200, p[2]
    out, jout = json.loads(p[2]), json.loads(j[2])
    names = [t["name"] for t in out["outputs"]]
    assert names[:3] == ["face_rpn_cls_prob_reshape_stride32", "face_rpn_bbox_pred_stride32",
                         "face_rpn_landmark_pred_stride32"]
    assert len(names) == 9 and names == [t["name"] for t in jout["outputs"]]
    assert out["outputs"][0]["shape"] == [1, 4, 2, 2]  # 2A channels at 64/32
    for t, jt in zip(out["outputs"], jout["outputs"]):
        assert t["shape"] == jt["shape"]
        _close_to_jax(np.asarray(t["data"], np.float32), np.asarray(jt["data"], np.float32))


def test_http_infer_errors(servers):
    header = json.dumps({"inputs": [{"name": "data", "shape": [1, 3, 32, 32], "datatype": "FP32",
                                     "parameters": {"binary_data_size": 999999}}]}).encode()
    cases = {
        "unknown model": lambda hp: _post(hp, "/v2/models/missing/infer", obj={"inputs": [
            {"name": "data", "shape": [1, 3, 2, 2], "datatype": "FP32", "data": [0.0] * 12}]}),
        "malformed JSON": lambda hp: _post(hp, "/v2/models/face_quality/infer", raw=b"{not json"),
        "binary overrun": lambda hp: _post(hp, "/v2/models/face_quality/infer", raw=header + b"\x00" * 16,
                                           headers={"Inference-Header-Content-Length": str(len(header))}),
        "no data": lambda hp: _post(hp, "/v2/models/face_quality/infer", obj={"inputs": [
            {"name": "data", "shape": [1, 3, 32, 32], "datatype": "FP32"}]}),
    }
    want = {"unknown model": 404, "malformed JSON": 400, "binary overrun": 400, "no data": 400}
    for what, fn in cases.items():
        j, p = both(servers, lambda hp: _status_and_error(fn(hp)))
        assert p == j and p[0] == want[what], (what, p, j)
    assert "missing" in _status_and_error(cases["unknown model"](servers["port"][0]))[1]
    assert "binary" in _status_and_error(cases["binary overrun"](servers["port"][0]))[1]


# -- repository / statistics --------------------------------------------------------


def test_http_repository_verbs(servers):
    def index(hp, obj=None):
        status, _, body = _post(hp, "/v2/repository/index", obj=obj)
        return status, json.loads(body)

    j, p = both(servers, index)
    assert p == j and p[0] == 200
    assert {m["name"]: m["state"] for m in p[1]}["face_quality"] == "READY"
    j, p = both(servers, lambda hp: _post(hp, "/v2/repository/models/face_quality/unload")[0])
    assert p == j == 200
    j, p = both(servers, lambda hp: index(hp, {"ready": True}))
    assert p == j and "face_quality" not in [m["name"] for m in p[1]]
    j, p = both(servers, lambda hp: _post(hp, "/v2/repository/models/face_quality/load")[0])
    assert p == j == 200
    assert both(servers, lambda hp: _get(hp, "/v2/models/face_quality/ready")[0]) == (200, 200)
    j, p = both(servers, lambda hp: _status_and_error(_post(hp, "/v2/repository/models/missing/load")))
    assert p == j and p[0] == 404


def test_http_statistics(servers):
    x = np.zeros((1, 3, 32, 32), np.float32)
    port = servers["port"][0]
    _post(port, "/v2/models/face_quality/infer", obj=_json_infer("face_quality", x))
    status, _, body = _get(port, "/v2/models/face_quality/stats")
    assert status == 200
    (stats,) = json.loads(body)["model_stats"]
    assert stats["name"] == "face_quality"
    assert stats["inference_count"] >= 1
    assert stats["inference_stats"]["compute_infer"]["count"] >= 1
    j, p = both(servers, lambda hp: _status_and_error(_get(hp, "/v2/models/missing/stats")))
    assert p == j and p[0] == 404


# -- shared memory / logging / trace ----------------------------------------------------


def test_http_system_shared_memory(servers):
    port, grpc_port, _ = servers["port"]
    region = SharedRegion.create(f"rsfd_http_{uuid.uuid4().hex[:12]}", 4096)
    try:
        status, _, body = _post(port, "/v2/systemsharedmemory/region/httpshm/register",
                                obj={"key": region.key, "offset": 0, "byte_size": 4096})
        assert status == 200, body
        regions = json.loads(_get(port, "/v2/systemsharedmemory/status")[2])
        assert any(r["name"] == "httpshm" and r["byte_size"] == 4096 for r in regions)
        status, _, body = _get(port, "/v2/systemsharedmemory/region/httpshm/status")
        assert [r["name"] for r in json.loads(body)] == ["httpshm"]
        # the same region is visible on the protobuf wire (one shm registry)
        client = TritonWireClient(f"localhost:{grpc_port}", timeout_s=60)
        try:
            assert client.system_shared_memory_status("httpshm")["httpshm"]["byte_size"] == 4096
        finally:
            client.close()
        assert _post(port, "/v2/systemsharedmemory/region/httpshm/unregister")[0] == 200
        j, p = both(servers, lambda hp: _status_and_error(_get(hp, "/v2/systemsharedmemory/region/httpshm/status")))
        assert p == j and p[0] == 404
    finally:
        region.close(unlink=True)


def test_http_cuda_shared_memory_refusal(servers):
    reg = {"raw_handle": "", "device_id": 0, "byte_size": 64}
    j, p = both(servers, lambda hp: _status_and_error(_post(hp, "/v2/cudasharedmemory/region/gpu0/register", obj=reg)))
    assert p[0] == j[0] == 501
    assert "system shared memory" in p[1] and "TPU" not in p[1]
    j, p = both(servers, lambda hp: _get(hp, "/v2/cudasharedmemory/status")[::2])
    assert p == j == (200, b"[]")
    j, p = both(servers, lambda hp: _status_and_error(_get(hp, "/v2/cudasharedmemory/region/gpu0/status")))
    assert p[0] == j[0] == 404 and "TPU" not in p[1]


def test_http_logging(servers):
    j, p = both(servers, lambda hp: _get(hp, "/v2/logging")[::2])
    assert p == j and p[0] == 200 and json.loads(p[1])["log_info"] is True
    j, p = both(servers, lambda hp: _post(hp, "/v2/logging", obj={"log_verbose_level": 2})[::2])
    assert p == j and json.loads(p[1])["log_verbose_level"] == 2
    both(servers, lambda hp: _post(hp, "/v2/logging", obj={"log_verbose_level": 0}))
    j, p = both(servers, lambda hp: _status_and_error(_post(hp, "/v2/logging", obj={"bogus": True})))
    assert p == j and p[0] == 400


def test_http_trace_status(servers):
    j, p = both(servers, lambda hp: _get(hp, "/v2/trace/setting")[::2])
    assert p == j and p[0] == 200 and json.loads(p[1])["trace_level"] == ["OFF"]


# -- the Python clients -------------------------------------------------------------


def _client_verbs(client):
    """What a client reads from a server; the platform aside."""
    with pytest.raises((TritonHTTPError, RuntimeError)) as e:
        client.model_metadata("missing")
    meta = client.model_metadata("face_quality")
    config = client.model_config("face_quality")
    return {
        "live": client.server_live(),
        "ready": client.server_ready(),
        "model_ready": (client.model_ready("face_quality"), client.model_ready("nope")),
        "extensions": client.server_metadata()["extensions"],
        "metadata": {k: v for k, v in meta.items() if k != "platform"},
        "config": {k: v for k, v in config.items() if k not in ("platform", "backend")},
        "missing": (e.value.status, e.value.detail),
        "index": client.repository_index(),
        "log": client.log_settings(),
        "trace": client.trace_setting(),
    }


def test_http_client_verbs(servers):
    port, _, _ = servers["port"]
    client = TritonHTTPClient(port=port, timeout_s=60)
    assert client.server_live() and client.server_ready()
    assert client.model_ready("face_quality") is True
    assert client.model_ready("nope") is False
    assert client.server_metadata()["name"] == "rs_face_detection_tpu_torch"
    assert client.model_metadata("face_quality")["platform"] == "pytorch_libtorch"
    assert client.model_config("face_quality")["input"][0]["data_type"] == "TYPE_FP32"
    with pytest.raises(TritonHTTPError) as e:
        client.model_metadata("missing")
    assert e.value.status == 404 and "missing" in e.value.detail
    assert "face_quality" in [m["name"] for m in client.repository_index()]
    assert client.log_settings()["log_info"] is True
    assert client.trace_setting()["trace_level"] == ["OFF"]
    assert _client_verbs(client) == _client_verbs(TritonHTTPClient(port=servers["jax"][0], timeout_s=60))


def test_http_client_infer_binary_json_parity(servers):
    port, _, reg = servers["port"]
    client = TritonHTTPClient(port=port, timeout_s=60)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 3, 32, 32)).astype(np.float32)
    (bin_out,) = client.infer("face_identification", x)
    (json_out,) = client.infer("face_identification", x, binary=False)
    assert bin_out[0] == json_out[0] == "output"
    np.testing.assert_array_equal(bin_out[2], json_out[2])
    np.testing.assert_array_equal(bin_out[2], _direct(reg, "face_identification", x))
    (jax_out,) = TritonHTTPClient(port=servers["jax"][0], timeout_s=60).infer("face_identification", x)
    _close_to_jax(bin_out[2], jax_out[2])
    # requested-output subset on the detection model
    outs = client.infer(DET, rng.normal(size=(1, 3, 64, 64)).astype(np.float32),
                        requested_outputs=["face_rpn_bbox_pred_stride8"])
    assert [o[0] for o in outs] == ["face_rpn_bbox_pred_stride8"]


# -- across the two packages -------------------------------------------------------------


@pytest.mark.parametrize("client_cls", [JClient, TritonHTTPClient], ids=["jax_client", "port_client"])
def test_each_client_gets_the_same_answers_from_both_servers(servers, client_cls):
    """JAX's TritonHTTPClient against the port's server and the port's
    client against JAX's: the verbs answer as from the client's own
    package, and infer outputs agree within the tolerances above."""
    jc, pc = (client_cls(port=servers[k][0], timeout_s=60) for k in ("jax", "port"))
    assert _client_verbs(pc) == _client_verbs(jc)
    rng = np.random.default_rng(4)
    for name, shape in (("face_quality", (2, 3, 32, 32)), (DET, (1, 3, 64, 64))):
        x = rng.normal(size=shape).astype(np.float32)
        for binary in (True, False):
            got, want = pc.infer(name, x, binary=binary), jc.infer(name, x, binary=binary)
            assert [(n, s) for n, s, _ in got] == [(n, s) for n, s, _ in want]
            for (_, _, g), (_, _, w) in zip(got, want):
                _close_to_jax(g, w)
