"""Triton KServe-v2 HTTP/REST endpoint over the wire servicer.

The port of rs_face_detection_tpu/runtime/http.py.  Triton serves two
client surfaces: the GRPCInferenceService protobuf contract (runtime/
wire.py) and the KServe "open inference protocol v2" HTTP/REST API, whose
verbs the protobuf contract renders one for one.  This module serves the
HTTP surface on top of the SAME ``TritonWireServicer`` the protobuf wire
uses, so both protocols share one registry on one device, one
shared-memory registry, one statistics stream and one trace session.  A
ModelInfer here runs the registry's module eagerly on its device (a ViT
tower's attention through K4 on the card), exactly as over gRPC.

Endpoints (KServe v2 core + the Triton extensions this server implements):

    GET  /v2                                        server metadata
    GET  /v2/health/live                            liveness
    GET  /v2/health/ready                           readiness
    GET  /v2/models/{m}[/versions/{v}]/ready        model readiness
    GET  /v2/models/{m}[/versions/{v}]              model metadata
    GET  /v2/models/{m}[/versions/{v}]/config       Triton config extension
    GET  /v2/models/{m}[/versions/{v}]/stats        statistics extension
    POST /v2/models/{m}[/versions/{v}]/infer        inference (+ binary
                                                    tensor-data extension)
    POST /v2/repository/index                       model-repository ext.
    POST /v2/repository/models/{m}/load
    POST /v2/repository/models/{m}/unload
    GET  /v2/systemsharedmemory/status              shared-memory extension
    GET  /v2/systemsharedmemory/region/{n}/status
    POST /v2/systemsharedmemory/region/{n}/register
    POST /v2/systemsharedmemory/region/{n}/unregister
    POST /v2/systemsharedmemory/unregister
    GET  /v2/cudasharedmemory/status                (typed refusal family)
    POST /v2/cudasharedmemory/region/{n}/register
    POST /v2/cudasharedmemory/region/{n}/unregister
    GET/POST /v2/logging                            logging extension
    GET/POST /v2/trace/setting                      trace extension

Binary tensor-data extension (what ``tritonclient.http`` sends by
default): a request whose ``Inference-Header-Content-Length`` header is
set carries the JSON request object in the first N body bytes and the
concatenated raw little-endian tensors after it, referenced in input order
by each input's ``parameters.binary_data_size``; an output requested with
``parameters.binary_data = true`` (or a request-level
``binary_data_output``) comes back the same way.

Error semantics follow Triton's HTTP behavior: a failed verb returns JSON
``{"error": detail}`` with the HTTP status mapped from the wire verb's
gRPC StatusCode (INVALID_ARGUMENT -> 400, NOT_FOUND -> 404,
UNIMPLEMENTED -> 501, INTERNAL -> 500, anything else -> 400).
"""

from __future__ import annotations

import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .wire import DATA_TYPE, NP_DTYPE, TritonWireServicer

LOGGER = logging.getLogger("rs_face_detection_tpu_torch")

#: model_config.proto enum renderings for the config JSON (Triton's HTTP
#: config endpoint returns enum *names*, not numbers).
_DATA_TYPE_NAME = {v: f"TYPE_{k}" for k, v in DATA_TYPE.items()}
_FORMAT_NAME = {0: "FORMAT_NONE", 1: "FORMAT_NHWC", 2: "FORMAT_NCHW"}

#: InferTensorContents field per datatype — must mirror the reader in
#: wire.TritonWireServicer.model_infer.
_CONTENTS_FIELD = {
    "FP32": "fp32_contents",
    "FP64": "fp64_contents",
    "INT8": "int_contents",
    "INT16": "int_contents",
    "INT32": "int_contents",
    "UINT8": "uint_contents",
    "UINT16": "uint_contents",
    "UINT32": "uint_contents",
    "INT64": "int64_contents",
    "UINT64": "uint64_contents",
    "BOOL": "bool_contents",
}


class _HttpAbort(Exception):
    """Carries the (grpc.StatusCode, detail) a wire verb aborted with so
    the handler can render Triton's ``{"error": ...}`` JSON at the mapped
    HTTP status."""

    def __init__(self, code: Any, detail: str) -> None:
        super().__init__(detail)
        self.code = code
        self.detail = detail


class _HttpContext:
    """The minimal ServicerContext surface the wire verbs use."""

    def abort(self, code: Any, detail: str) -> None:
        raise _HttpAbort(code, detail)


def _http_status(code: Any) -> int:
    import grpc

    return {
        grpc.StatusCode.INVALID_ARGUMENT: 400,
        grpc.StatusCode.NOT_FOUND: 404,
        grpc.StatusCode.UNIMPLEMENTED: 501,
        grpc.StatusCode.INTERNAL: 500,
        grpc.StatusCode.FAILED_PRECONDITION: 400,
    }.get(code, 400)


def _json_body(body: bytes) -> Dict[str, Any]:
    """Parse an optional JSON object body; malformed input is the caller's
    error (400), never a 500."""
    import grpc

    if not body:
        return {}
    try:
        obj = json.loads(body)
    except ValueError as e:
        raise _HttpAbort(
            grpc.StatusCode.INVALID_ARGUMENT, f"malformed request JSON: {e}"
        )
    if not isinstance(obj, dict):
        raise _HttpAbort(
            grpc.StatusCode.INVALID_ARGUMENT,
            "request JSON must be an object",
        )
    return obj


def _wrap_param(value: Any) -> Dict[str, Any]:
    """Plain HTTP JSON parameter value -> the proto InferParameter oneof
    shape the wire servicer reads (grpc_service.proto:441-460)."""
    if isinstance(value, bool):
        return {"bool_param": value}
    if isinstance(value, int):
        return {"int64_param": value}
    if isinstance(value, float):
        return {"double_param": value}
    return {"string_param": str(value)}


def _unwrap_param(param: Optional[Dict[str, Any]]) -> Any:
    if not param:
        return None
    return next(iter(param.values()))


def _unwrap_params(params: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    return {k: _unwrap_param(v) for k, v in (params or {}).items()}


def _require_version(version: Optional[str]) -> None:
    """Registry checkpoints surface as version "1" on both protocols
    (wire.model_metadata); any other explicit version is unknown."""
    if version not in (None, "", "1"):
        import grpc

        raise _HttpAbort(
            grpc.StatusCode.NOT_FOUND,
            f"Request for unknown model version: '{version}' is not found",
        )


def _render_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Wire ModelConfig dict (proto enums as ints) -> Triton's HTTP config
    JSON (enums as names)."""
    out = dict(config)
    for key in ("input", "output"):
        rendered = []
        for tensor in config.get(key, []):
            t = dict(tensor)
            if "data_type" in t:
                t["data_type"] = _DATA_TYPE_NAME.get(
                    t["data_type"], str(t["data_type"])
                )
            if "format" in t:
                t["format"] = _FORMAT_NAME.get(t["format"], str(t["format"]))
            rendered.append(t)
        out[key] = rendered
    return out


# ---------------------------------------------------------------------------
# Inference request/response translation
# ---------------------------------------------------------------------------


def _parse_infer_body(
    body: bytes, header_len: Optional[str]
) -> Tuple[Dict[str, Any], bytes]:
    import grpc

    if header_len is not None:
        try:
            n = int(header_len)
        except ValueError:
            raise _HttpAbort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"bad Inference-Header-Content-Length {header_len!r}",
            )
        if not 0 <= n <= len(body):
            raise _HttpAbort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "Inference-Header-Content-Length exceeds the request body",
            )
        json_part, blob = body[:n], body[n:]
    else:
        json_part, blob = body, b""
    try:
        request = json.loads(json_part)
    except ValueError as e:
        raise _HttpAbort(
            grpc.StatusCode.INVALID_ARGUMENT, f"malformed request JSON: {e}"
        )
    if not isinstance(request, dict):
        raise _HttpAbort(
            grpc.StatusCode.INVALID_ARGUMENT,
            "request JSON must be an object",
        )
    return request, blob


def _json_to_wire_infer(
    name: str, version: Optional[str], request: Dict[str, Any], blob: bytes
) -> Tuple[Dict[str, Any], Dict[str, bool], bool]:
    """KServe v2 JSON infer request -> the wire ModelInferRequest dict.

    Returns (wire_request, per-output binary_data wants, request-level
    binary_data_output default)."""
    import grpc

    inputs: List[Dict[str, Any]] = []
    raw: List[bytes] = []
    pos = 0
    for t in request.get("inputs", []) or []:
        params = dict(t.get("parameters") or {})
        binary_size = params.pop("binary_data_size", None)
        tensor = {
            "name": t.get("name", ""),
            "datatype": t.get("datatype", "FP32"),
            "shape": [int(d) for d in (t.get("shape") or [])],
            "parameters": {k: _wrap_param(v) for k, v in params.items()},
            "contents": None,
        }
        if binary_size is not None:
            try:
                n = int(binary_size)
            except (TypeError, ValueError):
                raise _HttpAbort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"bad binary_data_size {binary_size!r}",
                )
            if n < 0 or pos + n > len(blob):
                raise _HttpAbort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"input {tensor['name']!r}: binary_data_size {n} "
                    "exceeds the binary payload",
                )
            if len(raw) != len(inputs):
                # a previous input carried JSON data; the wire request's
                # raw_input_contents aligns by input order and cannot mix
                raise _HttpAbort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    "mixing binary_data and JSON data inputs is unsupported",
                )
            raw.append(blob[pos : pos + n])
            pos += n
        elif "data" in t:
            field = _CONTENTS_FIELD.get(tensor["datatype"])
            np_dtype = NP_DTYPE.get(tensor["datatype"])
            if field is None or np_dtype is None:
                raise _HttpAbort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"unsupported datatype {tensor['datatype']!r}",
                )
            try:
                flat = np.asarray(t["data"], dtype=np_dtype).reshape(-1)
            except (TypeError, ValueError) as e:
                raise _HttpAbort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"input {tensor['name']!r} data: {e}",
                )
            tensor["contents"] = {field: flat.tolist()}
        elif not params.get("shared_memory_region"):
            raise _HttpAbort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"input {tensor['name']!r} has neither data, binary_data_"
                "size, nor a shared_memory_region parameter",
            )
        inputs.append(tensor)

    want_binary: Dict[str, bool] = {}
    outputs: List[Dict[str, Any]] = []
    for o in request.get("outputs", []) or []:
        params = dict(o.get("parameters") or {})
        want_binary[o.get("name", "")] = bool(params.pop("binary_data", False))
        outputs.append(
            {
                "name": o.get("name", ""),
                "parameters": {k: _wrap_param(v) for k, v in params.items()},
            }
        )
    default_binary = bool(
        (request.get("parameters") or {}).get("binary_data_output", False)
    )

    wire_request = {
        "model_name": name,
        "model_version": version or "",
        "id": request.get("id", ""),
        "parameters": {},
        "inputs": inputs,
        "outputs": outputs,
        "raw_input_contents": raw,
    }
    return wire_request, want_binary, default_binary


def _wire_infer_to_http(
    response: Dict[str, Any],
    want_binary: Dict[str, bool],
    default_binary: bool,
) -> Tuple[bytes, Dict[str, str]]:
    """Wire ModelInferResponse dict -> (HTTP body, extra headers)."""
    outputs_json: List[Dict[str, Any]] = []
    blobs: List[bytes] = []
    raw_iter = iter(response["raw_output_contents"])
    for meta in response["outputs"]:
        o: Dict[str, Any] = {
            "name": meta["name"],
            "datatype": meta["datatype"],
            "shape": list(meta["shape"]),
        }
        if meta.get("parameters"):
            # shared-memory output: data lives in the region, parameters
            # carry the reference (unwrapped to plain JSON values)
            o["parameters"] = _unwrap_params(meta["parameters"])
        else:
            raw_bytes = next(raw_iter)
            if want_binary.get(meta["name"], default_binary):
                o["parameters"] = {"binary_data_size": len(raw_bytes)}
                blobs.append(raw_bytes)
            else:
                np_dtype = NP_DTYPE.get(meta["datatype"], np.float32)
                arr = np.frombuffer(
                    raw_bytes, dtype=np.dtype(np_dtype).newbyteorder("<")
                )
                o["data"] = arr.tolist()
        outputs_json.append(o)

    body: Dict[str, Any] = {
        "model_name": response["model_name"],
        "model_version": response["model_version"],
        "outputs": outputs_json,
    }
    if response.get("id"):
        body["id"] = response["id"]
    payload = json.dumps(body).encode()
    headers: Dict[str, str] = {}
    if blobs:
        headers["Inference-Header-Content-Length"] = str(len(payload))
        payload += b"".join(blobs)
    return payload, headers


# ---------------------------------------------------------------------------
# The handler
# ---------------------------------------------------------------------------

_MODEL = r"/v2/models/(?P<model>[^/]+)(?:/versions/(?P<version>[^/]+))?"
_REGION = r"(?P<region>[^/]+)"

_GET_ROUTES: List[Tuple[re.Pattern, str]] = [
    (re.compile(r"^/v2$"), "server_metadata"),
    (re.compile(r"^/v2/health/live$"), "health_live"),
    (re.compile(r"^/v2/health/ready$"), "health_ready"),
    (re.compile(f"^{_MODEL}/ready$"), "model_ready"),
    (re.compile(f"^{_MODEL}/config$"), "model_config"),
    (re.compile(f"^{_MODEL}/stats$"), "model_stats"),
    (re.compile(f"^{_MODEL}$"), "model_metadata"),
    (re.compile(r"^/v2/systemsharedmemory/status$"), "shm_status"),
    (
        re.compile(f"^/v2/systemsharedmemory/region/{_REGION}/status$"),
        "shm_status",
    ),
    (re.compile(r"^/v2/cudasharedmemory/status$"), "cuda_shm_status"),
    (
        re.compile(f"^/v2/cudasharedmemory/region/{_REGION}/status$"),
        "cuda_shm_status",
    ),
    (re.compile(r"^/v2/logging$"), "logging_get"),
    (re.compile(r"^/v2/trace/setting$"), "trace_get"),
]

_POST_ROUTES: List[Tuple[re.Pattern, str]] = [
    (re.compile(f"^{_MODEL}/infer$"), "infer"),
    (re.compile(r"^/v2/repository/index$"), "repository_index"),
    (
        re.compile(r"^/v2/repository/models/(?P<model>[^/]+)/load$"),
        "repository_load",
    ),
    (
        re.compile(r"^/v2/repository/models/(?P<model>[^/]+)/unload$"),
        "repository_unload",
    ),
    (
        re.compile(f"^/v2/systemsharedmemory/region/{_REGION}/register$"),
        "shm_register",
    ),
    (
        re.compile(f"^/v2/systemsharedmemory/region/{_REGION}/unregister$"),
        "shm_unregister",
    ),
    (re.compile(r"^/v2/systemsharedmemory/unregister$"), "shm_unregister"),
    (
        re.compile(f"^/v2/cudasharedmemory/region/{_REGION}/register$"),
        "cuda_shm_register",
    ),
    (
        re.compile(f"^/v2/cudasharedmemory/region/{_REGION}/unregister$"),
        "cuda_shm_unregister",
    ),
    (re.compile(r"^/v2/logging$"), "logging_post"),
    (re.compile(r"^/v2/trace/setting$"), "trace_post"),
]


class TritonHTTPHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # -- plumbing ---------------------------------------------------------

    @property
    def wire(self) -> TritonWireServicer:
        return self.server.wire  # type: ignore[attr-defined]

    def log_message(self, fmt: str, *args: Any) -> None:  # quiet stderr
        LOGGER.debug("http: " + fmt, *args)

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _send(
        self,
        status: int,
        payload: bytes = b"",
        content_type: str = "application/json",
        extra: Optional[Dict[str, str]] = None,
    ) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if payload:
            self.wfile.write(payload)

    def _send_json(self, obj: Any, status: int = 200) -> None:
        self._send(status, json.dumps(obj).encode())

    def _dispatch(self, routes: List[Tuple[re.Pattern, str]]) -> None:
        path = self.path.split("?", 1)[0]
        for pattern, verb in routes:
            m = pattern.match(path)
            if m:
                body = self._read_body()
                try:
                    getattr(self, "_" + verb)(m.groupdict(), body)
                except _HttpAbort as e:
                    self._send_json(
                        {"error": e.detail}, status=_http_status(e.code)
                    )
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001 — typed, never a 500 stack dump
                    LOGGER.exception("http handler error on %s", path)
                    self._send_json(
                        {"error": f"{type(e).__name__}: {e}"}, status=500
                    )
                return
        self._send_json({"error": f"no handler for {path}"}, status=404)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler contract
        self._dispatch(_GET_ROUTES)

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch(_POST_ROUTES)

    # -- health / metadata --------------------------------------------------

    def _server_metadata(self, m: Dict[str, str], body: bytes) -> None:
        self._send_json(self.wire.server_metadata({}, _HttpContext()))

    def _health_live(self, m: Dict[str, str], body: bytes) -> None:
        live = self.wire.registry.server_live()
        self._send(200 if live else 400)

    def _health_ready(self, m: Dict[str, str], body: bytes) -> None:
        ready = self.wire.registry.server_ready()
        self._send(200 if ready else 400)

    def _model_ready(self, m: Dict[str, str], body: bytes) -> None:
        _require_version(m.get("version"))
        out = self.wire.model_ready({"name": m["model"]}, _HttpContext())
        self._send(200 if out["ready"] else 400)

    def _model_metadata(self, m: Dict[str, str], body: bytes) -> None:
        _require_version(m.get("version"))
        self._send_json(
            self.wire.model_metadata({"name": m["model"]}, _HttpContext())
        )

    def _model_config(self, m: Dict[str, str], body: bytes) -> None:
        _require_version(m.get("version"))
        out = self.wire.model_config({"name": m["model"]}, _HttpContext())
        self._send_json(_render_config(out["config"]))

    def _model_stats(self, m: Dict[str, str], body: bytes) -> None:
        _require_version(m.get("version"))
        self._send_json(
            self.wire.model_statistics({"name": m["model"]}, _HttpContext())
        )

    # -- inference ------------------------------------------------------------

    def _infer(self, m: Dict[str, str], body: bytes) -> None:
        _require_version(m.get("version"))
        request, blob = _parse_infer_body(
            body, self.headers.get("Inference-Header-Content-Length")
        )
        wire_request, want_binary, default_binary = _json_to_wire_infer(
            m["model"], m.get("version"), request, blob
        )
        response = self.wire.model_infer(wire_request, _HttpContext())
        payload, extra = _wire_infer_to_http(
            response, want_binary, default_binary
        )
        self._send(
            200,
            payload,
            content_type="application/octet-stream" if extra
            else "application/json",
            extra=extra,
        )

    # -- repository ------------------------------------------------------------

    def _repository_index(self, m: Dict[str, str], body: bytes) -> None:
        request = _json_body(body)
        out = self.wire.repository_index(
            {"ready": bool(request.get("ready", False))}, _HttpContext()
        )
        self._send_json(out["models"])

    def _repository_load(self, m: Dict[str, str], body: bytes) -> None:
        self.wire.repository_model_load(
            {"model_name": m["model"]}, _HttpContext()
        )
        self._send_json({})

    def _repository_unload(self, m: Dict[str, str], body: bytes) -> None:
        self.wire.repository_model_unload(
            {"model_name": m["model"]}, _HttpContext()
        )
        self._send_json({})

    # -- shared memory -----------------------------------------------------

    def _shm_status(self, m: Dict[str, str], body: bytes) -> None:
        out = self.wire.system_shared_memory_status(
            {"name": m.get("region") or ""}, _HttpContext()
        )
        # Triton's HTTP status endpoint returns a JSON array of regions
        self._send_json(list(out["regions"].values()))

    def _shm_register(self, m: Dict[str, str], body: bytes) -> None:
        request = _json_body(body)
        self.wire.system_shared_memory_register(
            {
                "name": m["region"],
                "key": request.get("key", ""),
                "offset": int(request.get("offset", 0)),
                "byte_size": int(request.get("byte_size", 0)),
            },
            _HttpContext(),
        )
        self._send_json({})

    def _shm_unregister(self, m: Dict[str, str], body: bytes) -> None:
        self.wire.system_shared_memory_unregister(
            {"name": m.get("region") or ""}, _HttpContext()
        )
        self._send_json({})

    def _cuda_shm_status(self, m: Dict[str, str], body: bytes) -> None:
        out = self.wire.cuda_shared_memory_status(
            {"name": m.get("region") or ""}, _HttpContext()
        )
        self._send_json(list(out["regions"].values()))

    def _cuda_shm_register(self, m: Dict[str, str], body: bytes) -> None:
        self.wire.cuda_shared_memory_register(
            {"name": m["region"]}, _HttpContext()
        )
        self._send_json({})  # unreachable today (the verb always refuses)

    def _cuda_shm_unregister(self, m: Dict[str, str], body: bytes) -> None:
        self.wire.cuda_shared_memory_unregister(
            {"name": m.get("region") or ""}, _HttpContext()
        )
        self._send_json({})

    # -- logging / trace -----------------------------------------------------

    def _logging_get(self, m: Dict[str, str], body: bytes) -> None:
        out = self.wire.log_settings({"settings": {}}, _HttpContext())
        self._send_json(_unwrap_params(out["settings"]))

    def _logging_post(self, m: Dict[str, str], body: bytes) -> None:
        request = _json_body(body)
        settings: Dict[str, Any] = {}
        for key, value in request.items():
            if isinstance(value, bool):
                settings[key] = {"bool_param": value}
            elif isinstance(value, int):
                settings[key] = {"uint32_param": value}
            else:
                settings[key] = {"string_param": str(value)}
        out = self.wire.log_settings({"settings": settings}, _HttpContext())
        self._send_json(_unwrap_params(out["settings"]))

    def _trace_get(self, m: Dict[str, str], body: bytes) -> None:
        out = self.wire.trace_setting({"settings": {}}, _HttpContext())
        self._send_json(
            {k: v.get("value", []) for k, v in out["settings"].items()}
        )

    def _trace_post(self, m: Dict[str, str], body: bytes) -> None:
        request = _json_body(body)
        settings = {
            k: {"value": v if isinstance(v, list) else [str(v)]}
            for k, v in request.items()
        }
        out = self.wire.trace_setting({"settings": settings}, _HttpContext())
        self._send_json(
            {k: v.get("value", []) for k, v in out["settings"].items()}
        )


class TritonHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, wire_servicer: TritonWireServicer) -> None:
        super().__init__(addr, TritonHTTPHandler)
        self.wire = wire_servicer


def serve_http(
    registry=None,
    port: int = 8000,
    facade=None,
    wire_servicer: Optional[TritonWireServicer] = None,
) -> TritonHTTPServer:
    """Start the KServe-v2 HTTP endpoint; returns the server (caller calls
    ``shutdown()``).  Pass the gRPC facade/wire servicer to share shm
    regions, statistics and the trace session across protocols
    (``runtime.serve(http_port=...)`` does).  ``registry=None`` serves
    ``default_registry()``, on the card."""
    if wire_servicer is None:
        if registry is None:
            from ..models.registry import default_registry

            registry = default_registry()
        wire_servicer = TritonWireServicer(registry, facade=facade)
    server = TritonHTTPServer(("", port), wire_servicer)
    thread = threading.Thread(
        target=server.serve_forever, name="rsfd-http", daemon=True
    )
    thread.start()
    server._rsfd_thread = thread  # type: ignore[attr-defined]
    server._rsfd_port = server.server_address[1]  # type: ignore[attr-defined]
    return server


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class TritonHTTPError(RuntimeError):
    """A /v2 verb failed; carries the HTTP status and Triton's error JSON
    detail (what tritonclient.http raises as InferenceServerException)."""

    def __init__(self, status: int, detail: str) -> None:
        super().__init__(f"HTTP {status}: {detail}")
        self.status = status
        self.detail = detail


class TritonHTTPClient:
    """tritonclient.http-shaped client for the /v2 endpoint.

    Mirrors TritonWireClient's verb surface over REST; ``infer`` uses the
    binary tensor-data extension by default (the tritonclient.http default
    path — raw little-endian tensors after the JSON header)."""

    def __init__(self, host: str = "localhost", port: int = 8000,
                 timeout_s: float = 60.0) -> None:
        import http.client as _http_client

        self._conn_factory = lambda: _http_client.HTTPConnection(
            host, port, timeout=timeout_s
        )

    def _request(
        self,
        method: str,
        path: str,
        body: bytes = b"",
        headers: Optional[Dict[str, str]] = None,
        ok_statuses: Tuple[int, ...] = (200,),
    ) -> Tuple[int, Dict[str, str], bytes]:
        conn = self._conn_factory()
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status not in ok_statuses:
                try:
                    detail = json.loads(payload).get("error", "")
                except ValueError:
                    detail = payload.decode("utf-8", "replace")
                raise TritonHTTPError(resp.status, detail)
            return resp.status, dict(resp.getheaders()), payload
        finally:
            conn.close()

    def _get_json(self, path: str) -> Any:
        return json.loads(self._request("GET", path)[2])

    def _post_json(self, path: str, obj: Any = None) -> Any:
        body = json.dumps(obj).encode() if obj is not None else b""
        payload = self._request("POST", path, body)[2]
        return json.loads(payload) if payload else {}

    # -- health / metadata ---------------------------------------------------

    def server_live(self) -> bool:
        try:
            return self._request(
                "GET", "/v2/health/live", ok_statuses=(200, 400)
            )[0] == 200
        except OSError:
            return False

    def server_ready(self) -> bool:
        return self._request(
            "GET", "/v2/health/ready", ok_statuses=(200, 400)
        )[0] == 200

    def model_ready(self, name: str) -> bool:
        return self._request(
            "GET", f"/v2/models/{name}/ready", ok_statuses=(200, 400)
        )[0] == 200

    def server_metadata(self) -> Dict[str, Any]:
        return self._get_json("/v2")

    def model_metadata(self, name: str) -> Dict[str, Any]:
        return self._get_json(f"/v2/models/{name}")

    def model_config(self, name: str) -> Dict[str, Any]:
        return self._get_json(f"/v2/models/{name}/config")

    def model_statistics(self, name: str) -> List[Dict[str, Any]]:
        return self._get_json(f"/v2/models/{name}/stats")["model_stats"]

    # -- repository ------------------------------------------------------------

    def repository_index(self, ready_only: bool = False) -> List[Dict[str, Any]]:
        return self._post_json(
            "/v2/repository/index", {"ready": ready_only}
        )

    def repository_model_load(self, name: str) -> None:
        self._post_json(f"/v2/repository/models/{name}/load")

    def repository_model_unload(self, name: str) -> None:
        self._post_json(f"/v2/repository/models/{name}/unload")

    # -- shared memory -----------------------------------------------------

    def system_shared_memory_register(
        self, name: str, key: str, byte_size: int
    ) -> None:
        self._post_json(
            f"/v2/systemsharedmemory/region/{name}/register",
            {"key": key, "offset": 0, "byte_size": byte_size},
        )

    def system_shared_memory_status(self, name: str = "") -> List[Dict[str, Any]]:
        path = (
            f"/v2/systemsharedmemory/region/{name}/status"
            if name
            else "/v2/systemsharedmemory/status"
        )
        return self._get_json(path)

    def system_shared_memory_unregister(self, name: str = "") -> None:
        path = (
            f"/v2/systemsharedmemory/region/{name}/unregister"
            if name
            else "/v2/systemsharedmemory/unregister"
        )
        self._post_json(path)

    # -- logging / trace -----------------------------------------------------

    def log_settings(self, settings: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if settings:
            return self._post_json("/v2/logging", settings)
        return self._get_json("/v2/logging")

    def trace_setting(self, settings: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if settings:
            return self._post_json("/v2/trace/setting", settings)
        return self._get_json("/v2/trace/setting")

    # -- inference ------------------------------------------------------------

    def infer(
        self,
        model_name: str,
        x: np.ndarray,
        input_name: str = "data",
        datatype: str = "FP32",
        requested_outputs: Optional[List[str]] = None,
        binary: bool = True,
        request_id: str = "",
    ) -> List[Tuple[str, List[int], np.ndarray]]:
        """Run one tensor through /v2/models/{m}/infer.

        Returns [(name, shape, array)] in response order.  binary=True
        (default) sends/receives raw tensors via the binary extension;
        binary=False uses pure JSON ``data`` lists."""
        x = np.ascontiguousarray(x)
        request: Dict[str, Any] = {"inputs": [], "outputs": []}
        if request_id:
            request["id"] = request_id
        tensor: Dict[str, Any] = {
            "name": input_name,
            "shape": list(x.shape),
            "datatype": datatype,
        }
        blob = b""
        if binary:
            blob = x.astype(x.dtype.newbyteorder("<"), copy=False).tobytes()
            tensor["parameters"] = {"binary_data_size": len(blob)}
        else:
            tensor["data"] = x.reshape(-1).tolist()
        request["inputs"].append(tensor)
        for out_name in requested_outputs or []:
            request["outputs"].append(
                {"name": out_name, "parameters": {"binary_data": binary}}
            )
        if not request["outputs"]:
            del request["outputs"]
            if binary:
                request["parameters"] = {"binary_data_output": True}
        header = json.dumps(request).encode()
        headers = {}
        if binary or blob:
            headers["Inference-Header-Content-Length"] = str(len(header))
        _, resp_headers, payload = self._request(
            "POST", f"/v2/models/{model_name}/infer", header + blob, headers
        )
        header_len = resp_headers.get("Inference-Header-Content-Length")
        if header_len is not None:
            response = json.loads(payload[: int(header_len)])
            binary_blob = payload[int(header_len):]
        else:
            response = json.loads(payload)
            binary_blob = b""
        outs: List[Tuple[str, List[int], np.ndarray]] = []
        pos = 0
        for meta in response["outputs"]:
            np_dtype = np.dtype(NP_DTYPE.get(meta["datatype"], np.float32))
            nbytes = (meta.get("parameters") or {}).get("binary_data_size")
            if nbytes is not None:
                arr = np.frombuffer(
                    binary_blob[pos : pos + nbytes],
                    dtype=np_dtype.newbyteorder("<"),
                ).reshape(meta["shape"])
                pos += nbytes
            else:
                arr = np.asarray(meta["data"], dtype=np_dtype).reshape(
                    meta["shape"]
                )
            outs.append((meta["name"], list(meta["shape"]), arr))
        return outs
