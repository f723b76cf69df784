"""Triton GRPCInferenceService wire-protocol subset (genuine protobuf).

The port's copy of rs_face_detection_tpu/runtime/wire.py: the same
message schemas, the same verbs and the same status codes, over the
port's registry.  It speaks the actual Triton protobuf contract for the
RPC shapes a Triton client pipeline exercises (3x ModelConfig at init, then
ModelInfer per stage):

    ServerLive / ServerReady / ModelReady
    ModelConfig   (name -> ModelConfig{input[], output[], max_batch_size})
    ModelInfer    (InferInputTensor.fp32_contents or raw_input_contents in,
                   raw_output_contents little-endian f32 out)
    ModelStreamInfer (stream of the above)

plus the metadata, statistics, repository, shared-memory, log and trace
verbs.  Message schemas are hand-written subsets of Triton's
grpc_service.proto + model_config.proto (field numbers are the wire
contract), encoded by the descriptor-driven proto3 codec in
runtime/proto3.py.  The service registers as a SECOND generic handler
("inference.GRPCInferenceService") on the same gRPC server as the facade
(runtime/server.py) -- gRPC routes by full method path, so a stock Triton
client and a FacePipelineClient can share one port.

Tensor conventions: the wire speaks NCHW, and so do the port's modules, so
ModelInfer hands the tensor to the module as it came (cast to the module's
parameter dtype: the anti-spoofing towers are bf16 on the card) and runs
it eagerly under ``torch.inference_mode()`` on the registry's device.  The
detection model's per-stride NHWC head maps are re-expressed in the exact
mxnet-RetinaFace layout a Triton client's host decode consumes: per stride
in (32, 16, 8) order, a (1, 2A, h, w) `face_rpn_cls_prob_reshape_stride{s}`
whose first A channels are background and last A are face probabilities, a
(1, 4A, h, w) bbox delta map, and a (1, 10A, h, w) landmark delta map --
anchor-major channel groups, so the client's permute->reshape recovers
(rows, 4)/(rows, 5, 2) in anchor-plane order.

Two faults of the JAX copy are left out: after ``close()`` no dynamic
batcher is created (the JAX copy's eviction retry made one that nobody
closed), and loading an ensemble whose member is missing names the member.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .proto3 import Field, decode_message, encode_message

SERVICE = "inference.GRPCInferenceService"

#: Triton's platform name for a PyTorch model (ModelConfig / ModelMetadata).
PLATFORM = "pytorch_libtorch"

# The reference also vendors the standard gRPC health protocol
# (triton_proto/health.proto: grpc.health.v1.Health/Check) — unused by its
# pipeline but part of the Triton server surface (kubernetes/grpc-health-probe
# readiness checks speak it).  Served here for drop-in parity.
HEALTH_SERVICE = "grpc.health.v1.Health"
HEALTH_CHECK_REQUEST = {"service": Field(1, "string")}
# ServingStatus enum (health.proto:53-61)
HEALTH_CHECK_RESPONSE = {"status": Field(1, "enum")}
HEALTH_SERVING_STATUS = {0: "UNKNOWN", 1: "SERVING", 2: "NOT_SERVING",
                         3: "SERVICE_UNKNOWN"}

# ---------------------------------------------------------------------------
# Message schemas (subset of triton_proto/grpc_service.proto +
# model_config.proto; numbers are the wire contract and must not change).
# ---------------------------------------------------------------------------

# grpc_service.proto: InferParameter (oneof parameter_choice, :441-460) —
# explicit presence: a member encodes even at its default value and is only
# present on decode when its case was set.
INFER_PARAMETER = {
    "bool_param": Field(1, "bool", oneof=True),
    "int64_param": Field(2, "int64", oneof=True),
    "string_param": Field(3, "string", oneof=True),
    "double_param": Field(4, "double", oneof=True),
    "uint64_param": Field(5, "uint64", oneof=True),
}


def _param_map(number: int) -> Field:
    """map<string, InferParameter> field."""
    return Field(
        number,
        "message",
        map_entry=(
            Field(1, "string"),
            Field(2, "message", schema=INFER_PARAMETER),
        ),
    )


# grpc_service.proto: InferTensorContents
INFER_TENSOR_CONTENTS = {
    "bool_contents": Field(1, "bool", repeated=True),
    "int_contents": Field(2, "int32", repeated=True),
    "int64_contents": Field(3, "int64", repeated=True),
    "uint_contents": Field(4, "uint32", repeated=True),
    "uint64_contents": Field(5, "uint64", repeated=True),
    "fp32_contents": Field(6, "float", repeated=True),
    "fp64_contents": Field(7, "double", repeated=True),
    "bytes_contents": Field(8, "bytes", repeated=True),
}

# grpc_service.proto: ModelInferRequest.InferInputTensor
INFER_INPUT_TENSOR = {
    "name": Field(1, "string"),
    "datatype": Field(2, "string"),
    "shape": Field(3, "int64", repeated=True),
    "parameters": _param_map(4),
    "contents": Field(5, "message", schema=INFER_TENSOR_CONTENTS),
}

# grpc_service.proto: ModelInferRequest.InferRequestedOutputTensor
INFER_REQUESTED_OUTPUT = {
    "name": Field(1, "string"),
    "parameters": _param_map(2),
}

# grpc_service.proto:577 ModelInferRequest
MODEL_INFER_REQUEST = {
    "model_name": Field(1, "string"),
    "model_version": Field(2, "string"),
    "id": Field(3, "string"),
    "parameters": _param_map(4),
    "inputs": Field(5, "message", repeated=True, schema=INFER_INPUT_TENSOR),
    "outputs": Field(
        6, "message", repeated=True, schema=INFER_REQUESTED_OUTPUT
    ),
    "raw_input_contents": Field(7, "bytes", repeated=True),
}

# grpc_service.proto: ModelInferResponse.InferOutputTensor
INFER_OUTPUT_TENSOR = {
    "name": Field(1, "string"),
    "datatype": Field(2, "string"),
    "shape": Field(3, "int64", repeated=True),
    "parameters": _param_map(4),
    "contents": Field(5, "message", schema=INFER_TENSOR_CONTENTS),
}

# grpc_service.proto:716 ModelInferResponse
MODEL_INFER_RESPONSE = {
    "model_name": Field(1, "string"),
    "model_version": Field(2, "string"),
    "id": Field(3, "string"),
    "parameters": _param_map(4),
    "outputs": Field(5, "message", repeated=True, schema=INFER_OUTPUT_TENSOR),
    "raw_output_contents": Field(6, "bytes", repeated=True),
}

# grpc_service.proto: ModelStreamInferResponse
MODEL_STREAM_INFER_RESPONSE = {
    "error_message": Field(1, "string"),
    "infer_response": Field(2, "message", schema=MODEL_INFER_RESPONSE),
}

EMPTY: Dict[str, Field] = {}  # ServerLiveRequest / ServerReadyRequest
SERVER_LIVE_RESPONSE = {"live": Field(1, "bool")}
SERVER_READY_RESPONSE = {"ready": Field(1, "bool")}
MODEL_READY_REQUEST = {"name": Field(1, "string"), "version": Field(2, "string")}
MODEL_READY_RESPONSE = {"ready": Field(1, "bool")}
MODEL_CONFIG_REQUEST = {"name": Field(1, "string"), "version": Field(2, "string")}

# grpc_service.proto: ServerMetadata / ModelMetadata
SERVER_METADATA_RESPONSE = {
    "name": Field(1, "string"),
    "version": Field(2, "string"),
    "extensions": Field(3, "string", repeated=True),
}
MODEL_METADATA_REQUEST = {
    "name": Field(1, "string"),
    "version": Field(2, "string"),
}
TENSOR_METADATA = {
    "name": Field(1, "string"),
    "datatype": Field(2, "string"),
    "shape": Field(3, "int64", repeated=True),
}
MODEL_METADATA_RESPONSE = {
    "name": Field(1, "string"),
    "versions": Field(2, "string", repeated=True),
    "platform": Field(3, "string"),
    "inputs": Field(4, "message", repeated=True, schema=TENSOR_METADATA),
    "outputs": Field(5, "message", repeated=True, schema=TENSOR_METADATA),
}

# grpc_service.proto: ModelStatistics family
MODEL_STATISTICS_REQUEST = {
    "name": Field(1, "string"),
    "version": Field(2, "string"),
}
STATISTIC_DURATION = {"count": Field(1, "uint64"), "ns": Field(2, "uint64")}
INFER_STATISTICS = {
    "success": Field(1, "message", schema=STATISTIC_DURATION),
    "fail": Field(2, "message", schema=STATISTIC_DURATION),
    "queue": Field(3, "message", schema=STATISTIC_DURATION),
    "compute_input": Field(4, "message", schema=STATISTIC_DURATION),
    "compute_infer": Field(5, "message", schema=STATISTIC_DURATION),
    "compute_output": Field(6, "message", schema=STATISTIC_DURATION),
    "cache_hit": Field(7, "message", schema=STATISTIC_DURATION),
    "cache_miss": Field(8, "message", schema=STATISTIC_DURATION),
}
INFER_BATCH_STATISTICS = {
    "batch_size": Field(1, "uint64"),
    "compute_input": Field(2, "message", schema=STATISTIC_DURATION),
    "compute_infer": Field(3, "message", schema=STATISTIC_DURATION),
    "compute_output": Field(4, "message", schema=STATISTIC_DURATION),
}
MEMORY_USAGE = {
    "type": Field(1, "string"),
    "id": Field(2, "int64"),
    "byte_size": Field(3, "uint64"),
}
MODEL_STATISTICS = {
    "name": Field(1, "string"),
    "version": Field(2, "string"),
    "last_inference": Field(3, "uint64"),
    "inference_count": Field(4, "uint64"),
    "execution_count": Field(5, "uint64"),
    "inference_stats": Field(6, "message", schema=INFER_STATISTICS),
    "batch_stats": Field(
        7, "message", repeated=True, schema=INFER_BATCH_STATISTICS
    ),
    "memory_usage": Field(8, "message", repeated=True, schema=MEMORY_USAGE),
}
MODEL_STATISTICS_RESPONSE = {
    "model_stats": Field(1, "message", repeated=True, schema=MODEL_STATISTICS),
}

# grpc_service.proto: repository verbs (ModelRepositoryParameter values are
# carried opaquely; this server ignores them like it ignores versions)
REPOSITORY_INDEX_REQUEST = {
    "repository_name": Field(1, "string"),
    "ready": Field(2, "bool"),
}
MODEL_INDEX = {
    "name": Field(1, "string"),
    "version": Field(2, "string"),
    "state": Field(3, "string"),
    "reason": Field(4, "string"),
}
REPOSITORY_INDEX_RESPONSE = {
    "models": Field(1, "message", repeated=True, schema=MODEL_INDEX),
}
REPOSITORY_MODEL_LOAD_REQUEST = {
    "repository_name": Field(1, "string"),
    "model_name": Field(2, "string"),
}
REPOSITORY_MODEL_UNLOAD_REQUEST = {
    "repository_name": Field(1, "string"),
    "model_name": Field(2, "string"),
}

# grpc_service.proto: system shared-memory verbs
SHM_REGION_STATUS = {
    "name": Field(1, "string"),
    "key": Field(2, "string"),
    "offset": Field(3, "uint64"),
    "byte_size": Field(4, "uint64"),
}
SHM_STATUS_REQUEST = {"name": Field(1, "string")}
SHM_STATUS_RESPONSE = {
    "regions": Field(
        1,
        "message",
        map_entry=(
            Field(1, "string"),
            Field(2, "message", schema=SHM_REGION_STATUS),
        ),
    ),
}
SHM_REGISTER_REQUEST = {
    "name": Field(1, "string"),
    "key": Field(2, "string"),
    "offset": Field(3, "uint64"),
    "byte_size": Field(4, "uint64"),
}
SHM_UNREGISTER_REQUEST = {"name": Field(1, "string")}

# grpc_service.proto: TraceSetting
TRACE_SETTING_VALUE = {"value": Field(1, "string", repeated=True)}
TRACE_SETTING_REQUEST = {
    "settings": Field(
        1,
        "message",
        map_entry=(
            Field(1, "string"),
            Field(2, "message", schema=TRACE_SETTING_VALUE),
        ),
    ),
    "model_name": Field(2, "string"),
}
TRACE_SETTING_RESPONSE = {
    "settings": Field(
        1,
        "message",
        map_entry=(
            Field(1, "string"),
            Field(2, "message", schema=TRACE_SETTING_VALUE),
        ),
    ),
}

# grpc_service.proto: CUDA shared-memory verbs (:1494-1616).  Served for
# wire completeness: register is a typed refusal (the server does not map
# another process's cudaIPC handles), status/unregister follow
# Triton's empty-registry semantics so probing clients get well-formed
# answers instead of UNIMPLEMENTED stream errors.
CUDA_SHM_REGION_STATUS = {
    "name": Field(1, "string"),
    "device_id": Field(2, "uint64"),
    "byte_size": Field(3, "uint64"),
}
CUDA_SHM_STATUS_REQUEST = {"name": Field(1, "string")}
CUDA_SHM_STATUS_RESPONSE = {
    "regions": Field(
        1,
        "message",
        map_entry=(
            Field(1, "string"),
            Field(2, "message", schema=CUDA_SHM_REGION_STATUS),
        ),
    ),
}
CUDA_SHM_REGISTER_REQUEST = {
    "name": Field(1, "string"),
    "raw_handle": Field(2, "bytes"),
    "device_id": Field(3, "int64"),
    "byte_size": Field(4, "uint64"),
}
CUDA_SHM_UNREGISTER_REQUEST = {"name": Field(1, "string")}

# grpc_service.proto: LogSettings (:1686-1756) — dynamic log configuration.
# SettingValue is a oneof{bool, uint32, string}; requests carry only the
# keys to change, responses return the full post-update state.
LOG_SETTING_VALUE = {
    "bool_param": Field(1, "bool", oneof=True),
    "uint32_param": Field(2, "uint32", oneof=True),
    "string_param": Field(3, "string", oneof=True),
}
LOG_SETTINGS_REQUEST = {
    "settings": Field(
        1,
        "message",
        map_entry=(
            Field(1, "string"),
            Field(2, "message", schema=LOG_SETTING_VALUE),
        ),
    ),
}
LOG_SETTINGS_RESPONSE = {
    "settings": Field(
        1,
        "message",
        map_entry=(
            Field(1, "string"),
            Field(2, "message", schema=LOG_SETTING_VALUE),
        ),
    ),
}

# model_config.proto: ModelTensorReshape
MODEL_TENSOR_RESHAPE = {"shape": Field(1, "int64", repeated=True)}

# model_config.proto: ModelInput (subset the reference reads:
# name/data_type/dims; format & flags carried for wire fidelity)
MODEL_INPUT = {
    "name": Field(1, "string"),
    "data_type": Field(2, "enum"),
    "format": Field(3, "enum"),
    "dims": Field(4, "int64", repeated=True),
    "reshape": Field(5, "message", schema=MODEL_TENSOR_RESHAPE),
    "is_shape_tensor": Field(6, "bool"),
    "allow_ragged_batch": Field(7, "bool"),
    "optional": Field(8, "bool"),
}

# model_config.proto: ModelOutput
MODEL_OUTPUT = {
    "name": Field(1, "string"),
    "data_type": Field(2, "enum"),
    "dims": Field(3, "int64", repeated=True),
    "label_filename": Field(4, "string"),
    "reshape": Field(5, "message", schema=MODEL_TENSOR_RESHAPE),
    "is_shape_tensor": Field(6, "bool"),
}

# model_config.proto: ModelEnsembling.Step (:1556-1597) — map<string,string>
# input_map/output_map encode as repeated (key=1, value=2) entry messages
_ENSEMBLE_MAP = (Field(1, "string"), Field(2, "string"))
ENSEMBLE_STEP = {
    "model_name": Field(1, "string"),
    "model_version": Field(2, "int64"),
    "input_map": Field(3, "message", map_entry=_ENSEMBLE_MAP),
    "output_map": Field(4, "message", map_entry=_ENSEMBLE_MAP),
}

# model_config.proto: ModelEnsembling (:1548-1607)
MODEL_ENSEMBLING = {
    "step": Field(1, "message", repeated=True, schema=ENSEMBLE_STEP),
}

# model_config.proto: ModelConfig (subset: the reference reads name,
# max_batch_size, input[], output[]; ensemble_scheduling is the
# scheduling_choice member Triton ensembles carry, :1936)
MODEL_CONFIG = {
    "name": Field(1, "string"),
    "platform": Field(2, "string"),
    "max_batch_size": Field(4, "int32"),
    "input": Field(5, "message", repeated=True, schema=MODEL_INPUT),
    "output": Field(6, "message", repeated=True, schema=MODEL_OUTPUT),
    "ensemble_scheduling": Field(15, "message", schema=MODEL_ENSEMBLING),
    "backend": Field(17, "string"),
}

MODEL_CONFIG_RESPONSE = {"config": Field(1, "message", schema=MODEL_CONFIG)}

# model_config.proto enum DataType (TYPE_FP32 = 11, ...)
DATA_TYPE = {
    "BOOL": 1, "UINT8": 2, "UINT16": 3, "UINT32": 4, "UINT64": 5,
    "INT8": 6, "INT16": 7, "INT32": 8, "INT64": 9,
    "FP16": 10, "FP32": 11, "FP64": 12, "STRING": 13, "BF16": 14,
}
#: Triton datatype string -> numpy dtype (InferInputTensor.datatype uses the
#: enum name with the TYPE_ prefix stripped — client.rs:261's [5..] slice).
NP_DTYPE = {
    "BOOL": np.bool_, "UINT8": np.uint8, "UINT16": np.uint16,
    "UINT32": np.uint32, "UINT64": np.uint64, "INT8": np.int8,
    "INT16": np.int16, "INT32": np.int32, "INT64": np.int64,
    "FP16": np.float16, "FP32": np.float32, "FP64": np.float64,
}


# ---------------------------------------------------------------------------
# Model adapters: the detector's NHWC head maps <-> Triton NCHW raw tensors.
# ---------------------------------------------------------------------------


def _detection_output_names(strides) -> List[str]:
    names = []
    for s in strides:
        names += [
            f"face_rpn_cls_prob_reshape_stride{s}",
            f"face_rpn_bbox_pred_stride{s}",
            f"face_rpn_landmark_pred_stride{s}",
        ]
    return names


def detection_triton_view(net_out: Dict[int, Dict[str, Any]], strides) -> List[np.ndarray]:
    """Per-stride NHWC head maps -> the mxnet-RetinaFace NCHW raw tensors.

    A Triton client's host decode consumes, per stride: scores sliced [:, A:, :, :] then permuted/flattened to
    (h*w*A, 1); bbox/landmark maps permuted to NHWC and reshaped to rows of
    4 / (5, 2).  Our flatten order (detection.py topk_decode_and_nms) is
    identical, so the wire view is a channel concat + transpose:
    cls = concat([1-p, p], channel) with p the (b, h, w, A) face
    probability (the A:-slice then yields p in anchor order), bbox and
    landmark transpose as-is (their NHWC channels are already anchor-major
    groups of 4 / 10).
    """
    outs: List[np.ndarray] = []
    for s in strides:
        maps = net_out[int(s)]
        p = np.asarray(maps["score"], dtype=np.float32)  # (b, h, w, A)
        cls = np.concatenate([1.0 - p, p], axis=-1)  # (b, h, w, 2A)
        bbox = np.asarray(maps["bbox"], dtype=np.float32)
        lm = np.asarray(maps["landmark"], dtype=np.float32)
        outs += [
            np.ascontiguousarray(np.transpose(t, (0, 3, 1, 2)))
            for t in (cls, bbox, lm)
        ]
    return outs


class _WireAbort(Exception):
    """A typed per-message failure raised in place of context.abort on the
    streaming path: grpcio's ServicerContext.abort raises a BARE Exception()
    (no detail, context already ended), so a stream handler routing errors
    through it would lose the status and kill the stream.  This carries the
    (StatusCode, detail) pair so model_stream_infer can report it in
    error_message and keep the stream up (Triton stream semantics)."""

    def __init__(self, code, detail: str) -> None:
        super().__init__(detail)
        self.code = code
        self.detail = detail


class _StreamAbortShim:
    """Wraps a stream ServicerContext so abort() raises _WireAbort instead
    of terminating the (shared) stream; everything else forwards."""

    def __init__(self, context) -> None:
        self._context = context

    def abort(self, code, detail):
        raise _WireAbort(code, detail)

    def __getattr__(self, name):
        return getattr(self._context, name)


class TritonWireServicer:
    """The GRPCInferenceService subset over a ModelRegistry.

    Runs each registered module eagerly on the registry's device -- the
    wire layer is the drop-in-parity surface; throughput serving should use
    the facade's Detect/Extract verbs, which batch and keep decode+NMS on
    the device.
    """

    def __init__(self, registry, facade=None) -> None:
        """facade: the JSON FacePipelineServicer sharing this gRPC server,
        if any — shared so shm regions registered over either protocol are
        visible to both, and so TraceSetting toggles the same server-side
        torch.profiler session."""
        self.registry = registry
        self.facade = facade
        self._own_shm = None
        self._closed = False  # set by close(): no batcher is made after it
        # per-(model, item shape) dynamic batchers for repository models
        # whose config.pbtxt carries dynamic_batching{} (Triton scheduler
        # semantics, model_config.proto:1104)
        self._batchers: Dict[Tuple[str, Tuple[int, ...], str], Any] = {}
        self._lock = threading.Lock()
        # LogSettings state (Triton's defaults, grpc_service.proto:1686)
        self._log_settings: Dict[str, Any] = {
            "log_file": "",
            "log_info": True,
            "log_warning": True,
            "log_error": True,
            "log_verbose_level": 0,
            "log_format": "default",
        }
        self._log_file_path = ""
        self._log_file_handler = None

    @property
    def shm(self):
        if self.facade is not None:
            return self.facade.shm
        if self._own_shm is None:
            from .shm import SharedMemoryRegistry

            self._own_shm = SharedMemoryRegistry()
        return self._own_shm

    # -- health ----------------------------------------------------------

    def health_check(self, request, context):
        """grpc.health.v1.Health/Check (health.proto:70-78).  Empty service
        = whole-server health; the two service names this server exposes
        answer individually; anything else is NOT_FOUND per the gRPC health
        protocol spec."""
        import grpc

        service = request["service"]
        if service in ("", SERVICE, HEALTH_SERVICE):
            live = self.registry.server_live()
            return {"status": 1 if live else 2}  # SERVING / NOT_SERVING
        context.abort(
            grpc.StatusCode.NOT_FOUND, f"unknown service {service!r}"
        )

    def server_live(self, request, context):
        return {"live": self.registry.server_live()}

    def server_ready(self, request, context):
        return {"ready": self.registry.server_ready()}

    def model_ready(self, request, context):
        return {"ready": self.registry.model_ready(request["name"])}

    # -- metadata ----------------------------------------------------------

    def server_metadata(self, request, context):
        from .. import __version__

        return {
            "name": "rs_face_detection_tpu_torch",
            "version": __version__,
            # the Triton extension tags for the verb families served here
            "extensions": [
                "model_repository",
                "statistics",
                "trace",
                "system_shared_memory",
                "logging",
            ],
        }

    def model_metadata(self, request, context):
        import grpc

        name = request["name"]
        try:
            spec = self.registry.spec(name)
        except KeyError:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"Request for unknown model: '{name}' is not found",
            )
        config = self.model_config(request, context)["config"]
        return {
            "name": spec.name,
            "versions": ["1"],
            "platform": config.get("platform", PLATFORM),
            "inputs": [
                {"name": i["name"], "datatype": "FP32", "shape": i["dims"]}
                for i in config["input"]
            ],
            "outputs": [
                {"name": o["name"], "datatype": "FP32", "shape": o["dims"]}
                for o in config["output"]
            ],
        }

    def model_statistics(self, request, context):
        """Registry counters in Triton's ModelStatistics shape.

        Durations land in compute_infer (the registry times whole forward
        passes; there is no separate input/output staging to attribute)."""
        import grpc

        name = request["name"]
        names = [name] if name else [m["name"] for m in self.registry.index()
                                     if m["state"] == "READY"]
        stats_out = []
        for n in names:
            try:
                st = self.registry.statistics(n)
            except KeyError:
                context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"Request for unknown model: '{n}' is not found",
                )
            total_ns = int(st.cumulative_duration_s * 1e9)
            device = self.registry.device
            dur = {"count": int(st.execution_count), "ns": total_ns}
            stats_out.append(
                {
                    "name": n,
                    "version": "1",
                    "inference_count": int(st.inference_count),
                    "execution_count": int(st.execution_count),
                    "inference_stats": {
                        "success": dur,
                        "compute_infer": dur,
                    },
                    "batch_stats": [
                        {
                            "batch_size": int(b),
                            "compute_infer": {"count": int(c), "ns": 0},
                        }
                        for b, c in sorted(st.batch_size_counts.items())
                    ],
                    "memory_usage": [
                        {
                            "type": "GPU" if device.type == "cuda" else "CPU",
                            "id": int(device.index or 0),
                            "byte_size": int(
                                self.registry.memory_usage_bytes(n)
                            ),
                        }
                    ],
                }
            )
        return {"model_stats": stats_out}

    # -- repository ----------------------------------------------------------

    def repository_index(self, request, context):
        models = [
            {"name": m["name"], "version": "1", "state": m["state"],
             "reason": ""}
            for m in self.registry.index()
            if not request["ready"] or m["state"] == "READY"
        ]
        return {"models": models}

    def repository_model_load(self, request, context):
        import grpc

        name = request["model_name"]
        try:
            self.registry.load(name)
            # Triton semantics: loading an ensemble loads its composing
            # models too (they must be servable before the ensemble is
            # READY).  A member missing from the registry entirely is a
            # broken ensemble -> NOT_FOUND, naming the missing member.
            defn = self._ensemble_definition(name)
            if defn is not None:
                for step in defn.steps:
                    name = step.model_name
                    self.registry.load(name)
        except KeyError:
            missing = f"'{name}'"
            if name != request["model_name"]:
                missing = f"{missing} (member of ensemble '{request['model_name']}')"
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"Request for unknown model: {missing} is not found",
            )
        except Exception as e:
            context.abort(
                grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
            )
        return {}

    def repository_model_unload(self, request, context):
        self.registry.unload(request["model_name"])
        return {}

    # -- system shared memory ------------------------------------------------

    def system_shared_memory_register(self, request, context):
        import grpc

        try:
            self.shm.register(
                request["name"], request["key"], int(request["byte_size"])
            )
        except Exception as e:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, f"{type(e).__name__}: {e}"
            )
        return {}

    def system_shared_memory_status(self, request, context):
        import grpc

        try:
            regions = self.shm.status(request["name"] or None)
        except Exception as e:
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"{type(e).__name__}: {e}"
            )
        return {
            "regions": {
                n: {
                    "name": n,
                    "key": r["key"],
                    "offset": 0,
                    "byte_size": int(r["byte_size"]),
                }
                for n, r in regions.items()
            }
        }

    def system_shared_memory_unregister(self, request, context):
        import grpc

        try:
            self.shm.unregister(request["name"] or None)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, f"KeyError: {e}")
        return {}

    # -- CUDA shared memory (typed refusal / empty-registry semantics) ------

    _CUDA_SHM_ERROR = (
        "CUDA shared memory is not served: this server does not map another "
        "process's cudaIPC handles; use system shared memory "
        "(SystemSharedMemoryRegister) for zero-copy tensors"
    )

    def cuda_shared_memory_register(self, request, context):
        import grpc

        context.abort(grpc.StatusCode.UNIMPLEMENTED, self._CUDA_SHM_ERROR)

    def cuda_shared_memory_status(self, request, context):
        import grpc

        if request["name"]:
            # No CUDA region can ever be registered here, so any named
            # lookup is NOT_FOUND (Triton status semantics); a blanket
            # status is simply the empty map.
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"CUDA shared-memory region {request['name']!r} is not "
                "registered (none can be)",
            )
        return {"regions": {}}

    def cuda_shared_memory_unregister(self, request, context):
        import grpc

        if request["name"]:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"CUDA shared-memory region {request['name']!r} is not "
                "registered (none can be)",
            )
        return {}  # empty name = unregister all, a no-op on the empty set

    # -- log settings --------------------------------------------------------

    def log_settings(self, request, context):
        """Triton dynamic log configuration (grpc_service.proto:1686-1756)
        mapped onto Python logging for the package logger: the
        log_info/log_warning/log_error booleans and log_verbose_level pick
        the threshold; log_file attaches/replaces a FileHandler; log_format
        is accepted and echoed.  Returns the full post-update state.

        Triton semantics preserved: the whole request is validated before
        ANY state changes (a rejected request leaves the prior settings —
        including a working log_file handler — fully in effect), and a
        SettingValue whose oneof case does not match the key's expected
        type is INVALID_ARGUMENT, not coerced."""
        import grpc
        import logging

        # Phase 1: validate every key/value with no side effects.
        updates: Dict[str, Any] = {}
        for key, val in (request["settings"] or {}).items():
            if key not in self._log_settings:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"unknown log setting {key!r}",
                )
            val = val or {}
            if key in ("log_info", "log_warning", "log_error"):
                want = "bool_param"
            elif key == "log_verbose_level":
                want = "uint32_param"
            else:  # log_file / log_format
                want = "string_param"
            if want not in val or any(k != want for k in val):
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"log setting {key!r} expects {want}, got "
                    f"{sorted(val) or 'no value'}",
                )
            cast = {"bool_param": bool, "uint32_param": int, "string_param": str}
            updates[key] = cast[want](val[want])

        # Phase 2: apply atomically.  _lock also guards the batchers;
        # contention here is negligible (LogSettings is a rare admin verb).
        logger = logging.getLogger("rs_face_detection_tpu_torch")
        with self._lock:
            new_file = updates.get("log_file", self._log_file_path)
            new_handler = self._log_file_handler
            if new_file != self._log_file_path:
                if new_file:
                    try:
                        # Open the new handler BEFORE touching the old one so
                        # a bad path leaves existing file logging intact.
                        new_handler = logging.FileHandler(new_file)
                    except OSError as e:
                        context.abort(
                            grpc.StatusCode.INVALID_ARGUMENT,
                            f"log_file: {e}",
                        )
                else:
                    new_handler = None

            self._log_settings.update(updates)
            s = self._log_settings
            if s["log_verbose_level"] > 0:
                level = logging.DEBUG
            elif s["log_info"]:
                level = logging.INFO
            elif s["log_warning"]:
                level = logging.WARNING
            else:
                level = logging.ERROR if s["log_error"] else logging.CRITICAL
            logger.setLevel(level)
            if new_handler is not self._log_file_handler:
                if self._log_file_handler is not None:
                    logger.removeHandler(self._log_file_handler)
                    self._log_file_handler.close()
                self._log_file_handler = new_handler
                self._log_file_path = new_file
                if new_handler is not None:
                    logger.addHandler(new_handler)

            out = {}
            settings_snapshot = dict(s)

        for key, value in settings_snapshot.items():
            if isinstance(value, bool):
                out[key] = {"bool_param": value}
            elif isinstance(value, int):
                out[key] = {"uint32_param": value}
            else:
                out[key] = {"string_param": value}
        return {"settings": out}

    # -- trace -----------------------------------------------------------------

    def trace_setting(self, request, context):
        """Triton trace settings mapped onto the facade's torch.profiler verb:
        trace_level [TIMESTAMPS|...] starts a device trace, [OFF] stops it,
        an empty settings map reports status; trace_file in the response
        carries the profiler directory."""
        import grpc
        import json as _json

        if self.facade is None:
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                "trace requires the facade servicer (serve() wires it)",
            )
        levels = (request["settings"].get("trace_level") or {}).get("value", [])
        if not request["settings"]:
            action = {"action": "status"}
        elif levels == ["OFF"]:
            action = {"action": "stop"}
        else:
            action = {"action": "start"}
        out = _json.loads(self.facade.trace_setting(_json.dumps(action).encode()))
        if "error" in out:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, out["error"])
        settings = {
            "trace_level": {
                "value": ["TIMESTAMPS"] if out.get("active") else ["OFF"]
            },
        }
        if out.get("dir"):
            settings["trace_file"] = {"value": [out["dir"]]}
        return {"settings": settings}

    # -- config ------------------------------------------------------------

    def _detection_cfg(self):
        from ..configs import FaceDetectionConfig

        return FaceDetectionConfig()

    def _ensemble_definition(self, name: str):
        """The EnsembleDefinition for `name`, or None if it is an ordinary
        model (raises KeyError for unknown names, like registry access)."""
        from .repository import EnsembleDefinition

        module = self.registry.get(name)
        return module if isinstance(module, EnsembleDefinition) else None

    @staticmethod
    def _config_tensor(spec: Dict[str, Any]) -> Dict[str, Any]:
        """A declared config.pbtxt input/output entry -> wire ModelConfig
        tensor dict (data_type text enum -> proto number)."""
        from .repository import as_list

        dt = str(spec.get("data_type", "TYPE_FP32"))
        return {
            "name": str(spec.get("name", "")),
            "data_type": DATA_TYPE.get(dt.replace("TYPE_", ""), 0),
            "dims": [int(d) for d in as_list(spec.get("dims"))],
        }

    def model_config(self, request, context):
        import grpc

        name = request["name"]
        try:
            spec = self.registry.spec(name)
            defn = self._ensemble_definition(name)
        except KeyError:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"Request for unknown model: '{name}' is not found",
            )
        if defn is not None:
            return {
                "config": {
                    "name": name,
                    "platform": "ensemble",
                    "max_batch_size": defn.max_batch_size,
                    "input": [self._config_tensor(i) for i in defn.inputs],
                    "output": [self._config_tensor(o) for o in defn.outputs],
                    "ensemble_scheduling": {
                        "step": [
                            {
                                "model_name": s.model_name,
                                "model_version": s.model_version,
                                "input_map": dict(s.input_map),
                                "output_map": dict(s.output_map),
                            }
                            for s in defn.steps
                        ]
                    },
                }
            }
        h, w, c = spec.input_shape
        fp32 = DATA_TYPE["FP32"]
        config: Dict[str, Any] = {
            "name": name,
            "platform": PLATFORM,
            "backend": "rs_face_detection_tpu_torch",
            "max_batch_size": 0,  # dims below carry the full (1, C, H, W)
            "input": [
                {
                    "name": "data",
                    "data_type": fp32,
                    "format": 2,  # FORMAT_NCHW
                    "dims": [1, c, h, w],
                }
            ],
        }
        if name == self._detection_cfg().model_name:
            cfg = self._detection_cfg()
            a = 2  # anchors per cell (RPN_ANCHOR_CFG)
            outputs = []
            for s in cfg.feat_strides:
                fh, fw = h // s, w // s
                for oname, ch in zip(
                    _detection_output_names([s]), (2 * a, 4 * a, 10 * a)
                ):
                    outputs.append(
                        {
                            "name": oname,
                            "data_type": fp32,
                            "dims": [1, ch, fh, fw],
                        }
                    )
            config["output"] = outputs
        else:
            config["output"] = [
                {"name": "output", "data_type": fp32, "dims": [-1, -1]}
            ]
        return {"config": config}

    # -- infer -------------------------------------------------------------

    def _run(self, name: str, x: np.ndarray):
        """The module's forward on the NCHW batch ``x``, on the registry's
        device: the input cast to the module's parameter dtype, outputs left
        on the device (not yet synchronized)."""
        module = self.registry.get(name)
        params = [p for p in module.parameters() if p.is_floating_point()]
        dtype = params[0].dtype if params else torch.float32
        xt = torch.from_numpy(np.require(x, requirements=["C", "W"])).to(self.registry.device, dtype)
        with torch.inference_mode():
            return module(xt)

    def _sync(self) -> None:
        """Wait for the registry's device (the clock stops after it)."""
        if self.registry.device.type == "cuda":
            torch.cuda.synchronize(self.registry.device)

    @staticmethod
    def _host(out):
        """Device outputs -> host f32 numpy, per-stride dicts kept."""
        if isinstance(out, dict):
            return {k: TritonWireServicer._host(v) for k, v in out.items()}
        return out.detach().float().cpu().numpy()

    def _forward(self, name: str, x: np.ndarray):
        start = time.perf_counter()
        out = self._run(name, x)
        self._sync()
        # statistics parity: wire traffic shows up in ModelStatistics (both
        # protocols) like every other inference surface
        self.registry.record(name, int(x.shape[0]), time.perf_counter() - start)
        return self._host(out)

    def close(self) -> None:
        """Stop the dynamic-batcher workers (idempotent); no batcher is made
        after it, so a request that races it fails instead of starting a
        worker nobody stops."""
        with self._lock:
            self._closed = True
            batchers, self._batchers = list(self._batchers.values()), {}
        for b in batchers:
            b.close()

    def _dynamic_forward(self, name: str, x: np.ndarray):
        """Route a single-item forward through the model's dynamic batcher
        (created lazily per item shape).  Batches pad to max_batch_size, so
        every coalesced call has ONE shape -- short batches ride the zero
        rows, Triton's preferred_batch_size made moot."""
        key = (name, tuple(x.shape[1:]), str(x.dtype))
        while True:
            batcher = self._get_or_create_batcher(name, key)
            try:
                fut = batcher.submit(x)
            except RuntimeError:
                # Closed between the dict fetch and the submit: evicted by a
                # concurrent request for a third shape of this model (the
                # two-live-shapes bound below), or by close().  Drop the dead
                # entry and retry; after close() the retry raises.  submit()
                # raises ONLY for the closed case, so this cannot mask a
                # model error (those surface via the future's result()).
                with self._lock:
                    if self._batchers.get(key) is batcher:
                        self._batchers.pop(key)
                continue
            return fut.result()

    def _get_or_create_batcher(self, name: str, key):
        from .batcher import DynamicBatcher

        with self._lock:
            if self._closed:
                raise RuntimeError("the wire servicer is closed")
            batcher = self._batchers.get(key)
        if batcher is None:
            spec = self.registry.spec(name)
            cap = max(1, int(spec.max_batch_size))

            def batch_fn(items):
                k = len(items)
                x = np.concatenate(items, axis=0)
                if k < cap:
                    x = np.concatenate(
                        [x, np.zeros((cap - k,) + x.shape[1:], x.dtype)]
                    )
                start = time.perf_counter()
                out = self._run(name, x)
                self._sync()
                self.registry.record(name, k, time.perf_counter() - start)
                out = self._host(out)
                if isinstance(out, dict):  # detection: per-stride head maps
                    return [
                        {s: {mk: v[i : i + 1] for mk, v in maps.items()}
                         for s, maps in out.items()}
                        for i in range(k)
                    ]
                return [out[i : i + 1] for i in range(k)]

            batcher = DynamicBatcher(
                batch_fn=batch_fn,
                batch_size=cap,
                max_delay_ms=spec.max_queue_delay_us / 1000.0,
            )
            dropped = []
            with self._lock:
                existing = self._batchers.get(key)
                if self._closed:
                    dropped.append(batcher)  # close() ran while it was made
                    batcher = None
                elif existing is not None:
                    dropped.append(batcher)  # lost the creation race
                    batcher = existing
                else:
                    self._batchers[key] = batcher
                    # bound the workers: two live shapes per model
                    keys = [k2 for k2 in self._batchers if k2[0] == name]
                    for k2 in keys[:-2]:
                        dropped.append(self._batchers.pop(k2))
            for b in dropped:
                b.close()
            if batcher is None:
                raise RuntimeError("the wire servicer is closed")
        return batcher

    def _parse_input_tensor(self, tensor, raw_blob, context) -> np.ndarray:
        """One InferInputTensor -> fp32 host array of the declared shape
        (wire NCHW convention; the caller decides the rank contract)."""
        import grpc

        datatype = tensor["datatype"] or "FP32"
        np_dtype = NP_DTYPE.get(datatype)
        if np_dtype is None:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"unsupported datatype {datatype!r}",
            )
        shape = [int(d) for d in tensor["shape"]]
        params = tensor["parameters"] or {}
        shm_region = (params.get("shared_memory_region") or {}).get(
            "string_param", ""
        )
        try:
            if shm_region:
                # Triton's shm tensor reference: data lives in a registered
                # system shared-memory region, not on the wire
                # (grpc_service.proto InferParameter conventions).
                offset = int(
                    (params.get("shared_memory_offset") or {}).get(
                        "int64_param", 0
                    )
                )
                region = self.shm.get(shm_region)
                x = region.read_array(
                    np.dtype(np_dtype).name, tuple(shape), offset
                ).reshape(shape)
            elif raw_blob is not None:
                x = np.frombuffer(
                    raw_blob, dtype=np.dtype(np_dtype).newbyteorder("<")
                )
            elif tensor["contents"] is not None:
                contents = tensor["contents"]
                if datatype == "FP32":
                    x = np.asarray(contents["fp32_contents"], dtype=np.float32)
                elif datatype == "FP64":
                    x = np.asarray(contents["fp64_contents"], dtype=np.float64)
                elif datatype in ("INT32", "INT16", "INT8"):
                    x = np.asarray(contents["int_contents"], dtype=np_dtype)
                elif datatype in ("UINT32", "UINT16", "UINT8"):
                    x = np.asarray(contents["uint_contents"], dtype=np_dtype)
                elif datatype == "INT64":
                    x = np.asarray(contents["int64_contents"], dtype=np.int64)
                elif datatype == "UINT64":
                    x = np.asarray(contents["uint64_contents"], dtype=np.uint64)
                elif datatype == "BOOL":
                    x = np.asarray(contents["bool_contents"], dtype=np.bool_)
                else:
                    raise ValueError(f"no typed contents field for {datatype}")
            else:
                raise ValueError("input tensor has neither contents nor raw bytes")
            return x.reshape(shape).astype(np.float32, copy=False)
        except (ValueError, KeyError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    def _named_outputs(self, out) -> Tuple[List[str], List[np.ndarray]]:
        """A member forward's result -> the wire's named NCHW output view."""
        if isinstance(out, dict):  # detection: per-stride head maps
            cfg = self._detection_cfg()
            return (
                _detection_output_names(cfg.feat_strides),
                detection_triton_view(out, cfg.feat_strides),
            )
        return ["output"], [np.asarray(out, dtype=np.float32)]

    def _ensemble_infer(self, defn, inputs, raw, context):
        """Run an ensemble dataflow (model_config.proto ModelEnsembling):
        seed the tensor pool from the request inputs, execute the steps in
        dependency order through the same member forwards the wire serves
        individually, and return the declared ensemble outputs.
        Pool arrays keep the wire's NCHW convention, so a member's
        image-shaped output chains into the next member unchanged."""
        import grpc

        # Triton aligns raw_input_contents blobs with the inputs that have
        # neither a shared-memory reference nor typed contents, in order —
        # a request mixing shm and raw inputs contributes fewer blobs than
        # inputs (grpc_service.proto raw_input_contents conventions).
        def consumes_raw(tensor) -> bool:
            params = tensor["parameters"] or {}
            shm = (params.get("shared_memory_region") or {}).get(
                "string_param", ""
            )
            return not shm and tensor["contents"] is None

        raw_queue = list(raw or ())
        need_raw = sum(consumes_raw(t) for t in inputs)
        if raw_queue and len(raw_queue) != need_raw:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"raw_input_contents carries {len(raw_queue)} blobs for "
                f"{need_raw} raw-data input(s)",
            )
        pool: Dict[str, np.ndarray] = {}
        next_raw = 0
        for tensor in inputs:
            tname = tensor["name"]
            if not tname:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    "ensemble request inputs must be named (they seed the "
                    "ensemble tensor pool)",
                )
            blob = None
            if raw_queue and consumes_raw(tensor):
                blob = raw_queue[next_raw]
                next_raw += 1
            pool[tname] = self._parse_input_tensor(tensor, blob, context)
        declared = [str(t.get("name")) for t in defn.inputs]
        missing = [n for n in declared if n not in pool]
        if missing:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"ensemble {defn.name!r}: missing input tensor(s) {missing}",
            )
        first = pool[declared[0]]
        batch = int(first.shape[0]) if first.ndim >= 1 else 1
        start = time.perf_counter()
        for step in defn.steps:
            if len(step.input_map) != 1:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"ensemble step {step.model_name!r}: member models take "
                    f"exactly one input tensor, input_map has "
                    f"{len(step.input_map)}",
                )
            ((_, ens_name),) = step.input_map
            x = pool[ens_name]
            if x.ndim != 4:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"ensemble tensor {ens_name!r} feeding "
                    f"{step.model_name!r} must be NCHW 4-d, got shape "
                    f"{list(x.shape)}",
                )
            # resolve the member BEFORE running it (lazily building a
            # repository member on first use, exactly as a direct lookup
            # would — members need not be explicitly loaded, matching
            # Triton, where loading an ensemble loads its composing
            # models): a KeyError raised inside the member's own forward
            # must surface as INTERNAL, not be masked as NOT_FOUND
            try:
                self.registry.get(step.model_name)
            except KeyError:
                context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"ensemble {defn.name!r}: member model "
                    f"'{step.model_name}' is not found",
                )
            try:
                out = self._forward(step.model_name, x)
            except Exception as e:
                context.abort(
                    grpc.StatusCode.INTERNAL,
                    f"ensemble member {step.model_name!r}: "
                    f"{type(e).__name__}: {e}",
                )
            names, arrays = self._named_outputs(out)
            by_name = dict(zip(names, arrays))
            for member_out, ens_out in step.output_map:
                if member_out not in by_name:
                    context.abort(
                        grpc.StatusCode.INVALID_ARGUMENT,
                        f"ensemble step {step.model_name!r} maps output "
                        f"{member_out!r}, but the member produces {names}",
                    )
                pool[ens_out] = by_name[member_out]
        # ensemble-level statistics on top of the members' own (Triton
        # accounts both the ensemble and its composing models)
        self.registry.record(defn.name, batch, time.perf_counter() - start)
        out_names = [str(t.get("name")) for t in defn.outputs]
        return out_names, [
            np.asarray(pool[n], dtype=np.float32) for n in out_names
        ]

    def model_infer(self, request, context):
        import grpc

        name = request["model_name"]
        if not self.registry.model_ready(name):
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"Request for unknown model: '{name}' is not found",
            )
        inputs = request["inputs"]
        raw = request["raw_input_contents"]
        defn = self._ensemble_definition(name)
        if defn is not None:
            names, arrays = self._ensemble_infer(defn, inputs, raw, context)
        else:
            if len(inputs) != 1:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"expected 1 input tensor, got {len(inputs)}",
                )
            x = self._parse_input_tensor(
                inputs[0], raw[0] if raw else None, context
            )
            if x.ndim != 4:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"expected NCHW input shape, got {list(x.shape)}",
                )
            spec = self.registry.spec(name)
            coalesce = (
                getattr(spec, "dynamic_batching", False)
                and x.shape[0] == 1
                and int(spec.max_batch_size) > 1
            )
            try:
                if coalesce:
                    out = self._dynamic_forward(name, x)
                else:
                    out = self._forward(name, x)
            except Exception as e:  # typed gRPC error, never UNKNOWN
                context.abort(
                    grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}"
                )
            names, arrays = self._named_outputs(out)

        shm_refs: Dict[str, Tuple[str, int]] = {}
        requested = [o["name"] for o in request["outputs"]]
        for o in request["outputs"]:
            op = o["parameters"] or {}
            region = (op.get("shared_memory_region") or {}).get(
                "string_param", ""
            )
            if region:
                off = int(
                    (op.get("shared_memory_offset") or {}).get("int64_param", 0)
                )
                shm_refs[o["name"]] = (region, off)
        if requested:
            by_name = dict(zip(names, arrays))
            missing = [n for n in requested if n not in by_name]
            if missing:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"unknown output tensor(s): {missing}",
                )
            names = requested
            arrays = [by_name[n] for n in requested]

        out_meta, raw_out = [], []
        for n, a in zip(names, arrays):
            meta: Dict[str, Any] = {
                "name": n,
                "datatype": "FP32",
                "shape": list(a.shape),
            }
            if n in shm_refs:
                # Triton shm-output semantics: data goes into the region;
                # raw_output_contents carries only the non-shm outputs.
                region_name, off = shm_refs[n]
                blob = np.ascontiguousarray(a, dtype="<f4")
                try:
                    self.shm.get(region_name).write_array(blob, off)
                except (ValueError, KeyError) as e:
                    context.abort(
                        grpc.StatusCode.INVALID_ARGUMENT,
                        f"output {n!r} shm: {e}",
                    )
                meta["parameters"] = {
                    "shared_memory_region": {"string_param": region_name},
                    "shared_memory_offset": {"int64_param": off},
                    "shared_memory_byte_size": {
                        "int64_param": int(blob.nbytes)
                    },
                }
            else:
                raw_out.append(np.ascontiguousarray(a, dtype="<f4").tobytes())
            out_meta.append(meta)

        return {
            "model_name": name,
            "model_version": request["model_version"] or "1",
            "id": request["id"],
            "outputs": out_meta,
            "raw_output_contents": raw_out,
        }

    def model_stream_infer(self, request_iterator, context):
        """stream ModelInferRequest -> stream ModelStreamInferResponse.

        Per-message errors ride the error_message field (Triton stream
        semantics) instead of aborting the whole stream: model_infer's
        context.abort calls are rerouted through _StreamAbortShim into
        catchable _WireAbort exceptions (a real abort would raise a bare
        Exception() with the detail lost and the stream context dead)."""
        shim = _StreamAbortShim(context)
        for request in request_iterator:
            try:
                yield {
                    "error_message": "",
                    "infer_response": self.model_infer(request, shim),
                }
            except _WireAbort as e:
                yield {"error_message": f"[{e.code.name}] {e.detail}",
                       "infer_response": None}
            except Exception as e:  # noqa: BLE001 — stream stays up
                yield {"error_message": f"{type(e).__name__}: {e}",
                       "infer_response": None}


def _ser(schema):
    return functools.partial(encode_message, schema)


def _de(schema):
    return functools.partial(decode_message, schema)


def wire_handlers(servicer: TritonWireServicer):
    """The generic gRPC handler for inference.GRPCInferenceService."""
    import grpc

    def unary(fn, req_schema, resp_schema):
        return grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=_de(req_schema),
            response_serializer=_ser(resp_schema),
        )

    rpcs = {
        "ServerLive": unary(servicer.server_live, EMPTY, SERVER_LIVE_RESPONSE),
        "ServerReady": unary(
            servicer.server_ready, EMPTY, SERVER_READY_RESPONSE
        ),
        "ModelReady": unary(
            servicer.model_ready, MODEL_READY_REQUEST, MODEL_READY_RESPONSE
        ),
        "ServerMetadata": unary(
            servicer.server_metadata, EMPTY, SERVER_METADATA_RESPONSE
        ),
        "ModelMetadata": unary(
            servicer.model_metadata,
            MODEL_METADATA_REQUEST,
            MODEL_METADATA_RESPONSE,
        ),
        "ModelConfig": unary(
            servicer.model_config, MODEL_CONFIG_REQUEST, MODEL_CONFIG_RESPONSE
        ),
        "ModelStatistics": unary(
            servicer.model_statistics,
            MODEL_STATISTICS_REQUEST,
            MODEL_STATISTICS_RESPONSE,
        ),
        "RepositoryIndex": unary(
            servicer.repository_index,
            REPOSITORY_INDEX_REQUEST,
            REPOSITORY_INDEX_RESPONSE,
        ),
        "RepositoryModelLoad": unary(
            servicer.repository_model_load,
            REPOSITORY_MODEL_LOAD_REQUEST,
            EMPTY,
        ),
        "RepositoryModelUnload": unary(
            servicer.repository_model_unload,
            REPOSITORY_MODEL_UNLOAD_REQUEST,
            EMPTY,
        ),
        "SystemSharedMemoryRegister": unary(
            servicer.system_shared_memory_register, SHM_REGISTER_REQUEST, EMPTY
        ),
        "SystemSharedMemoryStatus": unary(
            servicer.system_shared_memory_status,
            SHM_STATUS_REQUEST,
            SHM_STATUS_RESPONSE,
        ),
        "SystemSharedMemoryUnregister": unary(
            servicer.system_shared_memory_unregister,
            SHM_UNREGISTER_REQUEST,
            EMPTY,
        ),
        "TraceSetting": unary(
            servicer.trace_setting,
            TRACE_SETTING_REQUEST,
            TRACE_SETTING_RESPONSE,
        ),
        "CudaSharedMemoryRegister": unary(
            servicer.cuda_shared_memory_register,
            CUDA_SHM_REGISTER_REQUEST,
            EMPTY,
        ),
        "CudaSharedMemoryStatus": unary(
            servicer.cuda_shared_memory_status,
            CUDA_SHM_STATUS_REQUEST,
            CUDA_SHM_STATUS_RESPONSE,
        ),
        "CudaSharedMemoryUnregister": unary(
            servicer.cuda_shared_memory_unregister,
            CUDA_SHM_UNREGISTER_REQUEST,
            EMPTY,
        ),
        "LogSettings": unary(
            servicer.log_settings,
            LOG_SETTINGS_REQUEST,
            LOG_SETTINGS_RESPONSE,
        ),
        "ModelInfer": unary(
            servicer.model_infer, MODEL_INFER_REQUEST, MODEL_INFER_RESPONSE
        ),
        "ModelStreamInfer": grpc.stream_stream_rpc_method_handler(
            servicer.model_stream_infer,
            request_deserializer=_de(MODEL_INFER_REQUEST),
            response_serializer=_ser(MODEL_STREAM_INFER_RESPONSE),
        ),
    }
    return grpc.method_handlers_generic_handler(SERVICE, rpcs)


def health_handlers(servicer: TritonWireServicer):
    """The generic gRPC handler for grpc.health.v1.Health (health.proto)."""
    import grpc

    return grpc.method_handlers_generic_handler(
        HEALTH_SERVICE,
        {
            "Check": grpc.unary_unary_rpc_method_handler(
                servicer.health_check,
                request_deserializer=_de(HEALTH_CHECK_REQUEST),
                response_serializer=_ser(HEALTH_CHECK_RESPONSE),
            ),
        },
    )


# ---------------------------------------------------------------------------
# Client — the reference TritonInferenceClient subset (client.rs:71-118),
# speaking the same hand-rolled protobuf bytes.
# ---------------------------------------------------------------------------


class TritonWireClient:
    """Protobuf Triton client for the wire service (and any real Triton
    server serving the same models — the bytes are genuine proto3)."""

    def __init__(self, target: str, timeout_s: float = 30.0) -> None:
        import grpc

        self._channel = grpc.insecure_channel(
            target,
            options=[
                # 640x640x3 fp32 tensors are ~4.9 MB each way; Triton
                # clients run with the 4 MB default lifted
                ("grpc.max_receive_message_length", -1),
                ("grpc.max_send_message_length", -1),
            ],
        )
        self._timeout = timeout_s

    def close(self) -> None:
        self._channel.close()

    def _unary(self, method, req_schema, resp_schema, request):
        fn = self._channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=_ser(req_schema),
            response_deserializer=_de(resp_schema),
        )
        return fn(request, timeout=self._timeout)

    def health_check(self, service: str = "") -> str:
        """grpc.health.v1.Health/Check — returns the ServingStatus name
        ("SERVING", "NOT_SERVING", ...)."""
        fn = self._channel.unary_unary(
            f"/{HEALTH_SERVICE}/Check",
            request_serializer=_ser(HEALTH_CHECK_REQUEST),
            response_deserializer=_de(HEALTH_CHECK_RESPONSE),
        )
        out = fn({"service": service}, timeout=self._timeout)
        return HEALTH_SERVING_STATUS.get(out["status"], "UNKNOWN")

    def server_live(self) -> bool:
        return self._unary("ServerLive", EMPTY, SERVER_LIVE_RESPONSE, {})["live"]

    def server_ready(self) -> bool:
        return self._unary("ServerReady", EMPTY, SERVER_READY_RESPONSE, {})[
            "ready"
        ]

    def model_ready(self, name: str) -> bool:
        return self._unary(
            "ModelReady", MODEL_READY_REQUEST, MODEL_READY_RESPONSE,
            {"name": name},
        )["ready"]

    def model_config(self, name: str) -> Dict[str, Any]:
        return self._unary(
            "ModelConfig", MODEL_CONFIG_REQUEST, MODEL_CONFIG_RESPONSE,
            {"name": name},
        )["config"]

    def server_metadata(self) -> Dict[str, Any]:
        return self._unary(
            "ServerMetadata", EMPTY, SERVER_METADATA_RESPONSE, {}
        )

    def model_metadata(self, name: str) -> Dict[str, Any]:
        return self._unary(
            "ModelMetadata", MODEL_METADATA_REQUEST, MODEL_METADATA_RESPONSE,
            {"name": name},
        )

    def model_statistics(self, name: str = "") -> List[Dict[str, Any]]:
        return self._unary(
            "ModelStatistics",
            MODEL_STATISTICS_REQUEST,
            MODEL_STATISTICS_RESPONSE,
            {"name": name},
        )["model_stats"]

    def repository_index(self, ready_only: bool = False) -> List[Dict[str, Any]]:
        return self._unary(
            "RepositoryIndex",
            REPOSITORY_INDEX_REQUEST,
            REPOSITORY_INDEX_RESPONSE,
            {"ready": ready_only},
        )["models"]

    def repository_model_load(self, name: str) -> None:
        self._unary(
            "RepositoryModelLoad", REPOSITORY_MODEL_LOAD_REQUEST, EMPTY,
            {"model_name": name},
        )

    def repository_model_unload(self, name: str) -> None:
        self._unary(
            "RepositoryModelUnload", REPOSITORY_MODEL_UNLOAD_REQUEST, EMPTY,
            {"model_name": name},
        )

    def system_shared_memory_register(
        self, name: str, key: str, byte_size: int
    ) -> None:
        self._unary(
            "SystemSharedMemoryRegister", SHM_REGISTER_REQUEST, EMPTY,
            {"name": name, "key": key, "byte_size": byte_size},
        )

    def system_shared_memory_status(self, name: str = "") -> Dict[str, Any]:
        return self._unary(
            "SystemSharedMemoryStatus", SHM_STATUS_REQUEST, SHM_STATUS_RESPONSE,
            {"name": name},
        )["regions"]

    def system_shared_memory_unregister(self, name: str = "") -> None:
        self._unary(
            "SystemSharedMemoryUnregister", SHM_UNREGISTER_REQUEST, EMPTY,
            {"name": name},
        )

    def cuda_shared_memory_register(
        self, name: str, raw_handle: bytes, device_id: int, byte_size: int
    ) -> None:
        """Always refused by this server (UNIMPLEMENTED), as by the JAX
        server; kept for wire completeness."""
        self._unary(
            "CudaSharedMemoryRegister", CUDA_SHM_REGISTER_REQUEST, EMPTY,
            {
                "name": name,
                "raw_handle": raw_handle,
                "device_id": device_id,
                "byte_size": byte_size,
            },
        )

    def cuda_shared_memory_status(self, name: str = "") -> Dict[str, Any]:
        return self._unary(
            "CudaSharedMemoryStatus",
            CUDA_SHM_STATUS_REQUEST,
            CUDA_SHM_STATUS_RESPONSE,
            {"name": name},
        )["regions"]

    def cuda_shared_memory_unregister(self, name: str = "") -> None:
        self._unary(
            "CudaSharedMemoryUnregister", CUDA_SHM_UNREGISTER_REQUEST, EMPTY,
            {"name": name},
        )

    def log_settings(
        self, settings: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """Read (no args) or update the server's dynamic log settings.
        Values are plain Python bool/int/str; the oneof wrapping is
        applied per Triton's SettingValue type rules."""
        req_settings = {}
        for k, v in (settings or {}).items():
            if isinstance(v, bool):
                req_settings[k] = {"bool_param": v}
            elif isinstance(v, int):
                req_settings[k] = {"uint32_param": v}
            else:
                req_settings[k] = {"string_param": str(v)}
        out = self._unary(
            "LogSettings", LOG_SETTINGS_REQUEST, LOG_SETTINGS_RESPONSE,
            {"settings": req_settings},
        )
        flat: Dict[str, Any] = {}
        for k, v in out["settings"].items():
            v = v or {}
            if k in ("log_info", "log_warning", "log_error"):
                flat[k] = bool(v.get("bool_param", False))
            elif k == "log_verbose_level":
                flat[k] = int(v.get("uint32_param", 0))
            else:
                flat[k] = str(v.get("string_param", ""))
        return flat

    def trace_setting(
        self, settings: Optional[Dict[str, List[str]]] = None
    ) -> Dict[str, List[str]]:
        req = {
            "settings": {
                k: {"value": v} for k, v in (settings or {}).items()
            }
        }
        out = self._unary(
            "TraceSetting", TRACE_SETTING_REQUEST, TRACE_SETTING_RESPONSE, req
        )
        return {k: v["value"] for k, v in out["settings"].items()}

    def model_infer_shm(
        self,
        name: str,
        x_nchw: np.ndarray,
        region_name: str,
        input_name: str = "data",
        output_region: Optional[Tuple[str, int]] = None,
        requested_outputs: Optional[List[str]] = None,
    ) -> List[Tuple[str, List[int], Any]]:
        """ModelInfer with the input (and optionally every requested output)
        riding a registered system shared-memory region — Triton's shm
        tensor-reference convention (parameters shared_memory_region /
        _offset / _byte_size on the tensor, no bytes on the wire).

        The caller owns writing x into the region beforehand; this method
        only builds the reference.  With output_region=(name, offset), each
        requested output returns (name, shape, (region, offset, nbytes))
        descriptors instead of arrays."""
        x = np.ascontiguousarray(x_nchw, dtype=np.float32)
        request: Dict[str, Any] = {
            "model_name": name,
            "inputs": [
                {
                    "name": input_name,
                    "datatype": "FP32",
                    "shape": list(x.shape),
                    "parameters": {
                        "shared_memory_region": {"string_param": region_name},
                        "shared_memory_byte_size": {
                            "int64_param": int(x.nbytes)
                        },
                    },
                }
            ],
        }
        if requested_outputs:
            if output_region is not None and len(requested_outputs) != 1:
                # each shm output needs its own offset; Triton clients size
                # them from ModelConfig — keep this wrapper to the 1-output
                # case rather than guess a packing
                raise ValueError(
                    "output_region supports exactly one requested output"
                )
            outs = []
            for n in requested_outputs:
                o: Dict[str, Any] = {"name": n}
                if output_region is not None:
                    rname, base = output_region
                    o["parameters"] = {
                        "shared_memory_region": {"string_param": rname},
                        "shared_memory_offset": {"int64_param": base},
                    }
                outs.append(o)
            request["outputs"] = outs
        resp = self._unary(
            "ModelInfer", MODEL_INFER_REQUEST, MODEL_INFER_RESPONSE, request
        )
        out: List[Tuple[str, List[int], Any]] = []
        raw_iter = iter(resp["raw_output_contents"])
        for meta in resp["outputs"]:
            shape = [int(d) for d in meta["shape"]]
            mp = meta["parameters"] or {}
            region = (mp.get("shared_memory_region") or {}).get(
                "string_param", ""
            )
            if region:
                off = int(
                    (mp.get("shared_memory_offset") or {}).get("int64_param", 0)
                )
                nbytes = int(
                    (mp.get("shared_memory_byte_size") or {}).get(
                        "int64_param", 0
                    )
                )
                out.append((meta["name"], shape, (region, off, nbytes)))
            else:
                arr = np.frombuffer(next(raw_iter), dtype="<f4").reshape(shape)
                out.append((meta["name"], shape, arr))
        return out

    def model_infer(
        self,
        name: str,
        x_nchw: np.ndarray,
        input_name: str = "data",
        requested_outputs: Optional[List[str]] = None,
        use_raw: bool = False,
    ) -> List[Tuple[str, List[int], np.ndarray]]:
        """Run one NCHW f32 tensor; returns [(name, shape, array), ...].

        use_raw=False sends InferTensorContents.fp32_contents — exactly the
        reference pipeline's request shape (face_detection.rs:259-277);
        use_raw=True sends raw_input_contents bytes instead.  Outputs are
        decoded from raw_output_contents (LE f32), the reference's read
        path (face_detection.rs:296: u8_to_f32_vec)."""
        x = np.ascontiguousarray(x_nchw, dtype=np.float32)
        tensor: Dict[str, Any] = {
            "name": input_name,
            "datatype": "FP32",
            "shape": list(x.shape),
        }
        request: Dict[str, Any] = {
            "model_name": name,
            "model_version": "",
            "id": "",
            "inputs": [tensor],
        }
        if requested_outputs:
            request["outputs"] = [{"name": n} for n in requested_outputs]
        if use_raw:
            request["raw_input_contents"] = [x.astype("<f4").tobytes()]
        else:
            tensor["contents"] = {"fp32_contents": x.reshape(-1).tolist()}
        resp = self._unary(
            "ModelInfer", MODEL_INFER_REQUEST, MODEL_INFER_RESPONSE, request
        )
        out = []
        for meta, raw in zip(resp["outputs"], resp["raw_output_contents"]):
            shape = [int(d) for d in meta["shape"]]
            arr = np.frombuffer(raw, dtype="<f4").reshape(shape)
            out.append((meta["name"], shape, arr))
        return out
