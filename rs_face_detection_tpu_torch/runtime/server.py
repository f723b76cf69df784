"""gRPC serving facade over the port's pipelines, on the card.

The port's copy of rs_face_detection_tpu/runtime/server.py: the same
JSON-over-gRPC service, verb for verb, so the JAX package's
FacePipelineClient (or this module's copy of it) reaches the port's
pipelines unchanged:

  rsfd.FacePipeline/Extract        <-> FacePipeline.extract (end to end)
  rsfd.FacePipeline/Detect         <-> one detection of one image
  rsfd.FacePipeline/DetectStream   <-> a stream of detections, batched by
                                       DetectionServer.detect_stream
  rsfd.FacePipeline/EkycVerify     <-> EKYCPipeline.verify
  rsfd.FacePipeline/ServerLive, ServerReady, ModelReady, ModelConfig,
      RepositoryIndex, RepositoryModelLoad, RepositoryModelUnload,
      ModelStatistics, ModelInfer, ServerMetadata, ModelMetadata,
      the system and CUDA shared-memory verbs
  rsfd.FacePipeline/TraceSetting   <-> starts/stops a server-side
                                       torch.profiler trace (CPU and CUDA
                                       activities), written as a Chrome
                                       trace into the returned directory

Wire format: request = raw JPEG/PNG bytes (Extract/Detect) or a UTF-8 JSON
body (control verbs); response = UTF-8 JSON.  Embeddings travel as float
lists (JSON carries f32 values exactly).  grpcio's generic handlers and
identity serializers keep this proto-free.  ``serve`` also attaches the
Triton protobuf service (runtime/wire.py) and the gRPC health service on
the same port.

The models run on the registry's device: ``serve(None, None)`` serves
``default_registry()``, on the card; give a ``ModelRegistry("cpu")`` for
the CPU.  Handler threads share the modules and the device's default
stream.
"""

from __future__ import annotations

import base64
import json
import os
import threading
from typing import Optional
from concurrent import futures

import numpy as np
import torch

try:  # pragma: no cover - environment probe
    import grpc  # type: ignore

    _HAS_GRPC = True
except Exception:  # pragma: no cover
    grpc = None
    _HAS_GRPC = False

SERVICE = "rsfd.FacePipeline"


def _identity(x: bytes) -> bytes:
    return x


def _json_bytes(obj) -> bytes:
    return json.dumps(obj).encode("utf-8")


def _req_body(payload: bytes):
    """Parse a JSON-object request body; (body, None) or (None, error bytes).

    Every unary verb keeps the JSON error contract even for hostile bytes —
    a malformed payload must never surface as gRPC UNKNOWN
    ."""
    try:
        body = json.loads(payload or b"{}")
    except Exception as e:
        return None, _json_bytes({"error": f"bad request: not JSON ({e})"})
    if not isinstance(body, dict):
        return None, _json_bytes(
            {"error": "bad request: body must be a JSON object"}
        )
    return body, None


def _req_name(payload: bytes):
    """Parse {"name": str} bodies; (name, None) or (None, error bytes)."""
    body, err = _req_body(payload)
    if err:
        return None, err
    name = body.get("name", "")
    if not isinstance(name, str):
        return None, _json_bytes({"error": "bad request: name must be a string"})
    return name, None


def extract_reply(result) -> dict:
    """A FaceExtractionResult as the Extract verb's JSON object (f32 values
    as Python floats, which JSON carries exactly)."""
    return {
        "face_count": result.face_count,
        "face_quality": None if result.face_quality is None else int(result.face_quality),
        "quality_score": result.quality_score,
        "facial_feature": (
            None if result.facial_feature is None else [float(v) for v in result.facial_feature]
        ),
        "selected_face_box": (
            None if result.selected_face_box is None else [float(v) for v in result.selected_face_box]
        ),
    }


def ekyc_reply(r) -> dict:
    """An EKYCResult as the EkycVerify verb's JSON object."""

    def opt(v, cast):
        return None if v is None else cast(v)

    return {
        "similarity": float(r.similarity),
        "same_person": bool(r.same_person),
        "same_ekyc": bool(r.same_ekyc),
        "card_face_found": bool(r.card_face_found),
        "selfie_face_found": bool(r.selfie_face_found),
        "selfie_mask": opt(r.selfie_mask, bool),
        "selfie_quality": opt(r.selfie_quality, float),
        "selfie_live_crop": opt(r.selfie_live_crop, bool),
        "selfie_live_full": opt(r.selfie_live_full, bool),
        "card_face_box": opt(r.card_face_box, lambda b: np.asarray(b).tolist()),
        "selfie_face_box": opt(r.selfie_face_box, lambda b: np.asarray(b).tolist()),
    }


def _host(out):
    """A module's output (tensors, possibly on the card, in dicts, tuples or
    lists) as numpy arrays in the same structure; bf16 widens to f32."""
    if isinstance(out, dict):
        return {k: _host(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_host(v) for v in out)
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu()
        return (out.float() if out.dtype == torch.bfloat16 else out).numpy()
    return out


class _TraceSession:
    """A torch.profiler session on a thread of its own.

    Kineto's start and stop must run on one thread (a stop from another
    thread crashes the process), while the TraceSetting calls that toggle
    the session arrive on any handler thread.  Ops of every thread are
    recorded (``profile_all_threads``), and CUDA kernels when ``cuda``."""

    def __init__(self, trace_dir: str, cuda: bool) -> None:
        self.dir = trace_dir
        self.error: Optional[Exception] = None
        self._started = threading.Event()
        self._stop = threading.Event()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._thread = threading.Thread(target=self._run, args=(activities,), name="rsfd-trace", daemon=True)
        self._thread.start()
        self._started.wait()
        if self.error is not None:
            raise self.error

    def _run(self, activities) -> None:
        try:
            profiler = torch.profiler.profile(
                activities=activities,
                experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True),
            )
            profiler.start()
        except Exception as e:
            self.error = e
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            profiler.stop()
            profiler.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        except Exception as e:
            self.error = e

    def stop(self) -> None:
        """End the session and write ``trace.json`` into its directory."""
        self._stop.set()
        self._thread.join()
        if self.error is not None:
            raise self.error


class FacePipelineServicer:
    """Method implementations; independent of the gRPC plumbing for testing."""

    def __init__(
        self,
        pipeline,
        registry,
        stream_batch_size: int = 4,
        dynamic_batching: bool = False,
        batch_delay_ms: float = 2.0,
        ekyc_pipeline=None,
    ) -> None:
        self._pipeline = pipeline  # None -> built lazily on first inference
        self._pipeline_lock = threading.Lock()
        self.registry = registry
        self._stream_batch_size = stream_batch_size
        self._stream_server = None
        self._trace: Optional[_TraceSession] = None  # TraceSetting's session
        self._trace_lock = threading.Lock()
        # dynamic_batching: coalesce concurrent unary Detect calls into one
        # device batch (runtime/batcher.py — the Triton scheduler role the
        # reference's model repository configs delegated to the server).
        self._dynamic_batching = dynamic_batching
        self._batch_delay_ms = batch_delay_ms
        self._batcher = None
        self._batcher_lock = threading.Lock()
        self._extract_batcher_obj = None
        self._ekyc = ekyc_pipeline  # None -> built lazily on EkycVerify
        self._ekyc_lock = threading.Lock()
        self._shm = None  # SharedMemoryRegistry, built on first shm verb
        self._shm_lock = threading.Lock()

    def close(self) -> None:
        """Stop the dynamic batchers' workers, the stream server's decode
        threads and an active trace (idempotent)."""
        with self._batcher_lock:
            batchers = [self._batcher, self._extract_batcher_obj]
            self._batcher = self._extract_batcher_obj = None
        for b in batchers:
            if b is not None:
                b.close()
        if self._stream_server is not None:
            self._stream_server.close()
        with self._trace_lock:
            trace, self._trace = self._trace, None
        if trace is not None:
            trace.stop()

    @property
    def pipeline(self):
        """The FacePipeline, built on first inference verb.

        Liveness/metadata verbs must answer before any model is built (a
        Triton server is live before repository models load).  It runs on
        the registry's device.
        """
        if self._pipeline is None:
            with self._pipeline_lock:
                if self._pipeline is None:
                    from ..pipeline.face_pipeline import FacePipeline

                    self._pipeline = FacePipeline(
                        registry=self.registry, device=self.registry.device
                    )
        return self._pipeline

    @property
    def ekyc(self):
        """The EKYCPipeline (SCRFD + face_id + heads), built on first
        EkycVerify — same lazy rationale as `pipeline`."""
        if self._ekyc is None:
            with self._ekyc_lock:
                if self._ekyc is None:
                    from ..pipeline.ekyc_pipeline import EKYCPipeline

                    self._ekyc = EKYCPipeline(
                        registry=self.registry, device=self.registry.device
                    )
        return self._ekyc

    def _detection_server(self):
        """Lazy double-buffered batch server for the streaming RPC."""
        if self._stream_server is None:
            from ..serving.detection_server import DetectionServer

            self._stream_server = DetectionServer(
                detector=self.pipeline.face_detection,
                batch_size=self._stream_batch_size,
            )
        return self._stream_server

    def _extract_batcher(self):
        """Lazy shared DynamicBatcher over FacePipeline.extract_batch.

        The Triton deployment would dynamic-batch EVERY model; here the
        Extract verb coalesces through the pipeline's throughput path
        (2 device passes per batch).  Note extract_batch's documented
        sampling difference: face crops are warped from the letterboxed
        canvas, so very large inputs are sampled at detector resolution.
        A short batch is not padded: the port runs eagerly, so a new batch
        size costs no compile (the JAX copy pads to one static size).
        """
        if self._extract_batcher_obj is None:
            pipeline = self.pipeline  # resolve OUTSIDE the lock (see above)
            with self._batcher_lock:
                if self._extract_batcher_obj is None:
                    from .batcher import DynamicBatcher

                    self._extract_batcher_obj = DynamicBatcher(
                        max_delay_ms=self._batch_delay_ms,
                        batch_fn=pipeline.extract_batch,
                        batch_size=self._stream_batch_size,
                    )
        return self._extract_batcher_obj

    def extract(self, payload: bytes) -> bytes:
        try:
            if self._dynamic_batching:
                # Batcher failures (incl. per-item retry results) keep the
                # JSON error contract, mirroring detect()'s batching branch.
                try:
                    result = self._extract_batcher().submit(payload).result()
                except Exception as e:
                    return _json_bytes({"error": str(e)})
            else:
                result = self.pipeline.extract(payload)
        except Exception as e:  # bad payloads, decode errors, build failures:
            # the JSON error contract, never gRPC UNKNOWN.
            return _json_bytes({"error": str(e)})
        return _json_bytes(extract_reply(result))

    def _dynamic_batcher(self):
        """Lazy shared DynamicBatcher over the stream DetectionServer."""
        if self._batcher is None:
            # Resolve the DetectionServer BEFORE taking the batcher lock:
            # building it may build the lazy pipeline, which takes the
            # (non-reentrant) _pipeline_lock — holding both here would
            # self-deadlock the first Detect call.
            server = self._detection_server()
            with self._batcher_lock:
                if self._batcher is None:
                    from .batcher import DynamicBatcher

                    self._batcher = DynamicBatcher(
                        server, max_delay_ms=self._batch_delay_ms
                    )
        return self._batcher

    def detect(self, payload: bytes) -> bytes:
        from ..utils.image_io import decode_image_bytes

        try:
            image = decode_image_bytes(payload)
        except Exception as e:  # incl. cv2.error on truncated/empty bytes
            return _json_bytes({"error": str(e)})
        try:
            if self._dynamic_batching:
                # Concurrent gRPC handler threads coalesce into one batch.
                boxes, kps = self._dynamic_batcher().detect(image)
            else:
                boxes, kps = self.pipeline.face_detection(image)
        except Exception as e:
            return _json_bytes({"error": str(e)})
        return _json_bytes(
            {
                "boxes": np.asarray(boxes).tolist(),
                "keypoints": np.asarray(kps).tolist(),
            }
        )

    def server_live(self, _: bytes) -> bytes:
        return _json_bytes({"live": self.registry.server_live()})

    def server_ready(self, _: bytes) -> bytes:
        return _json_bytes({"ready": self.registry.server_ready()})

    def model_ready(self, payload: bytes) -> bytes:
        name, err = _req_name(payload)
        if err:
            return err
        return _json_bytes({"name": name, "ready": self.registry.model_ready(name)})

    def repository_index(self, _: bytes) -> bytes:
        return _json_bytes({"models": self.registry.index()})

    def repository_model_load(self, payload: bytes) -> bytes:
        """repository_model_load over the wire."""
        name, err = _req_name(payload)
        if err:
            return err
        try:
            self.registry.load(name)
        except Exception as e:  # unknown name, builder/compile failure, OOM:
            # keep the JSON error contract instead of a raw gRPC UNKNOWN.
            return _json_bytes({"name": name, "loaded": False, "error": str(e)})
        return _json_bytes({"name": name, "loaded": True})

    def repository_model_unload(self, payload: bytes) -> bytes:
        """repository_model_unload over the wire."""
        name, err = _req_name(payload)
        if err:
            return err
        self.registry.unload(name)
        return _json_bytes({"name": name, "loaded": False})

    def model_config(self, payload: bytes) -> bytes:
        """ModelConfig verb: the registered ModelSpec."""
        name, err = _req_name(payload)
        if err:
            return err
        try:
            spec = self.registry.spec(name)
        except KeyError:
            return _json_bytes({"error": f"model {name!r} not loaded"})
        return _json_bytes(
            {
                "name": spec.name,
                "input_shape": list(spec.input_shape),
                "output_spec": spec.output_spec,
                "max_batch_size": spec.max_batch_size,
                "preprocessing": spec.preprocessing,
            }
        )

    def model_infer(self, payload: bytes) -> bytes:
        """Generic ModelInfer verb: run one registered model on a raw input
        tensor.

        Request JSON: {"name": <registry model>, "input": <base64 .npy>,
        optional "kwargs": {...}}.  The input is a (B, H, W, C) batch, as
        ModelMetadata's input shape states (the JAX package's layout); it
        reaches the module as (B, C, H, W).  Response: {"output_names": [...],
        "outputs": [<base64 .npy>, ...]} — one entry per output tensor: a
        tuple-returning model yields positional names ("0", "1", ...), a
        dict-returning one (e.g. the detector's per-stride maps) yields
        "/"-joined leaf paths.  Tensors ride .npy (dtype+shape
        self-describing), matching Triton's typed-tensor contract without
        a proto schema.

        Shared-memory fast path (Triton's shm tensor references): instead of
        "input", pass "input_shm": {"region", "offset", "dtype", "shape"} to
        read the tensor from a registered system shared-memory region; add
        "output_shm": {"region", "offset"} to have outputs written into a
        region — the response then carries {"outputs_shm": [{"name",
        "dtype", "shape", "offset"}, ...]} descriptors and no tensor bytes
        cross the channel.
        """
        import io

        try:
            body = json.loads(payload or b"{}")
            name = body["name"]
            if "input_shm" in body:
                ref = body["input_shm"]
                region = self.shm.get(ref["region"])
                batch = region.read_array(  # copies: client may reuse the region
                    ref["dtype"], tuple(ref["shape"]), int(ref.get("offset", 0))
                )
            else:
                raw = base64.b64decode(body["input"])
                batch = np.load(io.BytesIO(raw), allow_pickle=False)
        except Exception as e:
            return _json_bytes({"error": f"bad ModelInfer request: {e}"})
        try:
            batch = np.asarray(batch)
            if batch.ndim == 4:  # the modules take NCHW
                batch = np.ascontiguousarray(np.transpose(batch, (0, 3, 1, 2)))
            out = self.registry.infer(name, batch, **body.get("kwargs", {}))
            out = _host(out)
        except Exception as e:
            return _json_bytes({"name": name, "error": str(e)})

        def enc(arr) -> str:
            buf = io.BytesIO()
            np.save(buf, np.asarray(arr), allow_pickle=False)
            return base64.b64encode(buf.getvalue()).decode("ascii")

        def leaves(prefix, val, into):
            if isinstance(val, dict):
                for k in sorted(val, key=str):
                    leaves(f"{prefix}{k}/", val[k], into)
            elif isinstance(val, (tuple, list)):
                for i, v in enumerate(val):
                    leaves(f"{prefix}{i}/", v, into)
            else:
                into.append((prefix.rstrip("/") or "0", val))

        try:
            flat: list = []
            leaves("", out, flat)
            if "output_shm" in body:
                from .shm import align_up

                ref = body["output_shm"]
                try:
                    region = self.shm.get(ref["region"])
                    offset = int(ref.get("offset", 0))
                    arrs = [np.asarray(v) for _, v in flat]
                    # Validate the full packing BEFORE any write: an error
                    # must not leave the client's region partially mutated.
                    offsets, cur = [], offset
                    for arr in arrs:
                        offsets.append(cur)
                        cur = align_up(cur + arr.nbytes)
                    end = (offsets[-1] + arrs[-1].nbytes) if arrs else offset
                    if offset < 0 or end > region.byte_size:
                        raise ValueError(
                            f"outputs need [{offset}, {end}) but region "
                            f"{ref['region']!r} has {region.byte_size} bytes"
                        )
                except Exception as e:
                    return _json_bytes({"name": name, "error": f"bad output_shm: {e}"})
                descs = []
                for (n, _), arr, off in zip(flat, arrs, offsets):
                    region.write_array(arr, off)
                    descs.append(
                        {
                            "name": n,
                            "dtype": arr.dtype.name,
                            "shape": list(arr.shape),
                            "offset": off,
                        }
                    )
                return _json_bytes({"name": name, "outputs_shm": descs})
            return _json_bytes(
                {
                    "name": name,
                    "output_names": [n for n, _ in flat],
                    "outputs": [enc(v) for _, v in flat],
                }
            )
        except Exception as e:  # keep the JSON error contract, never UNKNOWN
            return _json_bytes({"name": name, "error": f"unserializable output: {e}"})

    # -- system shared-memory verb family -------------------------------------

    @property
    def shm(self):
        """Server-side shared-memory region table, built on first shm verb."""
        if self._shm is None:
            with self._shm_lock:
                if self._shm is None:
                    from .shm import SharedMemoryRegistry

                    self._shm = SharedMemoryRegistry()
        return self._shm

    def system_shared_memory_register(self, payload: bytes) -> bytes:
        """Attach a client-created POSIX shm segment under a region name.

        Request: {"name", "key", "byte_size"} — `key` is the /dev/shm
        filename the client created (runtime/shm.SharedRegion.create).
        """
        try:
            req = json.loads(payload or b"{}")
            self.shm.register(req["name"], req["key"], int(req["byte_size"]))
        except Exception as e:
            return _json_bytes({"error": str(e)})
        return _json_bytes({"name": req["name"], "registered": True})

    def system_shared_memory_status(self, payload: bytes) -> bytes:
        try:
            req = json.loads(payload or b"{}")
            regions = self.shm.status(req.get("name"))
        except Exception as e:
            return _json_bytes({"error": str(e)})
        return _json_bytes({"regions": regions})

    def system_shared_memory_unregister(self, payload: bytes) -> bytes:
        """Detach a region; empty/absent name unregisters ALL (Triton
        semantics).  The client owns the segment file's lifetime."""
        try:
            req = json.loads(payload or b"{}")
            removed = self.shm.unregister(req.get("name") or None)
        except Exception as e:
            return _json_bytes({"error": str(e)})
        return _json_bytes({"unregistered": removed})

    _CUDA_SHM_ERROR = (
        "CUDA shared memory is not served: this server does not map another "
        "process's cudaIPC handles; use system shared memory "
        "(SystemSharedMemoryRegister) for zero-copy same-host tensors"
    )

    def cuda_shared_memory_register(self, payload: bytes) -> bytes:
        return _json_bytes({"error": self._CUDA_SHM_ERROR})

    def cuda_shared_memory_status(self, payload: bytes) -> bytes:
        return _json_bytes({"regions": {}})  # none can exist

    def cuda_shared_memory_unregister(self, payload: bytes) -> bytes:
        return _json_bytes({"error": self._CUDA_SHM_ERROR})

    def detect_stream(self, payload_iter):
        """Server-streaming detection (ModelStreamInfer analog).

        Consumes a stream of raw image-bytes requests, batches them through
        DetectionServer.detect_stream (host decode overlaps device compute),
        and yields one JSON result per input image, in order.

        Error contract (matches the unary verbs): any mid-stream failure —
        bad payload, cv2 decode error, device-path RuntimeError — is
        reported as a final JSON `{"error": ...}` message and the stream
        terminates; results queued after the failing payload are dropped.
        """
        try:
            server = self._detection_server()
        except Exception as e:  # lazy pipeline build failure
            yield _json_bytes({"error": str(e)})
            return
        try:
            for batch in server.detect_stream(payload_iter):
                for boxes, kps in batch:
                    yield _json_bytes(
                        {
                            "boxes": np.asarray(boxes).tolist(),
                            "keypoints": np.asarray(kps).tolist(),
                        }
                    )
        except Exception as e:  # failure mid-stream: report, end stream
            yield _json_bytes({"error": str(e)})

    def server_metadata(self, _: bytes) -> bytes:
        """ServerMetadata verb: name/version/extensions, and the device the
        models run on (the registry's device type and the card count)."""
        from .. import __version__

        device = self.registry.device
        meta = {
            "name": "rs_face_detection_tpu_torch",
            "version": __version__,
            "extensions": ["model_repository", "statistics", "trace"],
            "backend": device.type,
            "device_count": torch.cuda.device_count() if device.type == "cuda" else 1,
            "dynamic_batching": self._dynamic_batching,
        }
        if self._batcher is not None:
            # Coalescing counters (the Triton batching-statistics analog).
            meta["dynamic_batching_stats"] = self._batcher.stats()
        if self._extract_batcher_obj is not None:
            meta["extract_dynamic_batching_stats"] = (
                self._extract_batcher_obj.stats()
            )
        return _json_bytes(meta)

    def model_metadata(self, payload: bytes) -> bytes:
        """ModelMetadata verb: I/O contract per model.

        Mirrors Triton's ModelMetadataResponse shape (name, versions,
        platform, inputs, outputs) from the registry's ModelSpec.
        """
        name, err = _req_name(payload)
        if err:
            return err
        try:
            spec = self.registry.spec(name)
        except KeyError:
            return _json_bytes({"error": f"model {name!r} not loaded"})
        return _json_bytes(
            {
                "name": spec.name,
                "versions": ["1"],
                "platform": "pytorch_libtorch",
                "inputs": [
                    {
                        "name": "input",
                        "datatype": "UINT8",
                        "shape": [-1, *spec.input_shape],
                    }
                ],
                "outputs": [{"name": "output", "spec": spec.output_spec}],
            }
        )

    def trace_setting(self, payload: bytes) -> bytes:
        """TraceSetting analog: a server-side torch.profiler trace.

        {"action": "start", "dir": optional} begins a trace of the serving
        process (CPU activity of every thread, and CUDA activity when the
        registry is on the card) and returns its directory; {"action":
        "stop"} ends it and writes the Chrome trace ``trace.json`` into that
        directory; {"action": "status"} reports state.
        """
        import tempfile

        req, err = _req_body(payload)
        if err:
            return err
        action = req.get("action", "status")
        if not isinstance(action, str):
            return _json_bytes({"error": "bad request: action must be a string"})
        with self._trace_lock:
            if action == "start":
                if self._trace is not None:
                    return _json_bytes({"error": "trace already active", "dir": self._trace.dir})
                trace_dir = req.get("dir") or tempfile.mkdtemp(prefix="rsfd_trace_")
                try:
                    os.makedirs(trace_dir, exist_ok=True)
                    self._trace = _TraceSession(trace_dir, self.registry.device.type == "cuda")
                except Exception as e:
                    return _json_bytes({"error": str(e)})
                return _json_bytes({"active": True, "dir": trace_dir})
            if action == "stop":
                if self._trace is None:
                    return _json_bytes({"error": "no active trace"})
                trace, self._trace = self._trace, None
                try:
                    trace.stop()
                except Exception as e:
                    return _json_bytes({"error": str(e), "dir": trace.dir})
                return _json_bytes({"active": False, "dir": trace.dir})
            if action == "status":
                trace_dir = None if self._trace is None else self._trace.dir
                return _json_bytes({"active": trace_dir is not None, "dir": trace_dir})
        return _json_bytes({"error": f"unknown action {action!r}"})

    def ekyc_verify(self, payload: bytes) -> bytes:
        """EkycVerify: ID-document vs selfie verification over the wire.

        Request JSON: {"card": <b64 image bytes>, "selfie":
        <b64 image bytes>}.  Response: the EKYCResult fields (JSON error
        contract on failure, like every unary verb).
        """
        try:
            body = json.loads(payload.decode("utf-8"))
            card = base64.b64decode(body["card"])
            selfie = base64.b64decode(body["selfie"])
        except Exception as e:
            return _json_bytes({"error": f"bad EkycVerify request: {e}"})
        try:
            r = self.ekyc.verify(card, selfie)
        except Exception as e:  # keep the JSON error contract, never UNKNOWN
            return _json_bytes({"error": str(e)})
        return _json_bytes(ekyc_reply(r))

    def model_statistics(self, payload: bytes) -> bytes:
        name, err = _req_name(payload)
        if err:
            return err
        try:
            s = self.registry.statistics(name)
            mem = self.registry.memory_usage_bytes(name)
        except KeyError:  # incl. a concurrent unload between the two calls
            return _json_bytes({"error": f"model {name!r} not loaded"})
        return _json_bytes(
            {
                "name": name,
                "inference_count": s.inference_count,
                "execution_count": s.execution_count,
                "cumulative_duration_s": s.cumulative_duration_s,
                # Triton batch_stats analog: executions per batch size.
                "batch_size_counts": {
                    str(k): v for k, v in sorted(s.batch_size_counts.items())
                },
                # Triton memory-usage analog: parameter-buffer bytes.
                "memory_usage_bytes": mem,
            }
        )


def _handlers(servicer: FacePipelineServicer):
    methods = {
        "Extract": servicer.extract,
        "Detect": servicer.detect,
        "ServerLive": servicer.server_live,
        "ServerReady": servicer.server_ready,
        "ModelReady": servicer.model_ready,
        "ModelConfig": servicer.model_config,
        "RepositoryIndex": servicer.repository_index,
        "RepositoryModelLoad": servicer.repository_model_load,
        "RepositoryModelUnload": servicer.repository_model_unload,
        "ModelStatistics": servicer.model_statistics,
        "ModelInfer": servicer.model_infer,
        "ServerMetadata": servicer.server_metadata,
        "ModelMetadata": servicer.model_metadata,
        "TraceSetting": servicer.trace_setting,
        "EkycVerify": servicer.ekyc_verify,
        "SystemSharedMemoryRegister": servicer.system_shared_memory_register,
        "SystemSharedMemoryStatus": servicer.system_shared_memory_status,
        "SystemSharedMemoryUnregister": servicer.system_shared_memory_unregister,
        "CudaSharedMemoryRegister": servicer.cuda_shared_memory_register,
        "CudaSharedMemoryStatus": servicer.cuda_shared_memory_status,
        "CudaSharedMemoryUnregister": servicer.cuda_shared_memory_unregister,
    }
    rpcs = {
        name: grpc.unary_unary_rpc_method_handler(
            lambda req, ctx, fn=fn: fn(req),
            request_deserializer=_identity,
            response_serializer=_identity,
        )
        for name, fn in methods.items()
    }
    rpcs["DetectStream"] = grpc.stream_stream_rpc_method_handler(
        lambda req_iter, ctx: servicer.detect_stream(req_iter),
        request_deserializer=_identity,
        response_serializer=_identity,
    )
    return grpc.method_handlers_generic_handler(SERVICE, rpcs)


def serve(
    pipeline=None,
    registry=None,
    port: int = 8001,
    max_workers: int = 8,
    dynamic_batching: bool = False,
    batch_delay_ms: float = 2.0,
    ekyc_pipeline=None,
    triton_wire: bool = True,
    http_port: Optional[int] = None,
    stream_batch_size: int = 4,
):
    """Start a gRPC server; returns the grpc.Server (caller stops it).

    dynamic_batching: coalesce concurrent unary Detect calls into device
    batches (runtime/batcher.DynamicBatcher) — the Triton-scheduler role.

    triton_wire: additionally serve the genuine Triton protobuf contract
    (inference.GRPCInferenceService — runtime/wire.py) on the same port, so
    a stock Triton client (or the reference crate) can connect; gRPC routes
    the two services by method path.

    registry: the models and their device; None serves
    ``default_registry()``, on the card.

    stream_batch_size: the batch of DetectStream's DetectionServer, which
    is also the dynamic batcher's cap (the JAX copy fixes it at 4).

    http_port: the KServe-v2 HTTP/REST endpoint of the JAX package
    (runtime/http.py) is not ported yet, so any value raises
    NotImplementedError.
    """
    if http_port is not None:
        raise NotImplementedError(
            "serve(http_port=...): the KServe-v2 HTTP/REST endpoint "
            "(runtime/http.py) is not ported yet (ROADMAP.md, M12b)"
        )
    if not _HAS_GRPC:
        raise RuntimeError("grpcio not available")
    if registry is None:
        from ..models.registry import default_registry

        registry = default_registry()
    # pipeline=None stays None: the servicer builds it lazily on the first
    # inference verb so the port opens (and health answers) immediately.

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[
            # One 640x640x3 fp32_contents ModelInfer is ~4.9 MB, over
            # gRPC's 4 MB default: Triton serves with the limits lifted,
            # and so does this server.
            ("grpc.max_receive_message_length", -1),
            ("grpc.max_send_message_length", -1),
        ],
    )
    servicer = FacePipelineServicer(
        pipeline,
        registry,
        stream_batch_size=stream_batch_size,
        dynamic_batching=dynamic_batching,
        batch_delay_ms=batch_delay_ms,
        ekyc_pipeline=ekyc_pipeline,
    )
    server.add_generic_rpc_handlers((_handlers(servicer),))
    wire_servicer = None
    if triton_wire:
        from .wire import TritonWireServicer, health_handlers, wire_handlers

        # facade=servicer: shm regions and the torch.profiler trace session
        # are shared between the JSON and protobuf protocols.
        wire_servicer = TritonWireServicer(registry, facade=servicer)
        server.add_generic_rpc_handlers(
            (wire_handlers(wire_servicer), health_handlers(wire_servicer))
        )
    bound = server.add_insecure_port(f"[::]:{port}")
    server.start()
    server._rsfd_port = bound  # convenience for port=0 callers
    server._rsfd_servicer = servicer
    server._rsfd_wire = wire_servicer
    _grpc_stop = server.stop

    def _stop(grace=None):
        if wire_servicer is not None:
            wire_servicer.close()  # stop dynamic-batcher workers
        servicer.close()
        return _grpc_stop(grace)

    server.stop = _stop
    return server


class FacePipelineClient:
    """Client of the facade (the JAX package's FacePipelineClient, copied)."""

    def __init__(
        self, host: str = "localhost", port: int = 8001,
        timeout_s: Optional[float] = None,
    ) -> None:
        """timeout_s: per-RPC deadline applied to every unary verb: a slow
        or wedged server raises grpc.RpcError(DEADLINE_EXCEEDED) instead of
        blocking the caller forever.  None (default) keeps unbounded calls
        (a first call builds the models and the kernels)."""
        if not _HAS_GRPC:
            raise RuntimeError("grpcio not available")
        self._channel = grpc.insecure_channel(
            f"{host}:{port}",
            options=[
                # large typed tensors / JPEG batches exceed gRPC's 4 MB
                # default; the server runs with the limits lifted too
                ("grpc.max_receive_message_length", -1),
                ("grpc.max_send_message_length", -1),
            ],
        )
        self._timeout_s = timeout_s
        self._shm_names: dict = {}  # SharedRegion.key -> registered name

    def _call(self, method: str, payload: bytes) -> dict:
        rpc = self._channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=_identity,
            response_deserializer=_identity,
        )
        return json.loads(rpc(payload, timeout=self._timeout_s))

    def extract(self, image_bytes: bytes) -> dict:
        return self._call("Extract", image_bytes)

    def detect(self, image_bytes: bytes) -> dict:
        return self._call("Detect", image_bytes)

    def server_live(self) -> bool:
        return self._call("ServerLive", b"")["live"]

    def server_ready(self) -> bool:
        return self._call("ServerReady", b"")["ready"]

    def model_ready(self, name: str) -> bool:
        return self._call("ModelReady", _json_bytes({"name": name}))["ready"]

    def model_config(self, name: str) -> dict:
        return self._call("ModelConfig", _json_bytes({"name": name}))

    def repository_index(self) -> list:
        return self._call("RepositoryIndex", b"")["models"]

    def repository_model_load(self, name: str) -> dict:
        return self._call("RepositoryModelLoad", _json_bytes({"name": name}))

    def repository_model_unload(self, name: str) -> dict:
        return self._call("RepositoryModelUnload", _json_bytes({"name": name}))

    def detect_stream(self, image_bytes_iter):
        """Bidirectional-stream Detect: yields one result dict per image."""
        rpc = self._channel.stream_stream(
            f"/{SERVICE}/DetectStream",
            request_serializer=_identity,
            response_deserializer=_identity,
        )
        for chunk in rpc(iter(image_bytes_iter)):
            yield json.loads(chunk)

    def model_statistics(self, name: str) -> dict:
        return self._call("ModelStatistics", _json_bytes({"name": name}))

    def model_infer(self, name: str, batch, **kwargs) -> "np.ndarray":
        """Generic typed-tensor inference on a registered model.

        Sends the array as base64 .npy; returns the first output decoded
        (use model_infer_multi for tuple-returning models).
        """
        outs = self.model_infer_multi(name, batch, **kwargs)
        return outs[0]

    def model_infer_multi(self, name: str, batch, **kwargs):
        import io

        buf = io.BytesIO()
        np.save(buf, np.asarray(batch), allow_pickle=False)
        body = {
            "name": name,
            "input": base64.b64encode(buf.getvalue()).decode("ascii"),
        }
        if kwargs:
            body["kwargs"] = kwargs
        res = self._call("ModelInfer", _json_bytes(body))
        if "error" in res:
            raise RuntimeError(res["error"])
        return [
            np.load(io.BytesIO(base64.b64decode(o)), allow_pickle=False)
            for o in res["outputs"]
        ]

    def system_shared_memory_register(self, name: str, key: str, byte_size: int) -> dict:
        return self._call(
            "SystemSharedMemoryRegister",
            _json_bytes({"name": name, "key": key, "byte_size": byte_size}),
        )

    def system_shared_memory_status(self, name: str = None) -> dict:
        body = {"name": name} if name else {}
        return self._call("SystemSharedMemoryStatus", _json_bytes(body))

    def system_shared_memory_unregister(self, name: str = None) -> dict:
        body = {"name": name} if name else {}
        res = self._call("SystemSharedMemoryUnregister", _json_bytes(body))
        gone = set(res.get("unregistered", []))
        self._shm_names = {
            k: n for k, n in self._shm_names.items() if n not in gone
        }
        return res

    def cuda_shared_memory_register(self, name: str, key: str = "", byte_size: int = 0) -> dict:
        return self._call(
            "CudaSharedMemoryRegister",
            _json_bytes({"name": name, "key": key, "byte_size": byte_size}),
        )

    def cuda_shared_memory_status(self) -> dict:
        return self._call("CudaSharedMemoryStatus", b"")

    def cuda_shared_memory_unregister(self, name: str = None) -> dict:
        return self._call(
            "CudaSharedMemoryUnregister", _json_bytes({"name": name} if name else {})
        )

    def register_region(self, name: str, region) -> dict:
        """Register a runtime.shm.SharedRegion this process created, and
        remember its server-side name for model_infer_shm."""
        res = self.system_shared_memory_register(name, region.key, region.byte_size)
        if "error" in res:
            raise RuntimeError(res["error"])
        self._shm_names[region.key] = name
        return res

    def model_infer_shm(self, name: str, batch, region, output_offset: int = None,
                        **kwargs):
        """Zero-copy ModelInfer through a registered shared-memory region.

        Writes `batch` into `region` (a runtime.shm.SharedRegion previously
        passed to register_region), references it by (region, offset, dtype,
        shape), and asks for outputs in the same region starting at
        `output_offset` (default: 64B-aligned past the input).  Returns the
        output arrays as COPIES out of the region (so the region can be
        reused immediately); tensor bytes never cross the gRPC channel.
        """
        from .shm import align_up

        try:
            region_name = self._shm_names[region.key]
        except KeyError:
            raise RuntimeError(
                "region not registered through this client; call "
                "register_region(name, region) first"
            ) from None
        arr = np.ascontiguousarray(np.asarray(batch))
        region.write_array(arr, 0)
        if output_offset is None:
            output_offset = align_up(arr.nbytes)
        body = {
            "name": name,
            "input_shm": {
                "region": region_name,
                "offset": 0,
                "dtype": arr.dtype.name,
                "shape": list(arr.shape),
            },
            "output_shm": {"region": region_name, "offset": int(output_offset)},
        }
        if kwargs:
            body["kwargs"] = kwargs
        res = self._call("ModelInfer", _json_bytes(body))
        if "error" in res:
            raise RuntimeError(res["error"])
        return [
            region.read_array(d["dtype"], tuple(d["shape"]), d["offset"])
            for d in res["outputs_shm"]
        ]

    def ekyc_verify(self, card_bytes: bytes, selfie_bytes: bytes) -> dict:
        """ID-document vs selfie verification (the eKYC pipeline's verify)."""
        return self._call(
            "EkycVerify",
            _json_bytes(
                {
                    "card": base64.b64encode(card_bytes).decode("ascii"),
                    "selfie": base64.b64encode(selfie_bytes).decode("ascii"),
                }
            ),
        )

    def server_metadata(self) -> dict:
        return self._call("ServerMetadata", b"")

    def model_metadata(self, name: str) -> dict:
        return self._call("ModelMetadata", _json_bytes({"name": name}))

    def trace_setting(self, action: str = "status", trace_dir: str = None) -> dict:
        body = {"action": action}
        if trace_dir:
            body["dir"] = trace_dir
        return self._call("TraceSetting", _json_bytes(body))

    def close(self) -> None:
        self._channel.close()
