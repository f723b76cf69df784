"""Serving runtime of the port: the native JPEG loader, the Triton wire
protocol, the JSON-over-gRPC facade, the KServe-v2 REST endpoint, the
model repository, request batching, shared memory and AOT artifacts.
Counterpart of rs_face_detection_tpu/runtime/ (``python -m
rs_face_detection_tpu_torch.runtime`` runs it, see ``__main__``).

- `native`: the C++ JPEG decode + letterbox loader (ctypes).
- `server` (needs grpcio at ``serve``): the JSON-over-gRPC facade serving
  FacePipeline, DetectionServer and EKYCPipeline.
- `wire` (needs grpcio at ``serve``): the Triton protobuf contract
  (inference.GRPCInferenceService) on the same port as the facade.
- `proto3`: the descriptor-driven proto3 codec the wire speaks.
- `batcher.DynamicBatcher`: Triton-scheduler-style dynamic request batching.
- `shm`: POSIX shared-memory regions for zero-copy localhost ModelInfer
  (Triton's system shared-memory verb family).
- `repository`: Triton-style on-disk model repository (config.pbtxt +
  versioned .npz weights) -> ModelRegistry builders.
- `http`: the KServe-v2 HTTP/REST endpoint (Triton's second client
  surface) over the same wire servicer -- ``serve(http_port=...)``.
- `aot`: torch.export serving artifacts (the compiled-model repository
  analog), the kernels as custom-op nodes.
"""

from . import aot, batcher, native, repository, shm
from .batcher import DynamicBatcher
from .repository import attach_repository_builders, write_repository_entry
from .shm import SharedMemoryRegistry, SharedRegion

__all__ = [
    "native",
    "DynamicBatcher",
    "aot",
    "batcher",
    "repository",
    "shm",
    "SharedMemoryRegistry",
    "SharedRegion",
    "attach_repository_builders",
    "write_repository_entry",
]
