"""Serving runtime of the port: the native JPEG loader, the Triton wire
protocol, the JSON-over-gRPC facade, the model repository, request batching
and shared memory.  Counterpart of rs_face_detection_tpu/runtime/ (its
``aot`` and ``http`` are not ported yet).

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
"""

from . import batcher, native, repository, shm
from .batcher import DynamicBatcher
from .repository import attach_repository_builders, write_repository_entry
from .shm import SharedMemoryRegistry, SharedRegion

__all__ = [
    "native",
    "DynamicBatcher",
    "batcher",
    "repository",
    "shm",
    "SharedMemoryRegistry",
    "SharedRegion",
    "attach_repository_builders",
    "write_repository_entry",
]
