"""Host utilities: image byte decode, coordinates, debug dumps, devices, tracing.

Counterpart of rs_face_detection_tpu/utils/, without ``instance_cache``
(the port runs eagerly and keeps no compiled executables).  In place of
the ``profiling`` helpers, ``tracing`` puts the face-ID path's stage spans
into torch.profiler's traces (a benchmark's traced window, a TraceSetting
session): each stage as a ``user_annotation`` event, with device times by
CUDA events and a count of host syncs, kept for ``tracing.read()``.
"""

from .coordinate import Coord2D, Coord3D, image_to_rgb_array
from .debug import DebugSink, disable_debug, dump, dump_image, enable_debug
from .image_io import decode_image_bytes, named_landmarks_to_array

__all__ = [
    "Coord2D",
    "Coord3D",
    "image_to_rgb_array",
    "DebugSink",
    "disable_debug",
    "dump",
    "dump_image",
    "enable_debug",
    "decode_image_bytes",
    "named_landmarks_to_array",
]
