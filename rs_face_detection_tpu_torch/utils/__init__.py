"""Host utilities: image byte decode, coordinates, debug dumps, devices.

Counterpart of rs_face_detection_tpu/utils/, without ``instance_cache``
(the port runs eagerly and keeps no compiled executables) and the
``profiling`` helpers (torch.profiler serves, see profile_ekyc.py).
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
