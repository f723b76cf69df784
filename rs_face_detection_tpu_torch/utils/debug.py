"""Debug dumps of named intermediates.

A copy of rs_face_detection_tpu/utils/debug.py: ``enable_debug`` makes a
process-wide ``DebugSink`` that saves each dumped intermediate into one run
directory (``.rsfd_debug/<time stamp>`` unless given), numbered in dump
order, arrays as .npy and images as .png (through cv2 where it is
installed, else .npy), and logs each dump at DEBUG level.  ``dump`` and
``dump_image`` are no-ops while no sink is active.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

import numpy as np

logger = logging.getLogger("rs_face_detection_tpu_torch")

_sink_lock = threading.Lock()
_active_sink: Optional["DebugSink"] = None


class DebugSink:
    """Collects named intermediates for one debug session."""

    def __init__(self, directory: Optional[str] = None) -> None:
        self.directory = directory or os.path.join(
            ".rsfd_debug", time.strftime("%Y%m%d-%H%M%S")
        )
        os.makedirs(self.directory, exist_ok=True)
        self._seq = 0
        self._lock = threading.Lock()

    def dump_array(self, name: str, array) -> str:
        arr = np.asarray(array)
        with self._lock:
            path = os.path.join(self.directory, f"{self._seq:03d}_{name}.npy")
            self._seq += 1
        np.save(path, arr)
        logger.debug("debug dump %s: shape=%s dtype=%s -> %s", name, arr.shape, arr.dtype, path)
        return path

    def dump_image(self, name: str, image_bgr) -> str:
        """Save an image intermediate (PNG via cv2 when present, else .npy)."""
        arr = np.asarray(image_bgr)
        try:
            import cv2  # type: ignore

            with self._lock:
                path = os.path.join(self.directory, f"{self._seq:03d}_{name}.png")
                self._seq += 1
            cv2.imwrite(path, np.clip(arr, 0, 255).astype(np.uint8))
            return path
        except Exception:
            return self.dump_array(name, arr)


def enable_debug(directory: Optional[str] = None) -> DebugSink:
    """Activate a process-wide debug sink; returns it."""
    global _active_sink
    with _sink_lock:
        _active_sink = DebugSink(directory)
        return _active_sink


def disable_debug() -> None:
    global _active_sink
    with _sink_lock:
        _active_sink = None


def sink() -> Optional[DebugSink]:
    return _active_sink


def dump(name: str, array) -> None:
    """Dump an intermediate if a debug sink is active (cheap no-op otherwise)."""
    s = _active_sink
    if s is not None:
        s.dump_array(name, array)


def dump_image(name: str, image) -> None:
    s = _active_sink
    if s is not None:
        s.dump_image(name, image)
