"""System shared-memory regions for zero-copy localhost inference.

The port's copy of rs_face_detection_tpu/runtime/shm.py: Triton's system
shared-memory verb family (SystemSharedMemoryRegister/Status/Unregister,
grpc_service.proto).  The shm path exists for same-host clients: skip the
serialize/copy of tensor bytes over the socket entirely.

A client creates a POSIX shared-memory segment (a plain file under
/dev/shm), registers it with the server by (name, key, byte_size), and
ModelInfer requests/responses then reference tensors as (region, offset,
dtype, shape) -- the bytes never cross the gRPC channel; both processes map
the same physical pages.  The segment format is the JAX package's, so a
region either package writes is read by the other.

CUDA shared memory (cuda_shared_memory_* RPCs, cudaIPC handles into device
memory) is refused by the wire as the JAX server refuses it; tensors reach
the card through host memory.

Trust boundary (same as Triton's shm path): the registering client is a
same-host, same-user process.  Segments are created 0600 so only the owning
user can open or resize them; the server refuses symlinked keys
(O_NOFOLLOW) and re-checks the real size at registration.  A cooperating
client that ftruncates a segment AFTER registering it can still SIGBUS the
server on access -- inherent to POSIX shared memory; don't register shm from
processes you wouldn't run in-process.
"""

from __future__ import annotations

import math
import mmap
import os
import threading
from typing import Dict, Optional

import numpy as np

DEFAULT_SHM_DIR = "/dev/shm"

#: Output tensors are packed into regions at this alignment (server) and the
#: default output_offset is computed with it (client) — keep the two in sync.
ALIGN = 64


def align_up(n: int, align: int = ALIGN) -> int:
    return -(-int(n) // align) * align


def _segment_path(key: str, shm_dir: str = DEFAULT_SHM_DIR) -> str:
    # shm_open()-style keys: flat namespace, no path traversal.
    if not key or "/" in key or key.startswith("."):
        raise ValueError(f"bad shared-memory key {key!r}")
    return os.path.join(shm_dir, key)


class SharedRegion:
    """One mapped shared-memory segment (client- or server-side).

    Client side: ``SharedRegion.create(key, byte_size)`` makes the segment
    (and owns unlinking it).  Server side: ``SharedRegion.attach(key,
    byte_size)`` maps an existing one.
    """

    def __init__(self, key: str, byte_size: int, fd: int, owner: bool,
                 shm_dir: str = DEFAULT_SHM_DIR):
        self.key = key
        self.byte_size = int(byte_size)
        self._owner = owner
        self._shm_dir = shm_dir
        try:
            self._mmap: Optional[mmap.mmap] = mmap.mmap(fd, self.byte_size)
        finally:
            os.close(fd)

    @classmethod
    def create(cls, key: str, byte_size: int,
               shm_dir: str = DEFAULT_SHM_DIR) -> "SharedRegion":
        if byte_size <= 0:
            raise ValueError("byte_size must be positive")
        path = _segment_path(key, shm_dir)
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, byte_size)
        except BaseException:
            os.close(fd)
            os.unlink(path)
            raise
        return cls(key, byte_size, fd, owner=True, shm_dir=shm_dir)

    @classmethod
    def attach(cls, key: str, byte_size: int,
               shm_dir: str = DEFAULT_SHM_DIR) -> "SharedRegion":
        path = _segment_path(key, shm_dir)
        # O_NOFOLLOW: /dev/shm is world-writable+sticky, so a hostile local
        # user could plant a symlink under a guessable key; glibc shm_open
        # refuses symlinks for the same reason.  Size-check the fd we
        # actually opened (fstat), not the path.
        try:
            fd = os.open(path, os.O_RDWR | os.O_NOFOLLOW)
        except OSError as e:
            import errno

            if e.errno == errno.ELOOP:
                raise ValueError(f"segment key {key!r} is a symlink; refusing") from None
            raise
        try:
            import stat as stat_mod

            st = os.fstat(fd)
            if not stat_mod.S_ISREG(st.st_mode):
                raise ValueError(f"segment {key!r} is not a regular file")
            if byte_size > st.st_size:
                raise ValueError(
                    f"segment {key!r} is {st.st_size} bytes, "
                    f"registration claims {byte_size}"
                )
        except BaseException:
            os.close(fd)
            raise
        return cls(key, byte_size, fd, owner=False, shm_dir=shm_dir)

    # -- typed tensor IO ----------------------------------------------------
    def _span(self, offset: int, nbytes: int) -> memoryview:
        if nbytes < 0 or offset < 0 or offset + nbytes > self.byte_size:
            raise ValueError(
                f"range [{offset}, {offset + nbytes}) outside region "
                f"{self.key!r} of {self.byte_size} bytes"
            )
        return memoryview(self._mmap)[offset : offset + nbytes]

    def write_array(self, arr: np.ndarray, offset: int = 0) -> int:
        """Copy `arr` into the region; returns the byte length written."""
        arr = np.ascontiguousarray(arr)
        span = self._span(offset, arr.nbytes)
        # One memcpy into the shared pages, no intermediate bytes object.
        # Byte-view via numpy (not memoryview.cast) so extension dtypes the
        # buffer protocol rejects — bfloat16 and friends — work too.
        np.frombuffer(span, dtype=np.uint8)[:] = arr.reshape(-1).view(np.uint8)
        return arr.nbytes

    def read_array(self, dtype, shape, offset: int = 0, copy: bool = True) -> np.ndarray:
        """Read the region as (dtype, shape) at offset.

        copy=True (default) returns an owned array — safe across close().
        copy=False returns a zero-copy view over the shared pages; the view
        pins the mapping (close() would raise BufferError until it dies).
        """
        dt = np.dtype(dtype)
        dims = [int(d) for d in (shape if shape else ())]
        if any(d < 0 for d in dims):
            raise ValueError(f"negative dimension in shape {tuple(shape)}")
        nbytes = dt.itemsize * math.prod(dims)  # exact int math, no overflow
        span = self._span(offset, nbytes)
        arr = np.frombuffer(span, dtype=dt).reshape(shape)
        if copy:
            arr = arr.copy()
            span.release()
        return arr

    def close(self, unlink: Optional[bool] = None) -> None:
        if self._mmap is not None:
            self._mmap.close()
            self._mmap = None
        if unlink if unlink is not None else self._owner:
            try:
                os.unlink(_segment_path(self.key, self._shm_dir))
            except FileNotFoundError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SharedMemoryRegistry:
    """Server-side name -> attached region table (Triton's shm status)."""

    def __init__(self, shm_dir: str = DEFAULT_SHM_DIR):
        self._shm_dir = shm_dir
        self._regions: Dict[str, SharedRegion] = {}
        self._lock = threading.Lock()

    def register(self, name: str, key: str, byte_size: int) -> None:
        region = SharedRegion.attach(key, byte_size, self._shm_dir)
        with self._lock:
            if name in self._regions:
                region.close()
                raise ValueError(f"shared-memory region {name!r} already registered")
            self._regions[name] = region

    def status(self, name: Optional[str] = None) -> dict:
        with self._lock:
            if name is not None:
                if name not in self._regions:
                    raise KeyError(f"shared-memory region {name!r} not registered")
                items = {name: self._regions[name]}
            else:
                items = dict(self._regions)
        return {
            n: {"key": r.key, "byte_size": r.byte_size} for n, r in items.items()
        }

    def unregister(self, name: Optional[str] = None) -> list:
        """Unregister one region, or ALL when name is None (Triton semantics:
        an empty name unregisters everything)."""
        with self._lock:
            if name is None:
                victims = list(self._regions)
            else:
                if name not in self._regions:
                    raise KeyError(f"shared-memory region {name!r} not registered")
                victims = [name]
            popped = [self._regions.pop(n) for n in victims]
        for region in popped:
            try:
                region.close(unlink=False)
            except BufferError:
                # A concurrent ModelInfer still holds a view over the pages.
                # Drop our reference instead: the mapping closes when the
                # in-flight view dies and the mmap object is collected.
                pass
        return victims

    def get(self, name: str) -> SharedRegion:
        with self._lock:
            try:
                return self._regions[name]
            except KeyError:
                raise KeyError(f"shared-memory region {name!r} not registered") from None

    def close(self) -> None:
        self.unregister(None)
