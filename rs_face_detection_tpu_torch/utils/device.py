"""Device resolution and the host/device boundary of the face-ID path.

Every call of the path that blocks the host on a CUDA stream is made here
and counted here (``tracing.host_sync``): a pageable upload (``to_device``),
a stage's results (``fetch``) and a constant's one upload (``device_arrays``).
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Tuple, Union

import numpy as np
import torch

from . import tracing

DeviceLike = Union[str, torch.device]

#: Uploads ``device_arrays`` keeps (least recently used go first): a few
#: constants per config, one set of resize taps per pair of frame sizes.
CONSTANTS = 256


def resolve_device(device: DeviceLike) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent.

    A pipeline built for the card never carries on silently on the CPU.  A
    bare "cuda" names the current card by its index, so that two spellings
    of one card compare equal.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device` (no copy if there).
    A host array bound for the card is a pageable copy: it blocks the host
    on the stream, and ``tracing.host_sync`` counts it."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.device.type == "cpu":
        tracing.host_sync(device)
    return x.to(device)


@functools.lru_cache(maxsize=CONSTANTS)
def _uploaded(make: Callable, args: tuple, device: torch.device, stream) -> Tuple[torch.Tensor, ...]:
    return tuple(to_device(a, device) for a in make(*args))


def device_arrays(make: Callable, args: tuple, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """``make(*args)``'s arrays on `device`, made and uploaded once per (make,
    args, device, current stream) for callers that only read them: a stream's
    copy is used, and freed when evicted, on that stream alone.  Nothing is
    cached while torch.export or torch.compile traces: a traced tensor is fake."""
    if torch.compiler.is_compiling():
        return tuple(torch.as_tensor(a, device=device) for a in make(*args))
    return _uploaded(make, args, device, torch.cuda.current_stream(device) if device.type == "cuda" else None)


def _values(values: tuple, dtype: torch.dtype) -> Tuple[torch.Tensor]:
    return (torch.tensor(values, dtype=dtype),)


def device_constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A sequence of numbers as a `dtype` tensor on `device`, uploaded once."""
    return device_arrays(_values, (tuple(values), dtype), device)[0]


def fetch(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """Tensors of one device as numpy arrays, exact for every numpy dtype: their
    bytes joined on the device, one blocking copy on the current stream, one
    ``host_sync``."""
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu()
    tracing.host_sync(tensors[0].device)
    parts = host.split([f.numel() for f in flat])
    return tuple(p.clone().view(t.dtype).reshape(t.shape).numpy() for p, t in zip(parts, tensors))


def timed_fetch(name: str, device: torch.device, fn: Callable) -> Tuple[Tuple[np.ndarray, ...], float]:
    """A device stage: ``fn()`` and a ``fetch`` of the tensors it returns, in
    a span ``name`` with CUDA events from the first launch to just before
    the copy; returns the arrays and the seconds between the span's clock reads."""
    start = time.perf_counter_ns()
    with tracing.span(name, start, device) as sp:
        out = fn()
        sp.device_end()
        arrays = fetch(*out)
        end = sp.end(time.perf_counter_ns())
    return arrays, (end - start) * 1e-9
