"""What the per-layer metrics of the pipeline's stages read: the program's own
spans and counters of the newest profiler session
(``rs_face_detection_tpu_torch/utils/tracing.py``), which is the traced
sub-window, since tracing is on only while the profiler runs.

Each reader imports the tracing module inside its ``read`` and hands the
snapshot here.  A program without the module, or an empty store, reads
None.  Only whole batches count: the stages of a ``pipeline.extract_batch``
span that the session holds, not those of a batch begun before it.
"""

from __future__ import annotations

from typing import Optional

BATCH = "pipeline.extract_batch"


def _ms(s) -> float:
    return (s.end_ns - s.start_ns) * 1e-6


def stage_ms_per(snap, stage: str, unit: str, device: bool = False) -> Optional[float]:
    """Milliseconds of the ``stage`` spans under ``pipeline.extract_batch``
    spans (their CUDA-event milliseconds with ``device``), over the
    ``unit`` attribute (``images`` or ``faces``) of the batches that have
    such a span."""
    if snap is None:
        return None
    batches = {s.id: s for s in snap.spans if s.name == BATCH}
    total, seen = 0.0, set()
    for s in snap.spans:
        if s.name != stage or s.parent not in batches:
            continue
        ms = s.device_ms if device else _ms(s)
        if ms is None:
            continue
        total += ms
        seen.add(s.parent)
    n = sum(batches[b].attrs.get(unit, 0) for b in seen)
    return total / n if n > 0 else None


def count_per_batch(snap, counter: str) -> Optional[float]:
    """The mean of ``counter`` over the session's ``pipeline.extract_batch``
    spans (each holds the counts of its stages)."""
    if snap is None:
        return None
    batches = [s for s in snap.spans if s.name == BATCH]
    if not batches:
        return None
    return sum(s.counts.get(counter, 0) for s in batches) / len(batches)


def self_ms(snap, name: str, child: str) -> Optional[float]:
    """The mean over ``name`` spans of their milliseconds less those of
    their ``child`` spans."""
    if snap is None:
        return None
    tops = {s.id: _ms(s) for s in snap.spans if s.name == name}
    if not tops:
        return None
    for s in snap.spans:
        if s.name == child and s.parent in tops:
            tops[s.parent] -= _ms(s)
    return sum(tops.values()) / len(tops)
