"""What both drivers share: counter snapshots, warm-up, the result's pieces."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

PARTS = ("detector", "identification")


def registry_snapshot(pipe) -> Dict[str, dict]:
    """The registry's cumulative statistics of the detector and the embedding head."""
    from benchmark.port import model_names

    names = model_names(pipe)
    out = {}
    for part in PARTS:
        s = pipe.registry.statistics(names[part])
        out[part] = {"inferences": s.inference_count, "executions": s.execution_count,
                     "seconds": s.cumulative_duration_s}
    return out


def delta(after: Dict[str, dict], before: Dict[str, dict]) -> Dict[str, dict]:
    return {p: {k: after[p][k] - before[p][k] for k in after[p]} for p in after}


def warm_heads(pipe, faces: int, device) -> None:
    """The heads at every face count from 1 to ``faces``."""
    w, h = pipe.config.alignment.image_size
    for f in range(1, faces + 1):
        pipe.heads(torch.zeros((f, h, w, 3), device=device))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def percentile_ms(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q)) * 1e3
