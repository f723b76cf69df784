"""The traced sub-window: torch.profiler over the window's last seconds, and its reading.

The profiler records CPU ops of every thread and the device's kernels,
copies and sets (CUPTI).  Its Chrome trace is read once and deleted: the
device's busy time is the union of the device events' intervals, the idle
gaps lie between them, each gap labelled by the CPU op that covers most of
it (the innermost on a tie), and kernel time is summed by name.

While the profiler runs, ``Recorder`` keeps the inputs of the port's kernel
launches (K1's valid and keep masks, K2's frame shapes) by wrapping the
kernel wrappers' module functions, so that the counts in benchmark/counts/
are of what these inputs need.  Outside the traced sub-window nothing is
wrapped.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Recorder:
    """Records the calls of ``module.attr`` (a kernel wrapper) while on."""

    def __init__(self, module_name: str, attr: str, keep) -> None:
        self.calls: List = []
        self.on = False
        try:
            import importlib

            self.module = importlib.import_module(module_name)
            self.original = getattr(self.module, attr)
        except (ImportError, AttributeError):
            self.module = None
            return
        self.attr = attr

        def wrapped(*args, **kwargs):
            out = self.original(*args, **kwargs)
            if self.on:
                self.calls.append(keep(args, out))
            return out

        setattr(self.module, attr, wrapped)

    def restore(self) -> None:
        if self.module is not None:
            setattr(self.module, self.attr, self.original)


class Profiled:
    """A profiler session opened and closed on the calling thread."""

    def __init__(self, work_dir: str) -> None:
        self.path = os.path.join(work_dir, "trace.json")
        self.recorders = {
            "k1": Recorder("rs_face_detection_tpu_torch.kernels.nms", "nms_mask_cuda",
                           lambda a, out: (tuple(a[0].shape), a[1].detach(), out.detach())),
            "k2": Recorder("rs_face_detection_tpu_torch.kernels.stem", "fused_stem_cuda",
                           lambda a, out: (tuple(a[0].shape), tuple(out.shape))),
        }
        self.prof = None

    def start(self) -> None:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities, experimental_config=config)
        self.prof.start()
        for r in self.recorders.values():
            r.on = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        for r in self.recorders.values():
            r.on = False
            r.restore()
        self.prof.stop()

    def summary(self) -> dict:
        """The reading of the stopped session: written, read and deleted
        after the measured window, so that it costs the window nothing."""
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        summary = summarize(events, self.window_s)
        summary["launches"] = {k: r.calls for k, r in self.recorders.items()}
        return summary


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def summarize(events: List[dict], window_s: float, top: int = 10) -> dict:
    """busy_s, window_s, kernel seconds by name, the device ops and the idle
    gaps that took most time."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    spans = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev])
    busy_us = sum(b - a for a, b in spans)
    by_name: Dict[str, float] = {}
    count: Dict[str, int] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0)) * 1e-6
        count[e["name"]] = count.get(e["name"], 0) + 1
    gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1], spans[i + 1][0]) for i in range(len(spans) - 1)),
                  reverse=True)[:top]
    labelled = []
    for length, a, b in gaps:
        best: Optional[tuple] = None
        for e in ops:
            s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            cover = min(b, t) - max(a, s)
            if cover > 0 and (best is None or (cover, -(t - s)) > best[:2]):
                best = (cover, -(t - s), e["name"])
        name = best[2] if best is not None and best[0] >= 0.1 * length else "host: no torch op"
        labelled.append([name, length * 1e-6])
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_us * 1e-6, "window_s": window_s, "kernels": by_name, "counts": count,
            "device_ops": [[k, v] for k, v in device_ops], "idle_gaps": labelled}


def kernel_seconds(summary: dict, function: str) -> (float, int):
    """Device seconds and launches of the kernels named ``function`` (the
    trace's names carry namespaces and parameter lists)."""
    names = [k for k in summary["kernels"] if re.search(rf"(^|::|\s){re.escape(function)}\(", k)]
    return sum(summary["kernels"][k] for k in names), sum(summary["counts"][k] for k in names)
