"""Bulk extraction: ``FacePipeline.extract_batch`` in-process, closed loop.

One batch of ``batch`` distinct pooled JPEGs in flight; the next is sent
when the last returns (its results are on the host by then), until the
window's seconds have passed.  ``extract_img_per_s`` is every image
completed over the whole window, the last batch's time included.
"""

from __future__ import annotations

import time

from benchmark import schedule
from benchmark.drivers import common


def run(env: dict) -> dict:
    from rs_face_detection_tpu_torch.runtime.server import extract_reply

    pipe, pool, mix, device = env["pipe"], env["pool"], env["mix"], env["device"]
    seconds, batch = env["seconds"], mix["batch"]
    plan = schedule.batches(len(pool), batch, int(seconds * mix["max_img_per_s"] / batch) + 4, env["seed"])
    for b in plan[:2]:  # the detector at this batch, then the heads at every face count
        pipe.extract_batch([pool[i] for i in b])
    common.warm_heads(pipe, batch, device)
    common.sync(device)
    before = common.registry_snapshot(pipe)
    common.reset_peak(device)
    prof = None
    if env["trace"]:
        from benchmark.trace import Profiled

        prof = Profiled(env["work_dir"])
    start = time.perf_counter()
    env["log"](f"setup {start - env['t0']:.3f} s; window of {seconds} s starts")
    span, done, k, counted = 0.0, [], 0, None
    while True:
        now = time.perf_counter()
        if now - start >= seconds:
            break
        if prof is not None and prof.prof is None and now - start >= seconds - mix["trace_seconds"]:
            # the counters are read over the untraced part of the window
            counted = (now - start, len(done), span, common.registry_snapshot(pipe))
            prof.start()
        if k >= len(plan):
            raise RuntimeError("the batch plan ran out: raise max_img_per_s")
        t = time.perf_counter()
        results = pipe.extract_batch([pool[i] for i in plan[k]])
        span += time.perf_counter() - t
        done += [(int(i), r) for i, r in zip(plan[k], results)]
        k += 1
    if prof is not None and prof.prof is not None:
        prof.stop()
    common.sync(device)
    window = time.perf_counter() - start
    memory = common.peak(device)
    reg = common.delta(common.registry_snapshot(pipe), before)
    faces = sum(1 for _, r in done if r.facial_feature is not None)
    ctx = {"window_s": window, "images": len(done), "faces": reg["identification"]["inferences"],
           "registry": reg, "span_s": span, "trace": None}
    if counted is not None:
        part = common.delta(counted[3], before)
        ctx = {"window_s": counted[0], "images": counted[1], "faces": part["identification"]["inferences"],
               "registry": part, "span_s": counted[2], "trace": prof.summary()}
    env["log"](f"window {window:.3f} s: {k} batches, {len(done)} images, {faces} faces selected, "
               f"{reg['detector']['inferences']} detected")
    return {
        "end_to_end": {"setup_s": start - env["t0"], "extract_img_per_s": len(done) / window,
                       "peak_mem_gib": memory / 2**30},
        "memory_peak_bytes": memory, "attempted": len(done), "failed": 0,
        "answers": [{"image": i, "answer": r} for i, r in done], "to_answer": extract_reply,
        "ctx": ctx,
        "details": {"batches": k, "faces_selected": faces},
    }
