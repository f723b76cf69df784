"""Served extraction: the runtime's gRPC facade, open loop, from another process.

The port's ``runtime/server.py::serve`` on localhost (an ephemeral port)
with dynamic batching, so the Extract verb coalesces requests into
``FacePipeline.extract_batch`` calls of at most the configuration's batch.
The load generator (benchmark/loadgen.py) is a separate process started
with ``subprocess``; it sends each request at its due time and times it
from then to its reply.  ``extract_req_per_s`` is the requests answered
over the whole window, from its start to the last reply; above the knee
the queue grows all through it, so the tails are per-layer readings.
Counters are read over the window: the registry's
statistics in-process, the batcher's through the ServerMetadata verb.  A
traced run profiles the window's last ``trace_seconds`` and reads the
counters over the part before it.
"""

from __future__ import annotations

import json
import struct
import subprocess
import sys
import threading
import time

import numpy as np

from benchmark import schedule
from benchmark.check import parse_reply
from benchmark.drivers import common


def batcher_stats(channel) -> dict:
    rpc = channel.unary_unary("/rsfd.FacePipeline/ServerMetadata")
    s = json.loads(rpc(b"{}", timeout=30))["extract_dynamic_batching_stats"]
    return {"requests": s["requests"], "batches": s["batches"], "queue_s": s["cumulative_queue_s"],
            "compute_s": s["cumulative_compute_s"]}


def warm_in_process(pipe, pool, items, batch: int, device) -> None:
    """extract_batch at every batch size up to ``batch``, each resolution of
    the pool at each size."""
    by_size = {}
    for i, it in enumerate(items):
        by_size.setdefault(it["size"], []).append(i)
    for idx in by_size.values():
        for b in range(1, batch + 1):
            pipe.extract_batch([pool[idx[j % len(idx)]] for j in range(b)])
    common.warm_heads(pipe, batch, device)
    common.sync(device)


def run(env: dict) -> dict:
    import grpc

    from rs_face_detection_tpu_torch.runtime.server import serve

    pipe, pool, mix, device, log = env["pipe"], env["pool"], env["mix"], env["device"], env["log"]
    seconds, serving = env["seconds"], env["cfg"]["serving"]
    rate = float(mix["rate_per_s"])
    due, image = schedule.open_loop(rate, seconds, len(pool), env["seed"])
    sample = schedule.sample(len(due), mix["check_sample"], env["seed"])
    batch = serving["stream_batch_size"]
    warm_in_process(pipe, pool, env["items"], batch, device)

    server = serve(pipeline=pipe, registry=env["registry"], dynamic_batching=True, stream_batch_size=batch,
                   batch_delay_ms=serving["batch_delay_ms"], max_workers=serving["max_workers"], port=0)
    channel = grpc.insecure_channel(f"localhost:{server._rsfd_port}")
    proc = subprocess.Popen([sys.executable, "-m", "benchmark.loadgen"], cwd=env["root"], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    errors = []
    pump = threading.Thread(target=lambda: errors.append(proc.stderr.read()), daemon=True)
    pump.start()
    try:
        header = {"port": server._rsfd_port, "pool_size": len(pool), "due": due.tolist(),
                  "image": image.tolist(), "sample": sample.tolist(), "warmup": mix["warmup_bursts"],
                  "drain_s": mix["drain_s"], "timeout_s": mix["timeout_s"]}
        proc.stdin.write((json.dumps(header) + "\n").encode())
        for blob in pool:
            proc.stdin.write(struct.pack(">I", len(blob)) + blob)
        proc.stdin.flush()
        line = proc.stdout.readline()
        if line.strip() != b"READY":
            raise RuntimeError(f"load generator did not start: {line!r}")
        common.sync(device)
        before, b_before = common.registry_snapshot(pipe), batcher_stats(channel)
        common.reset_peak(device)
        start = time.perf_counter()
        log(f"setup {start - env['t0']:.3f} s; window of {seconds} s at {rate} req/s ({len(due)} requests) starts")
        proc.stdin.write(b"GO\n")
        proc.stdin.flush()
        prof = counted = None
        if env["trace"]:
            from benchmark.trace import Profiled

            prof = Profiled(env["work_dir"])
            time.sleep(max(0.0, start + seconds - mix["trace_seconds"] - time.perf_counter()))
            # the counters are read over the untraced part of the window
            counted = (time.perf_counter() - start, common.registry_snapshot(pipe), batcher_stats(channel))
            prof.start()
            time.sleep(mix["trace_seconds"])
            prof.stop()
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError("load generator ended without a result")
        got = json.loads(line)
        common.sync(device)
        memory = common.peak(device)
        reg_after, b_after = common.registry_snapshot(pipe), batcher_stats(channel)
    finally:
        channel.close()
        server.stop(0)
        try:
            proc.stdin.close()
        except OSError:
            pass
        proc.wait(timeout=60)
        pump.join(timeout=10)
    if proc.returncode != 0:
        raise RuntimeError(f"load generator exited {proc.returncode}: {b''.join(errors)[-2000:]!r}")
    span_s = got["window_s"]
    if counted is not None:
        span_s, reg_after, b_after = counted
    reg = common.delta(reg_after, before)
    batcher = {k: b_after[k] - b_before[k] for k in b_after}
    n, failed = len(due), got["failed"]
    worst = mix["drain_s"] + seconds
    latency = [worst if v is None else v for v in got["latency"]]
    lag = np.asarray(got["lag"])
    log(f"load generator: {n} requests, {len(failed)} failed; sent late by p50 {np.median(lag) * 1e3:.3f} ms, "
        f"p99 {np.percentile(lag, 99) * 1e3:.3f} ms, max {lag.max() * 1e3:.3f} ms; sending took "
        f"{got['send_s']:.3f} s, the last reply came {got['window_s']:.3f} s after the start; latency p50 "
        f"{common.percentile_ms(latency, 50):.3f} ms, p95 {common.percentile_ms(latency, 95):.3f} ms")
    log(f"batcher over the window: {batcher}; registry: {reg}")
    answers = [{"image": int(image[i]), "answer": None} for i in range(n)]
    for i, body in got["replies"].items():
        answers[int(i)]["answer"] = parse_reply(body)
    return {
        "end_to_end": {"setup_s": start - env["t0"], "extract_req_per_s": (n - len(failed)) / got["window_s"],
                       "peak_mem_gib": memory / 2**30},
        "memory_peak_bytes": memory, "attempted": n, "failed": len(failed),
        "answers": answers,
        "ctx": {"window_s": span_s, "images": reg["detector"]["inferences"],
                "faces": reg["identification"]["inferences"], "registry": reg, "batcher": batcher,
                "compute_s": batcher["compute_s"], "latency_p95_ms": common.percentile_ms(latency, 95),
                "trace": prof.summary() if prof is not None else None},
        "details": {"rate_per_s": rate, "lag_p50_s": float(np.median(lag)), "lag_p99_s": float(np.percentile(lag, 99)),
                    "lag_max_s": float(lag.max()), "send_s": got["send_s"], "last_reply_s": got["window_s"],
                    "batcher": batcher},
    }
