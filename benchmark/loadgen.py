"""The open-loop load generator of the served cells, run as its own process.

``python3 -m benchmark.loadgen`` reads from standard input one JSON header
line ({"port", "due" (s), "image" (pool index per request), "sample"
(request indices whose replies come back), "warmup" (burst sizes),
"drain_s", "timeout_s"}), then the pool as 4-byte big-endian lengths and
JPEG bytes.  It connects to the gRPC facade on localhost, sends the warm-up
bursts (each waits for its replies), writes ``READY``, and waits for a
``GO`` line: the window's start.  It then sends request i as an
asynchronous unary Extract call at ``start + due[i]``, times it from that
due time to its reply, and after the last send waits up to ``drain_s`` for
the replies still out.  A reply that is a JSON ``error``, an RPC error or no
reply by then is failed.  Its one line of output is a JSON object: per
request the send lag and the latency (null when failed), the failures, and
the sampled replies.  It imports neither torch nor the program.
"""

from __future__ import annotations

import json
import struct
import sys
import threading
import time

METHOD = "/rsfd.FacePipeline/Extract"


def read_input(stream):
    header = json.loads(stream.readline())
    pool = []
    for _ in range(header["pool_size"]):
        (n,) = struct.unpack(">I", stream.read(4))
        pool.append(stream.read(n))
    return header, pool


def main() -> int:
    import grpc

    header, pool = read_input(sys.stdin.buffer)
    channel = grpc.insecure_channel(
        f"localhost:{header['port']}",
        options=[("grpc.max_receive_message_length", -1), ("grpc.max_send_message_length", -1)])
    grpc.channel_ready_future(channel).result(timeout=60)
    extract = channel.unary_unary(METHOD)
    timeout = header["timeout_s"]
    k = 0
    for burst in header["warmup"]:
        futs = [extract.future(pool[(k + j) % len(pool)], timeout=timeout) for j in range(burst)]
        k += burst
        for f in futs:
            f.result()
    sys.stdout.write("READY\n")
    sys.stdout.flush()
    if sys.stdin.buffer.readline().strip() != b"GO":
        return 3

    due, images = header["due"], header["image"]
    n = len(due)
    sampled = set(header["sample"])
    done = [None] * n
    ok = [False] * n
    replies = {}
    lock = threading.Lock()
    finished = threading.Event()
    remaining = [n]

    def on_done(fut, i):
        t = time.perf_counter()
        good = False
        try:
            body = fut.result()
            good = not body.startswith(b'{"error"')
            if i in sampled:
                replies[i] = body.decode("utf-8")
        except Exception as e:  # an RPC error, a deadline or a cancel
            if i in sampled:
                replies[i] = json.dumps({"error": f"rpc: {type(e).__name__}"})
        with lock:
            done[i], ok[i] = t, good
            remaining[0] -= 1
            if remaining[0] == 0:
                finished.set()

    start = time.perf_counter() + 0.01
    sent = [0.0] * n
    futs = []
    for i in range(n):
        target = start + due[i]
        while True:
            now = time.perf_counter()
            if now >= target:
                break
            if target - now > 0.002:
                time.sleep(target - now - 0.001)
        sent[i] = time.perf_counter()
        fut = extract.future(pool[images[i]], timeout=timeout)
        fut.add_done_callback(lambda f, i=i: on_done(f, i))
        futs.append(fut)
    last_send = time.perf_counter()
    if not finished.wait(header["drain_s"]):
        for f in futs:
            f.cancel()
        finished.wait(5.0)
    with lock:
        latency = [(done[i] - (start + due[i])) if ok[i] else None for i in range(n)]
        failed = [i for i in range(n) if not ok[i]]
        end = max([t for t in done if t is not None], default=last_send)
    out = {"lag": [sent[i] - (start + due[i]) for i in range(n)], "latency": latency, "failed": failed,
           "window_s": end - start, "send_s": last_send - start, "replies": {str(i): r for i, r in replies.items()}}
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    channel.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
