"""`python -m rs_face_detection_tpu_torch.runtime` -- run the serving runtime.

The port of rs_face_detection_tpu/runtime/__main__.py: one process serves
the JSON-over-gRPC facade and the Triton protobuf contract on ``--port``
and, with ``--http-port``, the KServe-v2 REST endpoint, over one model
registry whose modules run in-process on ``--device``.  The flags are the
JAX package's, plus ``--device``: the card by default, and on a machine
without one ``main`` raises (the process exits non-zero with the reason)
instead of serving on the CPU; ``--device cpu`` serves on the CPU.

    python -m rs_face_detection_tpu_torch.runtime --port 8001 --http-port 8000

It prints ``rs_face_detection_tpu_torch serving on :<port>`` once both
surfaces answer, and stops cleanly on SIGINT or SIGTERM.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time


def _warmup(port: int) -> float:
    """One Extract of a synthetic 640x480 frame over gRPC; its seconds."""
    import cv2
    import numpy as np

    from .server import FacePipelineClient

    img = np.zeros((480, 640, 3), np.uint8)
    img[120:260, 200:330] = 180
    ok, enc = cv2.imencode(".jpg", img)
    if not ok:
        raise RuntimeError("warm-up: cv2.imencode failed")
    client = FacePipelineClient(port=port)
    try:
        t0 = time.perf_counter()
        reply = client.extract(enc.tobytes())
        if "error" in reply:
            raise RuntimeError(f"warm-up Extract failed: {reply['error']}")
        return time.perf_counter() - t0
    finally:
        client.close()




def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rs_face_detection_tpu_torch.runtime",
        description="gRPC and REST serving runtime for the face pipelines on the card",
    )
    parser.add_argument("--port", type=int, default=8001)
    parser.add_argument("--max-workers", type=int, default=8)
    parser.add_argument(
        "--warmup",
        action="store_true",
        help="run one synthetic Extract before accepting traffic (builds the "
        "models and the kernels up front)",
    )
    parser.add_argument(
        "--dynamic-batching",
        action="store_true",
        help="coalesce concurrent Detect and Extract calls into device batches "
        "(the Triton-scheduler role; runtime/batcher.py)",
    )
    parser.add_argument(
        "--batch-delay-ms",
        type=float,
        default=2.0,
        help="max wait for batch-mates after the first queued request",
    )
    parser.add_argument(
        "--checkpoint-dir",
        default=None,
        help="directory of imported .npz checkpoints (checkpoint_io."
        "save_imported output); sets RSFD_CHECKPOINT_DIR before the model "
        "registry is built",
    )
    parser.add_argument(
        "--no-triton-wire",
        action="store_true",
        help="serve only the JSON facade (skip the Triton protobuf contract "
        "on the same port)",
    )
    parser.add_argument(
        "--http-port",
        type=int,
        default=None,
        metavar="PORT",
        help="also serve the KServe-v2 HTTP/REST endpoint (runtime/http.py) on "
        "PORT (0 picks a free one), sharing state with the gRPC protocols",
    )
    parser.add_argument(
        "--model-repository",
        default=None,
        metavar="DIR",
        help="serve a Triton-style model repository (<DIR>/<model>/config.pbtxt "
        "+ <version>/model.npz, runtime/repository.py) instead of the "
        "built-in builders",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="where the models run: the card (default; exits non-zero where "
        "there is none) or 'cpu'",
    )
    args = parser.parse_args(argv)

    from ..utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise RuntimeError(f"{e}: this runtime serves on the CUDA card; pass --device cpu to serve on the CPU") from None

    if args.checkpoint_dir:
        import os

        os.environ["RSFD_CHECKPOINT_DIR"] = args.checkpoint_dir

    from ..models.registry import ModelRegistry, default_registry
    from .server import serve

    if args.model_repository:
        from .repository import attach_repository_builders

        registry = ModelRegistry(device)
        names = attach_repository_builders(registry, args.model_repository)
        print(
            f"model repository {args.model_repository}: "
            f"{len(names)} models ({', '.join(names) or 'none'})",
            flush=True,
        )
    else:
        registry = default_registry(device)

    server = serve(
        registry=registry,
        port=args.port,
        max_workers=args.max_workers,
        dynamic_batching=args.dynamic_batching,
        batch_delay_ms=args.batch_delay_ms,
        triton_wire=not args.no_triton_wire,
        http_port=args.http_port,
    )
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    try:
        port = server._rsfd_port
        if args.http_port is not None:
            print(f"KServe-v2 HTTP endpoint on :{server._rsfd_http_port}", flush=True)
        if args.warmup:
            print(f"warmup extract done in {_warmup(port):.1f}s", flush=True)
        print(f"rs_face_detection_tpu_torch serving on :{port} (device {device})", flush=True)
        stop.wait()
    finally:
        server.stop(grace=2.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
