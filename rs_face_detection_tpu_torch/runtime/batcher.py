"""Dynamic request batching: Triton's scheduler role, in-process.

The port's copy of rs_face_detection_tpu/runtime/batcher.py.  Concurrent
callers submit single items; a worker drains the queue into one device
batch -- up to the server's batch size, waiting at most `max_delay_ms`
after the first request -- so the card sees batches instead of batch-1
dispatches.  Short batches ride the server's zero padding
(serving/detection_server.py), so every batch has the server's one shape.

Failure isolation: if a batch fails host-side (e.g. one undecodable
payload), the worker retries each item individually so only the bad
request's future carries the exception.

Tracing (utils/tracing.py, on while torch.profiler runs): each request's
wait from ``submit`` to the start of its batch is a ``runtime.queue`` span
with its request id (given to ``submit``) and its batch's id, and each
``batch_fn`` call a ``runtime.batch`` span with the batch id and the
request ids.  The cumulative queue and compute seconds of ``stats()`` come
from the same ``perf_counter`` reads.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

from ..utils import tracing

_SENTINEL = object()


class DynamicBatcher:
    """Coalesces concurrent single-item requests into device batches.

    Args:
      server: a serving.detection_server.DetectionServer (its batch_size
        caps the coalesced batch; its letterbox and detect do the work).
      max_delay_ms: how long the worker waits for more requests after the
        first one of a batch.  0 batches only what is already queued.
      batch_fn / batch_size: generic alternative to `server` — any
        callable taking a list of payloads and returning one result per
        payload (e.g. FacePipeline.extract_batch), with the static batch
        cap to coalesce to.  When `server` is given they default to its
        detect_batch / batch_size.
    """

    def __init__(
        self,
        server=None,
        max_delay_ms: float = 2.0,
        *,
        batch_fn=None,
        batch_size: Optional[int] = None,
    ) -> None:
        self._server = server
        if server is not None:
            batch_fn = batch_fn or server.detect_batch
            batch_size = batch_size or server.batch_size
        if batch_fn is None or not batch_size:
            raise ValueError("need a server or (batch_fn, batch_size)")
        self._batch_fn = batch_fn
        self._batch_size = int(batch_size)
        self._max_delay = max(0.0, float(max_delay_ms)) / 1000.0
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._closed = threading.Event()
        # Makes the closed-check + enqueue atomic vs close(): without it a
        # submit racing close() could enqueue after the worker's final
        # drain, leaving its Future unresolved forever.
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._batch_sizes: "collections.Counter" = collections.Counter()
        # Duration accounting (Triton model_statistics parity: its
        # inference_stats splits queue vs compute), cumulative; the
        # distribution is in the runtime.queue spans of a traced session.
        self._cum_queue_ns = 0
        self._cum_compute_ns = 0
        self._batch_ids = itertools.count(1)
        self._worker = threading.Thread(
            target=self._loop, name="rsfd-dynamic-batcher", daemon=True
        )
        self._worker.start()

    # -- client surface ------------------------------------------------------

    def submit(self, payload: Any, request_id: Optional[int] = None) -> "Future":
        """Enqueue one image (bytes or BGR array); resolves to (boxes, kps).
        ``request_id``: the caller's id of the request, which its
        ``runtime.queue`` and ``runtime.batch`` spans carry."""
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("DynamicBatcher is closed")
            fut: "Future" = Future()
            self._queue.put((payload, fut, time.perf_counter_ns(), request_id))
        return fut

    def detect(
        self, payload: Any, timeout: Optional[float] = None
    ) -> Tuple[Any, Any]:
        """Blocking single-image detect through the shared batch queue."""
        return self.submit(payload).result(timeout)

    def stats(self) -> Dict[str, Any]:
        """Observability: how well requests coalesced.

        Returns {"batches": total batches run, "requests": total requests,
        "batch_size_counts": {size: count}} — the analog of Triton's
        inference_statistics batching counters — plus the duration split
        Triton's inference_stats carries (queue vs compute), in cumulative
        seconds.  Queue time is per REQUEST (submit -> its batch starts);
        compute time is per BATCH (one batch_fn call).  Their distributions
        are the runtime.queue and runtime.batch spans of a traced session.
        """
        with self._stats_lock:
            sizes = dict(self._batch_sizes)
            queue_ns, compute_ns = self._cum_queue_ns, self._cum_compute_ns
        return {
            "batches": sum(sizes.values()),
            "requests": sum(k * v for k, v in sizes.items()),
            "batch_size_counts": {str(k): v for k, v in sorted(sizes.items())},
            "cumulative_queue_s": round(queue_ns * 1e-9, 6),
            "cumulative_compute_s": round(compute_ns * 1e-9, 6),
        }

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting work, drain the queue, join the worker."""
        with self._submit_lock:
            if self._closed.is_set():
                return
            self._closed.set()
            self._queue.put(_SENTINEL)
        self._worker.join(timeout)

    def __enter__(self) -> "DynamicBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker ----------------------------------------------------------------

    def _drain(self, first) -> Tuple[List[Tuple[Any, "Future", int, Optional[int]]], bool]:
        """Collect up to batch_size items: `first` already arrived; wait at
        most max_delay for the rest.  Returns (items, saw_sentinel)."""
        items = [first]
        deadline = time.perf_counter() + self._max_delay
        while len(items) < self._batch_size:
            remaining = deadline - time.perf_counter()
            try:
                nxt = (
                    self._queue.get_nowait()
                    if remaining <= 0
                    else self._queue.get(timeout=remaining)
                )
            except queue.Empty:
                break
            if nxt is _SENTINEL:
                return items, True
            items.append(nxt)
        return items, False

    @staticmethod
    def _resolve(fut: "Future", value=None, exc=None) -> None:
        # A caller may have cancelled its Future; set_* would then raise
        # InvalidStateError and kill the worker thread for everyone.
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except Exception:
            pass  # cancelled / already resolved: nothing to deliver

    def _run_batch(self, items: List[Tuple[Any, "Future", int, Optional[int]]]) -> None:
        # Claim each Future (blocks late cancel()); drop already-cancelled
        # requests before paying for their device work.
        items = [item for item in items if item[1].set_running_or_notify_cancel()]
        if not items:
            return
        batch_id = next(self._batch_ids)
        t_start = time.perf_counter_ns()
        queue_ns = sum(t_start - t for _, _, t, _ in items)
        if tracing.enabled():
            for _, _, t, rid in items:
                tracing.record("runtime.queue", t, t_start, request=rid, batch=batch_id)
        payloads = [p for p, _, _, _ in items]
        with tracing.span("runtime.batch", t_start) as sp:
            if sp:
                sp.set("batch", batch_id)
                sp.set("requests", [rid for _, _, _, rid in items])
            try:
                results = self._batch_fn(payloads)
            except Exception:
                # One bad payload must not sink its batch neighbors: retry each
                # request alone so the exception lands only on the culprit(s).
                for p, fut, _, _ in items:
                    try:
                        self._resolve(fut, self._batch_fn([p])[0])
                    except Exception as e:
                        self._resolve(fut, exc=e)
            else:
                for (_, fut, _, _), res in zip(items, results):
                    self._resolve(fut, res)
            t_end = sp.end(time.perf_counter_ns())
        with self._stats_lock:
            self._batch_sizes[len(items)] += 1
            self._cum_queue_ns += queue_ns
            self._cum_compute_ns += t_end - t_start

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                break
            items, saw_sentinel = self._drain(item)
            self._run_batch(items)
            if saw_sentinel:
                break
        # Drain-after-close: resolve anything still queued (submits that
        # raced close()) so no future is left hanging.
        leftovers = []
        while True:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is not _SENTINEL:
                leftovers.append(nxt)
        while leftovers:
            chunk = leftovers[: self._batch_size]
            leftovers = leftovers[self._batch_size :]
            self._run_batch(chunk)
