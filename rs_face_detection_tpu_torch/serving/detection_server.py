"""Batched detection serving on one device, with upload/compute overlap.

Counterpart of rs_face_detection_tpu/parallel/serving.py::DetectionServer
without the mesh: one detector on one device.  A batch of payloads (encoded
bytes or (H, W, 3) uint8 BGR arrays) becomes letterboxed uint8 canvases one
of two ways, as in the JAX server:

  - the native loader (runtime/native.py, ``use_native_loader=True``, the
    default, when its library builds): a batch whose every payload is JPEG
    bytes is decoded and letterboxed by libjpeg on host threads, and the
    canvases are uploaded; a batch it cannot take whole (arrays, PNG bytes,
    a payload it fails to decode) takes the other way;
  - otherwise payloads are decoded on a thread pool, uploaded, and
    letterboxed on the device with OpenCV's uint8 INTER_LINEAR arithmetic
    (ops/image.py::letterbox_u8_batch, equal to the JAX server's fallback).

Either way the canvases equal the JAX server's for the same payloads and
loader, and are detected in one ``detect_batch`` call.  ``loader_batches``
counts the batches each way served.

On a CUDA device the upload and the letterbox of a batch run on a side
stream: frames or canvases go through pinned host buffers with non-blocking
copies, and
the compute stream waits on an event before it reads the canvases.  In
``detect_stream`` a producer thread stages batch k+1 this way while the
consumer's batch k computes -- the role of the JAX server's ``_stage``.

Any detector with the ``detect_batch`` contract is served: the
RetinaFaceDetection of pipeline/detection.py and the SCRFDDetection of
pipeline/ekyc_pipeline.py, as the JAX server serves both.  Each batch is
counted in the detector's registry statistics (``record_traffic``): in
``detect_batch`` from staging to the unpacked results; in ``detect_stream``
the host time of the batch's dispatch plus that of its fetch, so the time a
finished batch waits for the consumer to ask for it is not counted (the JAX
server's streamed duration runs from dispatch to fetch and includes it).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.image import letterbox_u8_batch
from ..pipeline.detection import PaddedDetections, RetinaFaceDetection
from ..utils.image_io import decode_image_bytes

Result = Tuple[np.ndarray, np.ndarray]


class _Staged(NamedTuple):
    """A batch on the device, ready for detect: letterboxed canvases, their
    scales, and the event the compute stream waits on (None on the CPU)."""

    canvases: torch.Tensor  # (n, H, W, 3) uint8
    scales: torch.Tensor  # (n,) float32
    ready: Optional[torch.cuda.Event]


def detector_image_size(detector: Any) -> Tuple[int, int]:
    """A detector's (width, height) input: its ``image_size`` attribute
    (SCRFDDetection) or its config's (RetinaFaceDetection)."""
    size = getattr(detector, "image_size", None) or detector.cfg.image_size
    return tuple(size)


class DetectionServer:
    """Batched detection on the detector's device.

    detector: a ``RetinaFaceDetection`` or ``SCRFDDetection`` -- anything with
    ``device``, an image size, ``detect_batch(canvases, scales)`` and
    ``record_traffic(n, seconds)`` (default: ``RetinaFaceDetection()``, from
    the default registry on the card); batch_size: most payloads per
    ``detect_batch`` call and per streamed batch; decode_workers: threads
    that decode encoded payloads; use_native_loader: take the native JPEG
    loader when its library builds (``native_unavailable`` then says why it
    did not).
    """

    def __init__(
        self,
        detector: Optional[Any] = None,
        batch_size: int = 8,
        decode_workers: int = 4,
        use_native_loader: bool = True,
    ) -> None:
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._native = None
        self.native_unavailable: Optional[str] = "use_native_loader=False"
        if use_native_loader:
            from ..runtime import native

            self.native_unavailable = native.unavailable_reason()
            if self.native_unavailable is None:
                self._native = native
        self.loader_batches = {"native": 0, "cv2": 0}
        self.detector = detector or RetinaFaceDetection()
        self.image_size = detector_image_size(self.detector)
        self.device = self.detector.device
        self.batch_size = batch_size
        self._pool = ThreadPoolExecutor(max_workers=decode_workers)
        self._decode_workers = decode_workers
        self._copy_stream = (
            torch.cuda.Stream(device=self.device) if self.device.type == "cuda" else None
        )

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        """Release the decode threads (idempotent); the server can no longer
        serve afterwards."""
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "DetectionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- staging -------------------------------------------------------------

    @staticmethod
    def _decode(payload) -> np.ndarray:
        if isinstance(payload, (bytes, bytearray)):
            return decode_image_bytes(payload)
        return np.ascontiguousarray(payload)

    def _native_canvases(self, payloads: Sequence):
        """(canvases (n, H, W, 3) uint8, scales) from the native loader on the
        host, or None when it cannot take the whole batch."""
        if self._native is None or not all(isinstance(p, (bytes, bytearray)) for p in payloads):
            return None
        width, height = self.image_size
        imgs, scales, ok = self._native.decode_letterbox_batch(
            payloads, width, height, num_threads=self._decode_workers
        )
        return (imgs, scales) if ok.all() else None

    def _stage(self, payloads: Sequence) -> _Staged:
        """Decode, letterbox and upload a batch on the side stream."""
        native = self._native_canvases(payloads)
        images = None if native is not None else list(self._pool.map(self._decode, payloads))
        width, height = self.image_size
        cuda = self._copy_stream is not None
        ctx = torch.cuda.stream(self._copy_stream) if cuda else contextlib.nullcontext()
        with ctx:
            if native is not None:
                self.loader_batches["native"] += 1
                canvases = torch.from_numpy(native[0])
                if cuda:
                    canvases = canvases.pin_memory()
                canvases = canvases.to(self.device, non_blocking=True)
                scales = native[1]
            else:
                self.loader_batches["cv2"] += 1
                canvases, scales = letterbox_u8_batch(images, width, height, self.device)
            scales_dev = torch.tensor(scales, dtype=torch.float32, device=self.device)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        return _Staged(canvases, scales_dev, ready)

    # -- serving -------------------------------------------------------------

    def _run(self, staged: _Staged) -> PaddedDetections:
        """Dispatch detect on the current stream once the batch is staged."""
        if staged.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.ready)
            # The side stream allocated these: tell the allocator that the
            # compute stream uses them too.
            staged.canvases.record_stream(stream)
            staged.scales.record_stream(stream)
        return self.detector.detect_batch(staged.canvases, staged.scales)

    @staticmethod
    def _unpack(out: PaddedDetections, n: int) -> List[Result]:
        det, kps, counts = (t.cpu().numpy() for t in (out.det, out.kps, out.count))
        return [(det[i, : counts[i]], kps[i, : counts[i]]) for i in range(n)]

    def detect_batch(self, payloads: Sequence) -> List[Result]:
        """Detect faces in up to batch_size payloads: per payload, det (N, 5)
        and kps (N, 5, 2) in numpy, in the original image's pixels."""
        if len(payloads) > self.batch_size:
            raise ValueError(f"batch larger than configured size {self.batch_size}")
        if not payloads:
            return []
        start = time.perf_counter()
        results = self._unpack(self._run(self._stage(payloads)), len(payloads))
        self.detector.record_traffic(len(payloads), time.perf_counter() - start)
        return results

    def detect_stream(self, payload_iter: Iterable, prefetch: int = 2) -> Iterator[List[Result]]:
        """Yield ``detect_batch`` results per batch of batch_size payloads
        (the last may be shorter).  A producer thread stages batch k+1 while
        batch k computes; a producer error is raised here after the batches
        already staged have been emitted."""
        batches: "queue.Queue" = queue.Queue(maxsize=max(1, int(prefetch)))
        sentinel = object()
        abandoned = threading.Event()

        def put(item) -> bool:
            # Give up when the consumer is gone, or the producer would block
            # on a full queue forever.
            while not abandoned.is_set():
                try:
                    batches.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                chunk: List = []
                for payload in payload_iter:
                    if abandoned.is_set():
                        return
                    chunk.append(payload)
                    if len(chunk) == self.batch_size:
                        if not put((self._stage(chunk), len(chunk))):
                            return
                        chunk = []
                if chunk:
                    put((self._stage(chunk), len(chunk)))
            except BaseException as e:  # re-raised by the consumer
                put(e)
            finally:
                put(sentinel)

        def dispatch(staged: _Staged, n: int) -> Tuple[PaddedDetections, int, float]:
            start = time.perf_counter()
            out = self._run(staged)
            return out, n, time.perf_counter() - start

        def emit(out: PaddedDetections, n: int, dispatch_s: float) -> List[Result]:
            # Timed apart from the dispatch: a consumer that holds on to the
            # previous batch does not lengthen this one's duration.
            start = time.perf_counter()
            results = self._unpack(out, n)
            self.detector.record_traffic(n, dispatch_s + time.perf_counter() - start)
            return results

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            pending: List[Tuple[PaddedDetections, int, float]] = []
            while True:
                item = batches.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    for batch in pending:  # drain the dispatched batches first
                        yield emit(*batch)
                    thread.join()
                    raise item
                pending.append(dispatch(*item))
                if len(pending) > 1:
                    yield emit(*pending.pop(0))
            for batch in pending:
                yield emit(*batch)
            thread.join()
        finally:
            abandoned.set()
