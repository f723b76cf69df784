"""Batched detection serving with upload/compute overlap, on one device or
split over replicas of the detector on several devices.

Counterpart of rs_face_detection_tpu/parallel/serving.py::DetectionServer.
A batch of payloads (encoded bytes or (H, W, 3) uint8 BGR arrays) becomes
letterboxed uint8 canvases one of two ways, as in the JAX server:

  - the native loader (runtime/native.py, ``use_native_loader=True``, the
    default, when its library builds): a batch whose every payload is JPEG
    bytes is decoded and letterboxed by libjpeg on host threads, and the
    canvases are uploaded; a batch it cannot take whole (arrays, PNG bytes,
    a payload it fails to decode) takes the other way;
  - otherwise payloads are decoded on a thread pool, uploaded, and
    letterboxed on the device with OpenCV's uint8 INTER_LINEAR arithmetic
    (ops/image.py::letterbox_u8_batch, equal to the JAX server's fallback).

Either way the canvases equal the JAX server's for the same payloads and
loader.  ``loader_batches`` counts the batches each way served.

``mesh``, a sequence of devices, is the port's form of the JAX server's
data-sharded detect over a ("data", "model") mesh: one process serves, and
holds one replica of the detector per device, each with its own copy stream
and compute stream on a card.  A batch is split in order into
``batch_size / len(mesh)`` payloads per replica (a short batch leaves the
last replicas less or nothing), each part is staged and detected on its
replica, and the results are gathered in order.  ``batch_size`` not
divisible by the number of replicas raises, as the JAX server's check on
the "data" axis does.  The weights are placed once; when the detector's
module is swapped (``detector.model`` replaced, as a checkpoint reload
does) the replicas are placed again before the next batch.  A device may
appear more than once: that is two replicas on one device, which share the
detector's weights there and each have their own streams; it is how a host
with one card, or the CPU, exercises the split.  Without ``mesh`` the
server is one detector on its own device.

On a CUDA device the upload and the letterbox of a batch run on a side
stream: frames or canvases go through pinned host buffers with non-blocking
copies, and
the compute stream waits on an event before it reads the canvases.  In
``detect_stream`` a producer thread stages batch k+1 this way while the
consumer's batch k computes -- the role of the JAX server's ``_stage``.

Any detector with the ``detect_batch`` contract is served: the
RetinaFaceDetection of pipeline/detection.py and the SCRFDDetection of
pipeline/ekyc_pipeline.py, as the JAX server serves both.  Each batch is
counted once in the detector's registry statistics (``record_traffic``),
whatever the number of replicas: in ``detect_batch`` from staging to the
unpacked results; in ``detect_stream`` the host time of the batch's
dispatch plus that of its fetch, so the time a finished batch waits for the
consumer to ask for it is not counted (the JAX server's streamed duration
runs from dispatch to fetch and includes it).
"""

from __future__ import annotations

import contextlib
import copy
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.image import letterbox_u8_batch
from ..pipeline.detection import PaddedDetections, RetinaFaceDetection
from ..utils.device import DeviceLike, fetch, resolve_device, to_device
from ..utils.image_io import decode_image_bytes

Result = Tuple[np.ndarray, np.ndarray]


class _Staged(NamedTuple):
    """A batch on the device, ready for detect: letterboxed canvases, their
    scales, and the event the compute stream waits on (None on the CPU)."""

    canvases: torch.Tensor  # (n, H, W, 3) uint8
    scales: torch.Tensor  # (n,) float32
    ready: Optional[torch.cuda.Event]


class _Replica(NamedTuple):
    """The detector on one device, the side stream its parts are staged on,
    and the stream they compute on (None: the caller's current stream)."""

    detector: Any
    copy_stream: Optional[torch.cuda.Stream]
    compute_stream: Optional[torch.cuda.Stream]


def detector_image_size(detector: Any) -> Tuple[int, int]:
    """A detector's (width, height) input: its ``image_size`` attribute
    (SCRFDDetection) or its config's (RetinaFaceDetection)."""
    size = getattr(detector, "image_size", None) or detector.cfg.image_size
    return tuple(size)


def replica_on(detector: Any, device: torch.device) -> Any:
    """A shallow copy of a detector whose modules and tensors (its network,
    anchors, folded stem constants) are copies on ``device``."""
    rep = copy.copy(detector)
    for name, value in vars(detector).items():
        if isinstance(value, torch.nn.Module):
            value = copy.deepcopy(value).to(device)
        elif isinstance(value, torch.Tensor):
            value = value.to(device)
        elif isinstance(value, tuple) and value and all(isinstance(t, torch.Tensor) for t in value):
            value = tuple(t.to(device) for t in value)
        setattr(rep, name, value)
    rep.device = device
    return rep


class DetectionServer:
    """Batched detection on the detector's device, or split over replicas.

    detector: a ``RetinaFaceDetection`` or ``SCRFDDetection`` -- anything with
    ``device``, ``model``, an image size, ``detect_batch(canvases, scales)``
    and ``record_traffic(n, seconds)`` (default: ``RetinaFaceDetection()``,
    from the default registry on the card); batch_size: most payloads per
    ``detect_batch`` call and per streamed batch; decode_workers: threads
    that decode encoded payloads; use_native_loader: take the native JPEG
    loader when its library builds (``native_unavailable`` then says why it
    did not); mesh: devices to hold one replica each (a device may repeat),
    ``batch_size`` divisible by their number.
    """

    def __init__(
        self,
        detector: Optional[Any] = None,
        batch_size: int = 8,
        decode_workers: int = 4,
        use_native_loader: bool = True,
        mesh: Optional[Sequence[DeviceLike]] = None,
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
        self.mesh = None if mesh is None else [resolve_device(d) for d in mesh]
        if self.mesh is not None:
            if not self.mesh:
                raise ValueError("mesh holds no device")
            if batch_size % len(self.mesh):
                raise ValueError(f"batch_size {batch_size} not divisible by {len(self.mesh)} replicas")
        self.device = self.detector.device if self.mesh is None else self.mesh[0]
        self.batch_size = batch_size
        self._pool = ThreadPoolExecutor(max_workers=decode_workers)
        self._decode_workers = decode_workers
        self._place_lock = threading.Lock()
        self._replicas = self._place()

    def _place(self) -> List[_Replica]:
        """The replicas of the detector's current module: the detector
        itself on its own device, a copy on each other device (once per
        device), and on a card two streams per replica."""
        self._placed_model = getattr(self.detector, "model", None)
        if self.mesh is None:
            dev = self.detector.device
            stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
            return [_Replica(self.detector, stream, None)]
        on_device = {self.detector.device: self.detector}
        replicas = []
        for dev in self.mesh:
            if dev not in on_device:
                on_device[dev] = replica_on(self.detector, dev)
            cuda = dev.type == "cuda"
            replicas.append(_Replica(
                on_device[dev],
                torch.cuda.Stream(device=dev) if cuda else None,
                torch.cuda.Stream(device=dev) if cuda else None,
            ))
        for dev in on_device:
            if dev.type == "cuda":  # the copies are read from the replicas' own streams
                torch.cuda.synchronize(dev)
        return replicas

    def _current(self) -> List[_Replica]:
        """The replicas, placed again first if the detector's module was
        swapped since they were placed."""
        with self._place_lock:
            if self.mesh is not None and getattr(self.detector, "model", None) is not self._placed_model:
                self._replicas = self._place()
            return list(self._replicas)

    def replicas(self) -> List[Any]:
        """The detector serving each part of a batch, in order."""
        return [rep.detector for rep in self._current()]

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

    def _stage(self, payloads: Sequence) -> List[Tuple[_Replica, _Staged, int]]:
        """Decode and letterbox a batch, split in order over the replicas,
        each part uploaded on its replica's side stream: (replica, part,
        payloads in it) for each replica that has a share."""
        replicas = self._current()
        native = self._native_canvases(payloads)
        images = None if native is not None else list(self._pool.map(self._decode, payloads))
        self.loader_batches["native" if native is not None else "cv2"] += 1
        per = self.batch_size // len(replicas)
        parts = []
        for i, rep in enumerate(replicas):
            lo, hi = i * per, min(len(payloads), (i + 1) * per)
            if lo >= hi:
                break
            parts.append((rep, self._stage_part(rep, native, images, lo, hi), hi - lo))
        return parts

    def _stage_part(self, rep: _Replica, native, images, lo: int, hi: int) -> _Staged:
        width, height = self.image_size
        dev = rep.detector.device
        stream = rep.copy_stream
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with ctx:
            if native is not None:
                canvases = torch.from_numpy(native[0][lo:hi])
                if stream is not None:
                    canvases = canvases.pin_memory()
                canvases = canvases.to(dev, non_blocking=True)
                scales = native[1][lo:hi]
            else:
                canvases, scales = letterbox_u8_batch(images[lo:hi], width, height, dev)
            scales_dev = to_device(np.asarray(scales, np.float32), dev)
            ready = None
            if stream is not None:
                ready = torch.cuda.Event()
                ready.record(stream)
        return _Staged(canvases, scales_dev, ready)

    # -- serving -------------------------------------------------------------

    @staticmethod
    def _on(rep: _Replica):
        """The replica's compute stream as the current one (a no-op without)."""
        if rep.compute_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(rep.compute_stream)

    def _run(self, parts) -> List[Tuple[_Replica, PaddedDetections, int]]:
        """Dispatch each part's detect on its replica's compute stream once
        it is staged."""
        outs = []
        for rep, staged, n in parts:
            with self._on(rep):
                if staged.ready is not None:
                    stream = torch.cuda.current_stream(rep.detector.device)
                    stream.wait_event(staged.ready)
                    # The side stream allocated these: tell the allocator
                    # that the compute stream uses them too.
                    staged.canvases.record_stream(stream)
                    staged.scales.record_stream(stream)
                outs.append((rep, rep.detector.detect_batch(staged.canvases, staged.scales), n))
        return outs

    def _unpack(self, outs) -> List[Result]:
        """Each part's rows to numpy (on its compute stream), in order."""
        results: List[Result] = []
        for rep, out, n in outs:
            with self._on(rep):
                det, kps, counts = fetch(*out)
            results += [(det[i, : counts[i]], kps[i, : counts[i]]) for i in range(n)]
        return results

    def detect_batch(self, payloads: Sequence) -> List[Result]:
        """Detect faces in up to batch_size payloads: per payload, det (N, 5)
        and kps (N, 5, 2) in numpy, in the original image's pixels."""
        if len(payloads) > self.batch_size:
            raise ValueError(f"batch larger than configured size {self.batch_size}")
        if not payloads:
            return []
        start = time.perf_counter()
        results = self._unpack(self._run(self._stage(payloads)))
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

        def dispatch(parts, n: int):
            start = time.perf_counter()
            outs = self._run(parts)
            return outs, n, time.perf_counter() - start

        def emit(outs, n: int, dispatch_s: float) -> List[Result]:
            # Timed apart from the dispatch: a consumer that holds on to the
            # previous batch does not lengthen this one's duration.
            start = time.perf_counter()
            results = self._unpack(outs)
            self.detector.record_traffic(n, dispatch_s + time.perf_counter() - start)
            return results

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            pending: List[Tuple[Any, int, float]] = []
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
