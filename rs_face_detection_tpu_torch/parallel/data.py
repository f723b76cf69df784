"""Real-data training input: annotations -> letterboxed TrainBatches.

Counterpart of rs_face_detection_tpu/parallel/data.py.  Two annotation
formats: the public RetinaFace training labels (``label.txt``: ``# rel/path``
header lines, then per face ``x y w h`` and five (x, y, vis) landmark
triplets, all -1 when the face has none) and WIDER FACE
``wider_face_*_bbx_gt.txt`` (ops/wider.py's parser; boxes only, invalid faces
as ignore regions).

Host geometry is the serving path's: a top-left-anchored letterbox at
min-scale with cv2.INTER_LINEAR (``letterbox_host``, a copy of the JAX
package's parallel/serving.py::letterbox_host), boxes and landmarks scaled by
the same det_scale.  Images are raw 0-255 float32 RGB, the trainer's
convention (parallel/train.py::TrainBatch).  Decode runs on a thread pool,
ground truth is padded to a static ``max_faces``, and the shuffles are the
JAX loader's (``np.random.default_rng(seed)``), so both loaders yield the
same arrays from the same files.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.image import letterbox_geometry
from ..utils.device import DeviceLike, resolve_device
from .mesh import data_rows
from .train import TrainBatch

try:  # cv2 is the decoder and the resize; the loader refuses to start without it
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def letterbox_host(img: np.ndarray, dst_w: int, dst_h: int) -> Tuple[np.ndarray, float]:
    """(dst_h, dst_w, 3) uint8 canvas of ``img`` resized with cv2's
    INTER_LINEAR into the top-left corner, and the det_scale."""
    if cv2 is None:
        raise RuntimeError("letterbox_host needs cv2")
    src_h, src_w = img.shape[:2]
    new_w, new_h, det_scale = letterbox_geometry(src_h, src_w, dst_w, dst_h)
    resized = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    out = np.zeros((dst_h, dst_w, 3), np.uint8)
    out[:new_h, :new_w] = resized
    return out, det_scale


@dataclass
class FaceExample:
    """One annotated image: corner boxes, optional 5-point landmarks, and
    regions to exclude from training (neither positive nor negative)."""

    rel_path: str
    boxes: np.ndarray  # (N, 4) x1 y1 x2 y2
    lms: np.ndarray = field(default_factory=lambda: np.zeros((0, 5, 2), np.float32))
    lm_valid: np.ndarray = field(default_factory=lambda: np.zeros((0,), bool))
    ignore_boxes: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))

    def __post_init__(self) -> None:
        n = self.boxes.shape[0]
        if self.lms.shape[0] != n or self.lm_valid.shape[0] != n:
            # Mismatched landmark annotations: drop both together, or zeroed
            # landmarks marked valid would train the head toward the origin.
            self.lms = np.zeros((n, 5, 2), np.float32)
            self.lm_valid = np.zeros((n,), bool)


def parse_retinaface_label(path: str) -> List[FaceExample]:
    """Parse the public RetinaFace ``label.txt``: per image a ``# rel/path``
    line, then per face ``x y w h  x1 y1 v1 ... x5 y5 v5  [conf]``.  Boxes
    become inclusive corners; a face whose landmark triplets are all -1 has
    no landmarks (a negative coordinate alone is still an annotation)."""
    examples: List[FaceExample] = []
    rel: Optional[str] = None
    boxes: List[Tuple[float, float, float, float]] = []
    lms: List[np.ndarray] = []
    lmv: List[bool] = []

    def flush() -> None:
        if rel is not None:
            examples.append(FaceExample(
                rel,
                np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(lms, np.float32).reshape(-1, 5, 2),
                np.asarray(lmv, bool).reshape(-1),
            ))

    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                flush()
                rel, boxes, lms, lmv = line[1:].strip(), [], [], []
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) < 4 or rel is None:
                continue
            x, y, w, h = vals[:4]
            if w <= 0 or h <= 0:
                continue
            boxes.append((x, y, x + w - 1.0, y + h - 1.0))
            if len(vals) >= 19:
                tri = np.asarray(vals[4:19], np.float32)
                pts = tri.reshape(5, 3)[:, :2]
                ok = not bool(np.all(tri == -1.0))
            else:
                pts, ok = np.zeros((5, 2), np.float32), False
            lms.append(pts)
            lmv.append(ok)
    flush()
    return examples


def wider_examples(gt_file: str) -> List[FaceExample]:
    """WIDER FACE bbx_gt annotations as training examples (no landmarks);
    invalid-marked faces become ignore regions."""
    from ..ops.wider import parse_gt_file

    return [FaceExample(im.rel_path, im.boxes, ignore_boxes=im.invalid_boxes) for im in parse_gt_file(gt_file)]


class DetectionDataLoader:
    """Streams letterboxed TrainBatches from annotated images on disk.

    Args:
      examples: FaceExample list (parse_retinaface_label / wider_examples).
      image_root: directory rel_paths resolve against.
      image_size: (width, height) static training canvas.
      batch_size: images per TrainBatch.
      max_faces: static ground-truth padding; faces beyond it are dropped
        largest-first and join the ignore rows.
      seed: shuffle seed; reshuffled every epoch.
      decode_workers: host decode thread pool size.
      process_shard: (index, count): keep every count-th example from
        index, truncated to equal shard sizes.
    """

    def __init__(
        self,
        examples: Sequence[FaceExample],
        image_root: str,
        image_size: Tuple[int, int] = (640, 640),
        batch_size: int = 8,
        max_faces: int = 32,
        seed: int = 0,
        decode_workers: int = 8,
        process_shard: Optional[Tuple[int, int]] = None,
    ) -> None:
        if cv2 is None:
            raise RuntimeError("DetectionDataLoader needs cv2 for decode")
        if process_shard is not None:
            idx, cnt = process_shard
            if not 0 <= idx < cnt:
                raise ValueError(f"bad process_shard {process_shard}")
            per = len(examples) // cnt
            examples = list(examples)[idx::cnt][:per]
        if not examples:
            raise ValueError("no examples")
        if len(examples) < batch_size:
            raise ValueError(f"{len(examples)} examples < batch_size {batch_size}: an epoch would yield no batches")
        self.examples = list(examples)
        self.image_root = image_root
        self.image_size = image_size
        self.batch_size = batch_size
        self.max_faces = max_faces
        self._rng = np.random.default_rng(seed)
        self._pool = ThreadPoolExecutor(max_workers=decode_workers)

    def close(self) -> None:
        """Release the decode thread pool."""
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "DetectionDataLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _load_one(self, ex: FaceExample) -> Tuple[np.ndarray, ...]:
        """(image, boxes, lms, valid, lm_valid, ignore) for one example."""
        w, h = self.image_size
        path = os.path.join(self.image_root, ex.rel_path)
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        canvas, det_scale = letterbox_host(img, w, h)
        image = canvas[:, :, ::-1].astype(np.float32)  # BGR -> RGB raw pixels

        m = self.max_faces
        boxes = np.zeros((m, 4), np.float32)
        lms = np.zeros((m, 5, 2), np.float32)
        valid = np.zeros((m,), bool)
        lm_valid = np.zeros((m,), bool)
        dropped = np.zeros((0, 4), np.float32)
        if ex.boxes.shape[0]:
            order = np.argsort(-(ex.boxes[:, 2] - ex.boxes[:, 0]) * (ex.boxes[:, 3] - ex.boxes[:, 1]))
            kept = order[:m]
            n = kept.shape[0]
            boxes[:n] = ex.boxes[kept] * det_scale
            lms[:n] = ex.lms[kept] * det_scale
            valid[:n] = True
            lm_valid[:n] = ex.lm_valid[kept]
            # Faces beyond max_faces join the ignore rows: as plain
            # negatives, OHEM would mine exactly those anchors.
            dropped = ex.boxes[order[m:]] * det_scale
        ignore = np.zeros((m, 4), np.float32)
        ign_src = np.concatenate([dropped, ex.ignore_boxes.reshape(-1, 4) * det_scale])
        if ign_src.shape[0] > m:  # keep the largest
            areas = (ign_src[:, 2] - ign_src[:, 0]) * (ign_src[:, 3] - ign_src[:, 1])
            ign_src = ign_src[np.argsort(-areas)[:m]]
        k = ign_src.shape[0]
        if k:
            ignore[:k] = ign_src
        return image, boxes, lms, valid, lm_valid, ignore

    def batches(
        self, epochs: Optional[int] = 1, device: Optional[DeviceLike] = None, mesh: Optional[DeviceMesh] = None
    ) -> Iterator[TrainBatch]:
        """Yield TrainBatches of numpy arrays, or with ``device`` of tensors
        there (copied from pinned memory to a card); ``epochs=None`` streams
        forever, reshuffling each epoch.  With a ("data", "model") ``mesh``
        (parallel/mesh.py::make_mesh) each batch is this rank's data index's
        rows of the global batch of ``batch_size`` (only those are decoded):
        every rank builds its loader from the same examples and seed, so the
        ranks draw the same global batches, as the JAX loader's
        ``sharding=`` splits one global batch over the devices."""
        dev = None if device is None else resolve_device(device)
        share = data_rows(mesh, self.batch_size)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = self._rng.permutation(len(self.examples))
            for lo in range(0, len(order) - self.batch_size + 1, self.batch_size):
                idx = order[lo : lo + self.batch_size][share]
                rows = list(self._pool.map(self._load_one, [self.examples[i] for i in idx]))
                arrs = [np.stack(col) for col in zip(*rows)]
                if dev is not None:
                    tensors = [torch.from_numpy(a) for a in arrs]
                    if dev.type == "cuda":
                        tensors = [t.pin_memory().to(dev, non_blocking=True) for t in tensors]
                    else:
                        tensors = [t.to(dev) for t in tensors]
                    arrs = tensors
                yield TrainBatch(*arrs)
            epoch += 1
