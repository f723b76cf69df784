"""WIDER FACE dataset protocol: annotation parsing and the evaluation runner.

The port's copy of rs_face_detection_tpu/ops/wider.py.  ``parse_gt_file``
reads ``wider_face_val_bbx_gt.txt``:

    0--Parade/0_Parade_marchingband_1_849.jpg
    1
    449 330 122 149 0 0 0 0 0 0
    ...

a relative image path, a face count, then per face
``x y w h blur expression illumination invalid occlusion pose``.  A count of
0 is followed by one all-zero placeholder row (the official files do this).
Faces with invalid=1 are excluded from scoring, as the official toolkit's
preprocessing does.  ``evaluate_wider`` reports one overall AP over all
scored faces through ops/eval.py; the official easy/medium/hard protocol
lives in ops/wider_split.py.  Images are read as bytes and decoded by
utils/image_io.py::decode_image_bytes.  tests/test_torch_wider.py holds the
parser and both runners equal to JAX's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..pipeline.tracking import iou_matrix_np
from ..utils.image_io import decode_image_bytes
from .eval import ImageEval, average_precision, match_detections


@dataclass
class WiderImage:
    rel_path: str
    boxes: np.ndarray  # (N, 4) x1 y1 x2 y2 (inclusive corners), scored faces
    invalid_boxes: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 4), np.float32)
    )


def parse_gt_file(path: str) -> List[WiderImage]:
    """Parse a wider_face_*_bbx_gt.txt annotation file."""
    images: List[WiderImage] = []
    with open(path, "r") as f:
        lines = [ln.strip() for ln in f]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        rel = lines[i]
        n = int(lines[i + 1])
        rows = lines[i + 2 : i + 2 + max(n, 1)]
        i += 2 + max(n, 1)  # count 0 still carries one placeholder row
        valid, invalid = [], []
        if n > 0:
            for row in rows:
                vals = [float(v) for v in row.split()]
                x, y, w, h = vals[:4]
                if w <= 0 or h <= 0:
                    continue
                # Inclusive corners (x+w-1), the project's own convention —
                # this simplified harness is internally consistent with the
                # detector's boxes.  The OFFICIAL per-difficulty scorer
                # (ops/wider_split.py) instead replicates eval_tools'
                # x2 = x + w arithmetic for published-number parity.
                box = (x, y, x + w - 1.0, y + h - 1.0)
                is_invalid = len(vals) > 7 and vals[7] == 1
                (invalid if is_invalid else valid).append(box)
        images.append(
            WiderImage(
                rel,
                np.asarray(valid, np.float32).reshape(-1, 4),
                np.asarray(invalid, np.float32).reshape(-1, 4),
            )
        )
    return images


def read_image(path: str) -> np.ndarray:
    """An image file as (H, W, 3) uint8 BGR; FileNotFoundError if absent."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        return decode_image_bytes(f.read())


def _score_entry(dets, entry, iou_threshold: float) -> ImageEval:
    """Shared per-entry scoring for both evaluate_wider variants.

    Normalizes the detector output (arrays or plain lists, >=5 columns),
    drops detections whose best overlap is an invalid-marked GT region
    (the official toolkit ignores those regions rather than counting false
    positives), and greedily matches the rest.
    """
    dets = np.asarray(dets, np.float32)
    dets = dets.reshape(-1, dets.shape[-1] if dets.size else 5)[:, :5]
    if len(entry.invalid_boxes) and len(dets):
        iou_inv = iou_matrix_np(dets[:, :4], entry.invalid_boxes)
        iou_val = (
            iou_matrix_np(dets[:, :4], entry.boxes)
            if len(entry.boxes)
            else np.zeros((len(dets), 1))
        )
        keep = iou_inv.max(axis=1) <= np.maximum(
            iou_val.max(axis=1), iou_threshold
        )
        dets = dets[keep]
    return match_detections(dets[:, :4], dets[:, 4], entry.boxes, iou_threshold)


def evaluate_wider(
    detector: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
    images_root: str,
    gt_file: str,
    iou_threshold: float = 0.5,
    max_images: Optional[int] = None,
    progress_every: int = 0,
) -> Dict[str, float]:
    """Run `detector(image_bgr_u8) -> (dets (N,5), kps)` over a WIDER tree.

    Returns the ops/eval AP dict plus image/face counts.  Detections that
    best-overlap an invalid-marked GT are dropped before scoring (the
    official toolkit ignores those regions rather than counting false
    positives).
    """
    entries = parse_gt_file(gt_file)
    if max_images is not None:
        entries = entries[:max_images]
    evals: List[ImageEval] = []
    n_faces = 0
    for idx, entry in enumerate(entries):
        img_path = os.path.join(images_root, entry.rel_path)
        dets, _ = detector(read_image(img_path))
        evals.append(_score_entry(dets, entry, iou_threshold))
        n_faces += len(entry.boxes)
        if progress_every and (idx + 1) % progress_every == 0:
            print(f"  {idx + 1}/{len(entries)} images")
    res = average_precision(evals)
    res["num_images"] = float(len(entries))
    res["num_faces"] = float(n_faces)
    return res


def evaluate_wider_batched(
    detect_many: Callable,
    images_root: str,
    gt_file: str,
    iou_threshold: float = 0.5,
    max_images: Optional[int] = None,
    progress_every: int = 0,
) -> Dict[str, float]:
    """Batched variant of evaluate_wider.

    detect_many: callable taking a list of image PATHS and returning an
    iterator of (dets, kps) in order, e.g. the DetectionServer.detect_stream
    adapter of tools/eval_wider.py, which stages the next batch while this
    one is detected.
    Scoring semantics are identical to evaluate_wider.
    """
    entries = parse_gt_file(gt_file)
    if max_images is not None:
        entries = entries[:max_images]
    paths = [os.path.join(images_root, e.rel_path) for e in entries]
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    evals: List[ImageEval] = []
    n_faces = 0
    for idx, (entry, (dets, _)) in enumerate(zip(entries, detect_many(paths))):
        evals.append(_score_entry(dets, entry, iou_threshold))
        n_faces += len(entry.boxes)
        if progress_every and (idx + 1) % progress_every == 0:
            print(f"  {idx + 1}/{len(entries)} images")
    if len(evals) != len(entries):
        # zip() stops at the shorter iterator: a detect_many that ends
        # early must fail loudly, not score a silent prefix of the set.
        raise RuntimeError(
            f"detector yielded {len(evals)} results for {len(entries)} images"
        )
    res = average_precision(evals)
    res["num_images"] = float(len(entries))
    res["num_faces"] = float(n_faces)
    return res


def find_wider_root(candidates: Sequence[str] = ()) -> Optional[str]:
    """Locate a WIDER val tree in conventional places (the JAX package's
    list, in its order); None when absent."""
    default_candidates = [
        os.environ.get("WIDER_ROOT", ""),
        "/data/WIDER",
        "/root/data/WIDER",
        os.path.expanduser("~/WIDER"),
    ]
    for root in [*candidates, *default_candidates]:
        if not root:
            continue
        gt = os.path.join(root, "wider_face_split", "wider_face_val_bbx_gt.txt")
        imgs = os.path.join(root, "WIDER_val", "images")
        if os.path.exists(gt) and os.path.isdir(imgs):
            return root
    return None
