"""Official WIDER FACE easy/medium/hard evaluation protocol (host numpy).

The port's copy of rs_face_detection_tpu/ops/wider_split.py, on
``scipy.io.loadmat``.  The MATLAB side files of the official eval_tools
(``wider_face_val.mat``, ``wider_{easy,medium,hard}_val.mat``) name, per
event and image, which ground-truth faces COUNT for each difficulty; the
rest are ignore regions.  Per difficulty:

  1. all detection scores are min-max normalized over the WHOLE prediction
     set (``norm_scores``);
  2. per image, predictions sorted by descending score greedily match their
     max-IoU ground truth at IoU >= 0.5; matching a face that is NOT in the
     difficulty's keep list marks the face and the prediction ignored
     (neither TP nor FP); matching a kept, unmatched face is a TP;
  3. a 1000-point threshold sweep accumulates (proposals, recalled) over
     images; precision = recalled / proposals, recall = recalled / kept
     faces; AP is the all-points (monotone envelope) integral.

``evaluate_predictions`` scores every difficulty from ONE prediction dict,
so the detector sweep (tools/eval_wider.py runs it through the batched
``DetectionServer`` stream) happens once.  tests/test_torch_wider.py holds
every function equal to JAX's on ``.mat`` files in the official cell layout.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..pipeline.tracking import iou_matrix_np

DIFFICULTIES = ("easy", "medium", "hard")


# ---------------------------------------------------------------------------
# .mat parsing (official cell-array layout via scipy.io.loadmat)
# ---------------------------------------------------------------------------


def _unwrap(obj):
    """Drill through loadmat's nested (1,1)/(N,1) object arrays."""
    while isinstance(obj, np.ndarray) and obj.dtype == object and obj.size == 1:
        obj = obj.reshape(-1)[0]
    return obj


def _unwrap_str(obj) -> str:
    obj = _unwrap(obj)
    if isinstance(obj, np.ndarray):
        if obj.size == 0:
            return ""
        obj = obj.reshape(-1)[0]
    return str(obj)


def _cell_list(obj) -> List:
    """A MATLAB cell column -> python list of unwrapped entries.

    A singleton cell collapses under _unwrap into its payload (char array,
    numeric matrix, ...) — that payload is ONE entry, not something to
    iterate, so only object-dtype arrays are treated as cell containers.
    """
    obj = _unwrap(obj)
    if isinstance(obj, np.ndarray) and obj.dtype == object:
        return [_unwrap(x) for x in obj.reshape(-1)]
    return [obj]


def _outer_cells(obj) -> List:
    """Top-level per-EVENT cell -> list of per-event payloads, WITHOUT
    collapsing a single-event (1,1) cell.

    _cell_list's unwrap would drill a 1-event file_list straight into its
    inner per-image cell and return the M image entries as if they were M
    events (silently evaluating only the first image).  Top-level lists
    must therefore iterate the outer object array as-is.
    """
    obj = np.asarray(obj)
    if obj.dtype == object:
        return list(obj.reshape(-1))
    return [obj]


def load_gt_mat(path: str) -> Dict[str, np.ndarray]:
    """Parse wider_face_val.mat -> {'event/img_stem': (N, 4) x1y1x2y2 boxes}.

    The mat stores [x y w h]; the official eval_tools (evaluation step)
    converts with x2 = x + w, y2 = y + h — NOT the inclusive x+w-1 — and
    then computes overlaps with the +1 area convention, so GT areas score
    as (w+1)(h+1).  Replicated exactly here (iou_matrix_np carries the +1);
    detector corner predictions pass through unchanged, matching the
    official chain where submissions store [x1 y1 x2-x1 y2-y1] and the
    scorer re-adds the corners.  (ops/wider.parse_gt_file — the simplified
    non-official protocol — differs deliberately.)
    """
    from scipy.io import loadmat

    f = loadmat(path)
    events = [_unwrap_str(e) for e in _outer_cells(f["event_list"])]
    file_list = _outer_cells(f["file_list"])
    bbx_list = _outer_cells(f["face_bbx_list"])
    gt: Dict[str, np.ndarray] = {}
    for event, files, bbxs in zip(events, file_list, bbx_list):
        names = [_unwrap_str(x) for x in _cell_list(files)]
        boxes = _cell_list(bbxs)
        for name, b in zip(names, boxes):
            b = np.asarray(b, np.float32).reshape(-1, 4)
            out = b.copy()
            out[:, 2] = b[:, 0] + b[:, 2]
            out[:, 3] = b[:, 1] + b[:, 3]
            gt[f"{event}/{name}"] = out
    return gt


def load_split_mat(path: str) -> Dict[str, np.ndarray]:
    """Parse wider_<difficulty>_val.mat -> {'event/img_stem': keep indices}.

    Indices are converted from MATLAB 1-based to 0-based rows into the GT
    box array for that image.  An empty cell means no face counts for this
    difficulty (all are ignore regions).
    """
    from scipy.io import loadmat

    f = loadmat(path)
    if "event_list" not in f:
        # A synthesized event name could never match load_gt_mat's
        # 'event/img' keys — every image would silently score 0.0.
        raise ValueError(
            f"{path}: no event_list variable; cannot align keep indices "
            "with the GT mat's event/img keys"
        )
    events = [_unwrap_str(e) for e in _outer_cells(f["event_list"])]
    file_list = _outer_cells(f["file_list"])
    gt_list = _outer_cells(f["gt_list"])
    keep: Dict[str, np.ndarray] = {}
    for event, files, gts in zip(events, file_list, gt_list):
        names = [_unwrap_str(x) for x in _cell_list(files)]
        idx_cells = _cell_list(gts)
        for name, idx in zip(names, idx_cells):
            idx = np.asarray(idx, np.float32).reshape(-1)
            keep[f"{event}/{name}"] = idx.astype(np.int64) - 1
    return keep


# ---------------------------------------------------------------------------
# the evaluation protocol
# ---------------------------------------------------------------------------


def norm_scores(
    predictions: Mapping[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Min-max normalize scores globally across the whole prediction set."""
    all_scores = np.concatenate(
        [np.asarray(p, np.float32).reshape(-1, 5)[:, 4] for p in predictions.values()]
        or [np.zeros(0, np.float32)]
    )
    if all_scores.size == 0:
        return {k: np.asarray(v, np.float32).reshape(-1, 5) for k, v in predictions.items()}
    lo, hi = float(all_scores.min()), float(all_scores.max())
    span = max(hi - lo, 1e-12)
    out = {}
    for k, p in predictions.items():
        p = np.asarray(p, np.float32).reshape(-1, 5).copy()
        p[:, 4] = (p[:, 4] - lo) / span
        out[k] = p
    return out


def image_eval(
    pred: np.ndarray,
    gt: np.ndarray,
    keep_mask: np.ndarray,
    iou_threshold: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image greedy matching with ignore semantics.

    pred: (D, 5) x1y1x2y2+score sorted by DESCENDING score.
    Returns (pred_recall (D,), proposal (D,)): pred_recall[h] = kept faces
    recalled by predictions 0..h; proposal[h] = 1 if prediction h counts as
    a proposal (unmatched or TP), -1 if it hit an ignore region.
    """
    pred = np.asarray(pred, np.float32).reshape(-1, 5)
    gt = np.asarray(gt, np.float32).reshape(-1, 4)
    keep_mask = np.asarray(keep_mask, bool).reshape(-1)
    d = pred.shape[0]
    pred_recall = np.zeros(d, np.int64)
    proposal = np.ones(d, np.int64)
    if d == 0:
        return pred_recall, proposal
    if gt.shape[0] == 0:
        return pred_recall, proposal
    overlaps = iou_matrix_np(pred[:, :4], gt)  # (D, G)
    recall_state = np.zeros(gt.shape[0], np.int64)  # 0 unseen, 1 TP, -1 ignored
    recalled = 0
    for h in range(d):
        g = int(np.argmax(overlaps[h]))
        if overlaps[h, g] >= iou_threshold:
            if not keep_mask[g]:
                recall_state[g] = -1
                proposal[h] = -1
            elif recall_state[g] == 0:
                recall_state[g] = 1
                recalled += 1
        pred_recall[h] = recalled
    return pred_recall, proposal


def _threshold_curve(
    pred_scores: np.ndarray,
    pred_recall: np.ndarray,
    proposal: np.ndarray,
    thresh_num: int,
) -> np.ndarray:
    """Per-image (thresh_num, 2) [proposals, recalled] sweep.

    pred_scores must be sorted descending (image_eval's order).
    """
    info = np.zeros((thresh_num, 2), np.float64)
    if pred_scores.size == 0:
        return info
    for t in range(thresh_num):
        thresh = 1.0 - (t + 1) / thresh_num
        above = np.where(pred_scores >= thresh)[0]
        if above.size == 0:
            continue
        r = int(above[-1])
        info[t, 0] = float(np.count_nonzero(proposal[: r + 1] == 1))
        info[t, 1] = float(pred_recall[r])
    return info


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-points interpolated AP (monotone precision envelope)."""
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    for i in range(p.size - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def evaluate_predictions(
    predictions: Mapping[str, np.ndarray],
    gt: Mapping[str, np.ndarray],
    splits: Mapping[str, Mapping[str, np.ndarray]],
    iou_threshold: float = 0.5,
    thresh_num: int = 1000,
) -> Dict[str, Dict[str, float]]:
    """Official per-difficulty AP from one prediction set.

    predictions: {'event/img_stem': (N, 5) x1y1x2y2+score} (any order; an
      image missing from the dict counts as zero detections).
    gt: load_gt_mat output.  splits: {difficulty: load_split_mat output}.
    """
    preds = norm_scores(predictions)
    results: Dict[str, Dict[str, float]] = {}
    for difficulty, keep in splits.items():
        curve = np.zeros((thresh_num, 2), np.float64)
        count_face = 0
        for key, boxes in gt.items():
            keep_idx = keep.get(key)
            if keep_idx is None:
                continue
            if boxes.shape[0] == 0:
                # Official protocol: images with no GT are skipped entirely
                # (eval_tools' `if isempty ... continue`) — their detections
                # do NOT count as false positives.
                continue
            keep_mask = np.zeros(boxes.shape[0], bool)
            valid = keep_idx[(keep_idx >= 0) & (keep_idx < boxes.shape[0])]
            keep_mask[valid] = True
            count_face += int(keep_mask.sum())
            p = preds.get(key)
            if p is None or p.shape[0] == 0:
                continue
            p = p[np.argsort(-p[:, 4], kind="stable")]
            pred_recall, proposal = image_eval(
                p, boxes, keep_mask, iou_threshold
            )
            curve += _threshold_curve(p[:, 4], pred_recall, proposal, thresh_num)
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = np.where(curve[:, 0] > 0, curve[:, 1] / curve[:, 0], 0.0)
            recall = curve[:, 1] / max(count_face, 1)
        results[difficulty] = {
            "ap": voc_ap(recall, precision),
            "num_kept_faces": float(count_face),
        }
    return results


# ---------------------------------------------------------------------------
# split-file discovery + the end-to-end runner
# ---------------------------------------------------------------------------


def find_split_mats(split_dir: str) -> Dict[str, str]:
    """Locate wider_{easy,medium,hard}_val.mat under a wider_face_split dir."""
    out = {}
    for difficulty in DIFFICULTIES:
        p = os.path.join(split_dir, f"wider_{difficulty}_val.mat")
        if os.path.exists(p):
            out[difficulty] = p
    return out


def collect_predictions(
    detect_many,
    images_root: str,
    keys: Sequence[str],
    progress_every: int = 0,
    ext: str = ".jpg",
) -> Dict[str, np.ndarray]:
    """Run a batched detector over the GT image list.

    detect_many: callable taking an iterable of image paths and returning an
    iterator of (dets (N, >=5), kps) in order — e.g. the
    DetectionServer-backed runner in tools/eval_wider.py.  Single-image
    detectors adapt trivially:
    ``lambda paths: (det(ops.wider.read_image(p)) for p in paths)``.
    """
    paths = [os.path.join(images_root, f"{k}{ext}") for k in keys]
    predictions: Dict[str, np.ndarray] = {}
    for i, (key, (dets, _)) in enumerate(zip(keys, detect_many(paths))):
        dets = np.asarray(dets, np.float32)
        predictions[key] = dets.reshape(
            -1, dets.shape[-1] if dets.size else 5
        )[:, :5]
        if progress_every and (i + 1) % progress_every == 0:
            print(f"  {i + 1}/{len(keys)} images")
    return predictions


def dump_predictions(
    predictions: Mapping[str, np.ndarray], out_dir: str
) -> int:
    """Write predictions as an official WIDER submission tree.

    One `<out_dir>/<event>/<image>.txt` per image, in the format the
    published eval_tools (and its widely-used Python port,
    widerface_evaluate) consume:

        <image stem>
        <n_boxes>
        x y w h score        # one per box

    Corner boxes convert with the official +1 convention (w = x2-x1+1 —
    the same one the reference's NMS areas use, processing/nms.rs:39-58),
    which the scorer undoes when it re-adds the corners.  Keys are the
    GT-relative "<event>/<image>" paths.  Returns the number of files
    written, so callers can assert coverage."""
    written = 0
    for key, dets in predictions.items():
        dets = np.asarray(dets, np.float32)
        dets = (
            dets.reshape(-1, dets.shape[-1])[:, :5]
            if dets.size
            else np.zeros((0, 5), np.float32)
        )
        path = os.path.join(out_dir, f"{key}.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(f"{os.path.basename(key)}\n{len(dets)}\n")
            for x1, y1, x2, y2, score in dets:
                f.write(
                    f"{x1:.3f} {y1:.3f} {x2 - x1 + 1:.3f} "
                    f"{y2 - y1 + 1:.3f} {score:.6f}\n"
                )
        written += 1
    return written


def load_dumped_predictions(in_dir: str) -> Dict[str, np.ndarray]:
    """Read a dump_predictions tree back to corner-box arrays (the inverse,
    also reads third-party submission trees in the official format)."""
    predictions: Dict[str, np.ndarray] = {}
    for event in sorted(os.listdir(in_dir)):
        event_dir = os.path.join(in_dir, event)
        if not os.path.isdir(event_dir):
            continue
        for fn in sorted(os.listdir(event_dir)):
            if not fn.endswith(".txt"):
                continue
            with open(os.path.join(event_dir, fn)) as f:
                lines = f.read().splitlines()
            n = int(lines[1]) if len(lines) > 1 else 0
            rows = np.zeros((n, 5), np.float32)
            for i, line in enumerate(lines[2 : 2 + n]):
                x, y, w, h, s = (float(v) for v in line.split())
                rows[i] = (x, y, x + w - 1.0, y + h - 1.0, s)
            predictions[f"{event}/{fn[:-4]}"] = rows
    return predictions


def evaluate_wider_official(
    detect_many,
    images_root: str,
    gt_mat: str,
    split_mats: Mapping[str, str],
    iou_threshold: float = 0.5,
    max_images: Optional[int] = None,
    progress_every: int = 0,
    dump_dir: Optional[str] = None,
) -> Dict[str, Dict[str, float]]:
    """End to end: detect every GT image once, score all difficulties.

    dump_dir: also write the predictions as an official submission tree
    (dump_predictions) so the external eval_tools / widerface_evaluate
    scorers can be run on the same sweep."""
    gt = load_gt_mat(gt_mat)
    keys = sorted(gt)
    if max_images is not None:
        keys = keys[:max_images]
        gt = {k: gt[k] for k in keys}
    splits = {d: load_split_mat(p) for d, p in split_mats.items()}
    predictions = collect_predictions(
        detect_many, images_root, keys, progress_every=progress_every
    )
    if dump_dir is not None:
        dump_predictions(predictions, dump_dir)
    return evaluate_predictions(predictions, gt, splits, iou_threshold)
