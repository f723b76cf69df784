"""Faster-R-CNN-style anchor enumeration and FPN anchor planes (numpy).

The port's own copy of rs_face_detection_tpu/ops/anchors.py (that module
sits under a package ``__init__`` that imports JAX).  Same math, including
the Rust-style half-away-from-zero rounding; tests/test_torch_ops.py holds
the table equal to the original's.  Init-time host precompute: the detector
uploads the table to its device once.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple

import numpy as np

from ..configs import AnchorConfig


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """Round half away from zero (Rust f32::round), not numpy's half-to-even."""
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def _whctrs(anchor: np.ndarray):
    w = anchor[2] - anchor[0] + 1.0
    h = anchor[3] - anchor[1] + 1.0
    return w, h, anchor[0] + 0.5 * (w - 1.0), anchor[1] + 0.5 * (h - 1.0)


def _mkanchors(ws, hs, x_ctr, y_ctr) -> np.ndarray:
    ws = np.asarray(ws, dtype=np.float32)
    hs = np.asarray(hs, dtype=np.float32)
    return np.stack(
        [
            x_ctr - 0.5 * (ws - 1.0),
            y_ctr - 0.5 * (hs - 1.0),
            x_ctr + 0.5 * (ws - 1.0),
            y_ctr + 0.5 * (hs - 1.0),
        ],
        axis=1,
    ).astype(np.float32)


def generate_anchors(
    base_size: int,
    ratios: Sequence[float],
    scales: Sequence[float],
    stride: int = 16,
    dense_anchor: bool = False,
) -> np.ndarray:
    """(A, 4) base anchors of one FPN level: ratio then scale enumeration."""
    base = np.array([1.0, 1.0, float(base_size), float(base_size)], np.float32) - 1.0
    w, h, x_ctr, y_ctr = _whctrs(base)
    ratios = np.asarray(ratios, dtype=np.float32)
    ws = _round_half_away(np.sqrt(w * h / ratios))
    ratio_anchors = _mkanchors(ws, ws * ratios, x_ctr, y_ctr)
    scales = np.asarray(scales, dtype=np.float32)
    per_ratio = []
    for anchor in ratio_anchors:
        w, h, x_ctr, y_ctr = _whctrs(anchor)
        per_ratio.append(_mkanchors(w * scales, h * scales, x_ctr, y_ctr))
    anchors = np.concatenate(per_ratio, axis=0)
    if dense_anchor:
        if stride % 2:
            raise ValueError(f"dense anchors need an even stride, got {stride}")
        anchors = np.concatenate([anchors, anchors + stride / 2.0], axis=0)
    return anchors.astype(np.float32)


def anchor_plane(
    height: int, width: int, stride: int, base_anchors: np.ndarray
) -> np.ndarray:
    """Tile base anchors over an H x W grid -> (H*W*A, 4) in (h, w, a) order."""
    a = base_anchors.shape[0]
    shift_x = (np.arange(width, dtype=np.float32) * stride)[None, :, None]
    shift_y = (np.arange(height, dtype=np.float32) * stride)[:, None, None]
    plane = np.zeros((height, width, a, 4), dtype=np.float32)
    plane[..., 0] = base_anchors[None, None, :, 0] + shift_x
    plane[..., 1] = base_anchors[None, None, :, 1] + shift_y
    plane[..., 2] = base_anchors[None, None, :, 2] + shift_x
    plane[..., 3] = base_anchors[None, None, :, 3] + shift_y
    return plane.reshape(height * width * a, 4)


def full_anchor_table(
    image_size: Tuple[int, int],
    anchor_cfg: Mapping[int, AnchorConfig],
    feat_strides: Sequence[int] = (32, 16, 8),
    dense_anchor: bool = False,
) -> Tuple[np.ndarray, List[Tuple[int, int, int, int]]]:
    """(anchors (total, 4) f32, [(stride, feat_h, feat_w, A)]) for a
    (width, height) detector input; rows concatenate in `feat_strides` order.
    640x640 with strides (32, 16, 8) and 2 anchors gives 16,800 rows."""
    width, height = image_size
    tables, level_info = [], []
    for stride in feat_strides:
        cfg = anchor_cfg[stride]
        base = generate_anchors(
            cfg.base_size, cfg.ratios, cfg.scales, stride, dense_anchor
        )
        fh = -(-height // stride)
        fw = -(-width // stride)
        tables.append(anchor_plane(fh, fw, stride, base))
        level_info.append((stride, fh, fw, base.shape[0]))
    return np.concatenate(tables, axis=0), level_info


def scrfd_anchor_centers(
    image_size: Tuple[int, int], num_anchors: int = 2
) -> Tuple[np.ndarray, List[Tuple[int, int, int, int]]]:
    """SCRFD anchor centers (total, 2) f32 and [(stride, h, w, A)] for a
    (width, height) detector input: (x*stride, y*stride), repeated per
    anchor, flattened in (h, w, a) order to match the head maps.

    Copy of rs_face_detection_tpu/pipeline/ekyc_pipeline.py::
    scrfd_anchor_centers.
    """
    width, height = image_size
    centers, levels = [], []
    for s in (8, 16, 32):
        fh, fw = -(-height // s), -(-width // s)
        grid = np.zeros((fh, fw, num_anchors, 2), np.float32)
        grid[..., 0] = (np.arange(fw, dtype=np.float32) * s)[None, :, None]
        grid[..., 1] = (np.arange(fh, dtype=np.float32) * s)[:, None, None]
        centers.append(grid.reshape(-1, 2))
        levels.append((s, fh, fw, num_anchors))
    return np.concatenate(centers), levels
