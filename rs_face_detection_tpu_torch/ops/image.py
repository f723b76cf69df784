"""Image preprocessing on the device: letterbox, normalize, warp, crops.

Counterpart of rs_face_detection_tpu/ops/image.py.  Images keep the JAX
package's channels-last layout, (H, W, C) or (B, H, W, C), so the pipeline's
public functions compare like with like; only the networks take NCHW.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import device_arrays, device_constant, to_device


def letterbox_geometry(
    src_h: int, src_w: int, dst_w: int, dst_h: int
) -> Tuple[int, int, float]:
    """(new_w, new_h, det_scale) of an aspect-preserving resize into
    (dst_h, dst_w), padded bottom/right; the new size truncates to int and
    det_scale = new_h / src_h."""
    im_ratio = src_h / src_w
    model_ratio = dst_h / dst_w
    if im_ratio > model_ratio:
        new_h = dst_h
        new_w = int(new_h / im_ratio)
    else:
        new_w = dst_w
        new_h = int(new_w * im_ratio)
    # Degenerate aspect ratios truncate to 0: clamp to one row/column.
    new_w = max(new_w, 1)
    new_h = max(new_h, 1)
    return new_w, new_h, new_h / src_h


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize (antialias off) of a (..., H, W, C) float
    image, the convention of jax.image.resize(method="linear",
    antialias=False) and OpenCV's INTER_LINEAR."""
    if img.shape[-3] == out_h and img.shape[-2] == out_w:
        return img
    lead = img.shape[:-3]
    x = img.reshape(-1, *img.shape[-3:]).permute(0, 3, 1, 2)
    y = F.interpolate(
        x, size=(out_h, out_w), mode="bilinear", align_corners=False, antialias=False
    )
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, img.shape[-1])


def letterbox(img_u8: torch.Tensor, dst_w: int, dst_h: int) -> Tuple[torch.Tensor, float]:
    """Letterbox an (H, W, 3) uint8 image to a (dst_h, dst_w, 3) float32
    image in [0, 255]; returns it with det_scale (a Python float)."""
    src_h, src_w = img_u8.shape[0], img_u8.shape[1]
    new_w, new_h, det_scale = letterbox_geometry(src_h, src_w, dst_w, dst_h)
    resized = resize_bilinear(img_u8.float(), new_h, new_w)
    padded = torch.zeros((dst_h, dst_w, 3), dtype=torch.float32, device=img_u8.device)
    padded[:new_h, :new_w] = resized
    return padded, det_scale


#: OpenCV's fixed-point resize: coefficients carry 11 fractional bits.
_COEF_BITS = 11


def _linear_taps(
    src: int, dst: int, columns: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV INTER_LINEAR taps of one axis: (i0, i1, c0, c1), source
    indices and 11-bit weights of each destination index.

    The arithmetic is cv::resize's for uint8: scale = 1 / (dst / src) in
    double, half-pixel source coordinate rounded to float, floor, the
    weights ``1 - f`` and ``f`` times 2048 rounded half to even.  Both axes
    clamp the source index into [0, src - 1]; OpenCV also resets the
    weights to (2048, 0) there for columns, but keeps them for rows.
    """
    scale = 1.0 / (dst / src)
    fx = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx)
    fx = (fx - sx).astype(np.float32)
    sx = sx.astype(np.int64)
    if columns:
        fx[(sx < 0) | (sx >= src - 1)] = 0.0
    sx0 = np.clip(sx, 0, src - 1)
    sx1 = np.clip(sx + 1, 0, src - 1)
    one = np.float32(1 << _COEF_BITS)
    c0 = np.round((np.float32(1.0) - fx) * one).astype(np.int32)
    c1 = np.round(fx * one).astype(np.int32)
    return sx0, sx1, c0, c1


def resize_u8_linear(img_u8: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)``
    on an (H, W, C) uint8 tensor, bit for bit, in integer ops on its device.

    A horizontal pass into int32, then OpenCV's vertical pass for uint8: each row is shifted right by 4, multiplied by
    its weight and shifted right by 16, the two are added and rounded with
    ``(v + 2) >> 2``.  An exact 2x downscale, which OpenCV takes as a 2x2
    area mean ``(sum + 2) >> 2``, comes out of the same arithmetic (weights
    1024, 1024).  tests/test_torch_letterbox.py holds it equal to cv2.
    At the input's own size it returns the input itself.
    """
    src_h, src_w = img_u8.shape[0], img_u8.shape[1]
    if (src_h, src_w) == (out_h, out_w):
        return img_u8
    x0, x1, a0, a1 = device_arrays(_linear_taps, (src_w, out_w, True), img_u8.device)
    y0, y1, b0, b1 = device_arrays(_linear_taps, (src_h, out_h, False), img_u8.device)

    def horizontal(rows: torch.Tensor) -> torch.Tensor:  # (out_h, W, C) -> (out_h, out_w, C)
        src = rows.to(torch.int32)
        return src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]

    top = ((horizontal(img_u8[y0]) >> 4) * b0[:, None, None]) >> 16
    bot = ((horizontal(img_u8[y1]) >> 4) * b1[:, None, None]) >> 16
    return ((top + bot + 2) >> 2).clamp(0, 255).to(torch.uint8)


def letterbox_u8_batch(
    images: Sequence, dst_w: int, dst_h: int, device: torch.device
) -> Tuple[torch.Tensor, List[float]]:
    """Letterbox (H, W, 3) uint8 images (numpy arrays or tensors) into one
    (n, dst_h, dst_w, 3) uint8 batch on `device`, each padded bottom/right
    with zeros; returns it with the n det_scales.

    Counterpart of rs_face_detection_tpu/parallel/serving.py::letterbox_host
    (OpenCV INTER_LINEAR on uint8) over a batch, on the device: every canvas
    is the same, bit for bit, so the batched paths see what the JAX ones
    see.  Each resized frame is written straight into its slot of the batch.
    A host frame bound for a CUDA device is uploaded from pinned memory
    without blocking, on the current stream (the caching host allocator
    keeps the pinned copy until the upload is done).
    """
    canvases = torch.zeros((len(images), dst_h, dst_w, 3), dtype=torch.uint8, device=device)
    scales = []
    for i, image in enumerate(images):
        frame = torch.from_numpy(np.ascontiguousarray(image)) if isinstance(image, np.ndarray) else image
        if device.type == "cuda" and frame.device.type == "cpu":
            frame = frame.pin_memory()
        frame = frame.to(device, non_blocking=True)
        new_w, new_h, det_scale = letterbox_geometry(frame.shape[0], frame.shape[1], dst_w, dst_h)
        canvases[i, :new_h, :new_w] = resize_u8_linear(frame, new_h, new_w)
        scales.append(det_scale)
    return canvases, scales


def letterbox_u8(img_u8: torch.Tensor, dst_w: int, dst_h: int) -> Tuple[torch.Tensor, float]:
    """Letterbox one (H, W, 3) uint8 image on its device: letterbox_u8_batch
    of one, as a (dst_h, dst_w, 3) canvas and its det_scale."""
    canvases, scales = letterbox_u8_batch([img_u8], dst_w, dst_h, img_u8.device)
    return canvases[0], scales[0]


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C), channel k = (bi*b + bj)*C + c.

    Counterpart of rs_face_detection_tpu/models/layers.py::space_to_depth.
    """
    b, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"space_to_depth needs H, W divisible by {block}, got {tuple(x.shape)}")
    x = x.reshape(b, h // block, block, w // block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def s2d_layout(imgs_bgr_u8: torch.Tensor) -> torch.Tensor:
    """2x2 space-to-depth of (B, H, W, 3) uint8 frames on their device:
    (B, H/2, W/2, 12), channel k = (bi*2 + bj)*3 + c with c in BGR order.
    Counterpart of rs_face_detection_tpu/ops/image.py::s2d_layout_host."""
    if imgs_bgr_u8.dim() != 4 or imgs_bgr_u8.shape[-1] != 3:
        raise ValueError(f"s2d_layout needs (B, H, W, 3), got {tuple(imgs_bgr_u8.shape)}")
    return space_to_depth(imgs_bgr_u8, 2).contiguous()


#: s2d channel k = block*3 + c: reversing c within each block is BGR <-> RGB.
S2D_FLIP = (2, 1, 0, 5, 4, 3, 8, 7, 6, 11, 10, 9)


def s2d_stem_input(imgs_bgr_u8: torch.Tensor, mean, scale) -> torch.Tensor:
    """BGR->RGB + 2x2 space-to-depth + normalize on (B, H, W, 3) uint8
    frames: the (B, H/2, W/2, 12) float32 RGB stem input of the s2d
    ResNet-50, with per-channel RGB mean and scale (three floats each).

    Counterpart of rs_face_detection_tpu/ops/image.py::s2d_stem_input on
    its default layout and with no post-division (the port has no caller
    of either option), in the same f32 op order: ``(float(px) - mean) *
    scale``.  ops/stem.py::fused_stem_plain computes these values in the
    frame's BGR channel order, the order of the folded stem constants.
    """
    x = s2d_layout(imgs_bgr_u8)[..., list(S2D_FLIP)]
    mean12 = device_constant(tuple(mean) * 4, torch.float32, x.device)
    scale12 = device_constant(tuple(scale) * 4, torch.float32, x.device)
    return (x.float() - mean12) * scale12


def bgr_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """Reverse the channel axis of an (..., 3) image."""
    return img.flip(-1)


def normalize(
    img: torch.Tensor, mean: Sequence[float], scale: Sequence[float]
) -> torch.Tensor:
    """Per-channel (px - mean) * scale on an (..., 3) float image."""
    return (img - device_constant(mean, img.dtype, img.device)) * device_constant(scale, img.dtype, img.device)


def crops_to_nchw(
    imgs_bgr: Sequence[np.ndarray], size: Tuple[int, int], mean, scale, device: torch.device
) -> torch.Tensor:
    """A staged head's input: same-shaped (h, w, 3) BGR crops -> resize to
    ``size`` (w, h) -> BGR->RGB -> (px - mean) * scale, as a float32 NCHW
    batch on ``device`` (the JAX modules' order of the three steps)."""
    out_w, out_h = size
    x = to_device(np.stack(imgs_bgr), device).float()
    x = normalize(bgr_to_rgb(resize_bilinear(x, out_h, out_w)), mean, scale)
    return x.permute(0, 3, 1, 2).contiguous()


def warp_affine(
    imgs: torch.Tensor, matrices: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """Affine-warp (B, H, W, C) float images by (B, 2, 3) src->dst matrices.

    Every output pixel p samples the source at M^-1 p bilinearly, with a
    constant-zero border and OpenCV's integer pixel centres: a direct gather,
    not grid_sample, whose normalised coordinates have other edge rules.
    """
    a = matrices[:, :, :2]
    t = matrices[:, :, 2]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    inv_det = 1.0 / det
    a_inv = (
        torch.stack(
            [
                torch.stack([a[:, 1, 1], -a[:, 0, 1]], dim=-1),
                torch.stack([-a[:, 1, 0], a[:, 0, 0]], dim=-1),
            ],
            dim=1,
        )
        * inv_det[:, None, None]
    )
    t_inv = -(a_inv @ t[:, :, None])[:, :, 0]

    ys = torch.arange(out_h, dtype=imgs.dtype, device=imgs.device)
    xs = torch.arange(out_w, dtype=imgs.dtype, device=imgs.device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")  # (out_h, out_w)

    def coord(row: int) -> torch.Tensor:
        return (
            a_inv[:, row, 0, None, None] * grid_x
            + a_inv[:, row, 1, None, None] * grid_y
            + t_inv[:, row, None, None]
        )

    return _bilinear_sample(imgs, coord(0), coord(1))


def _bilinear_sample(
    imgs: torch.Tensor, src_x: torch.Tensor, src_y: torch.Tensor
) -> torch.Tensor:
    """Sample (B, H, W, C) at (B, h, w) float coords, constant-zero border."""
    b, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    wx = (src_x - x0)[..., None]
    wy = (src_y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    bidx = torch.arange(b, device=imgs.device)[:, None, None]

    def gather(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = imgs[bidx, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(inside[..., None], vals, torch.zeros_like(vals))

    top = gather(y0i, x0i) * (1.0 - wx) + gather(y0i, x0i + 1) * wx
    bot = gather(y0i + 1, x0i) * (1.0 - wx) + gather(y0i + 1, x0i + 1) * wx
    return top * (1.0 - wy) + bot * wy


def crop_resize(
    img: torch.Tensor, box_xyxy: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """Crop an (H, W, C) float image to an inclusive-corner (4,) box and
    resize it to (out_h, out_w, C) with half-pixel bilinear sampling."""
    return crop_resize_batch(img[None], box_xyxy[None], out_h, out_w)[0]


def crop_resize_batch(
    imgs: torch.Tensor, boxes_xyxy: torch.Tensor, out_h: int, out_w: int
) -> torch.Tensor:
    """crop_resize of each (H, W, C) float image of a batch by its own
    inclusive-corner box: (B, H, W, C) and (B, 4) -> (B, out_h, out_w, C),
    the same f32 arithmetic per image (JAX vmaps crop_resize)."""
    x1, y1, x2, y2 = (t[:, None] for t in boxes_xyxy.unbind(1))
    sx = (x2 - x1 + 1.0) / out_w
    sy = (y2 - y1 + 1.0) / out_h
    xs = (torch.arange(out_w, dtype=imgs.dtype, device=imgs.device) + 0.5) * sx - 0.5 + x1
    ys = (torch.arange(out_h, dtype=imgs.dtype, device=imgs.device) + 0.5) * sy - 0.5 + y1
    grid_x = xs[:, None, :].expand(-1, out_h, -1)
    grid_y = ys[:, :, None].expand(-1, -1, out_w)
    return _bilinear_sample(imgs, grid_x, grid_y)
