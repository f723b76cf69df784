"""The plain reference of face-ID extraction: JPEG bytes to the answer.

Follows a configuration file (benchmark/configs/) and nothing of the
program under test: OpenCV decodes the JPEG and letterboxes it (INTER_LINEAR
on uint8, padded bottom and right, the reference crate's geometry), the
networks of models.py run in float32 on the device, and numpy does the rest
on the host: the anchor table (insightface RetinaFace "+1" anchors), the
confidence filter and a stable top-k, the box and landmark decode, greedy
NMS, the selection rules of the reference crate, Umeyama's similarity, the
warp from the letterboxed canvas (exact bilinear, zero border, the matrix
inverted in float64), both heads and the quality demotion.

Beside each answer it gives the margins of its discrete decisions.  Each
candidate's score is known only to an interval: the float32 scores of its
class logits with their difference moved by ``logit`` either way.  An image
whose answer could change within those intervals (a candidate whose
interval meets the confidence threshold or the top-k cut and that no kept
box robustly suppresses; two overlapping candidates, one of them kept,
whose intervals meet, unless both are the same single value, which ties
the same way on both sides), within ``iou`` of the NMS threshold (widened
by what moving each box delta by ``delta`` could change the IoU), or if a kept
box moved by ``px`` pixels across a selection rule, is ``ambiguous``:
float32 rounding alone may decide it, so it is not judged.  Quality classes
within ``prob`` of a tie are ``quality_ambiguous``.  The margins are the
limits file's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .models import build


def letterbox(img: np.ndarray, dst_w: int, dst_h: int):
    """(canvas (dst_h, dst_w, 3) uint8, det_scale): resize keeping the aspect,
    new size truncated to int, det_scale = new_h / h."""
    import cv2

    h, w = img.shape[:2]
    if h / w > dst_h / dst_w:
        new_h, new_w = dst_h, int(dst_h / (h / w))
    else:
        new_w, new_h = dst_w, int(dst_w * (h / w))
    new_w, new_h = max(new_w, 1), max(new_h, 1)
    canvas = np.zeros((dst_h, dst_w, 3), np.uint8)
    canvas[:new_h, :new_w] = img if (new_h, new_w) == (h, w) else cv2.resize(
        img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    return canvas, new_h / h


def anchor_table(image_size, strides, anchors: Dict[str, dict]) -> np.ndarray:
    """(N, 4) float32 anchors, strides in the given order, rows (h, w, a)."""
    width, height = image_size
    out = []
    for stride in strides:
        a = anchors[str(stride)]
        base = float(a["base_size"])
        w = h = base  # the base box [0, 0, base-1, base-1]
        cx = cy = 0.5 * (base - 1.0)
        rows = []
        for ratio in a["ratios"]:
            ws = np.sign(np.sqrt(w * h / ratio)) * np.floor(abs(np.sqrt(w * h / ratio)) + 0.5)
            hs = ws * ratio
            for s in a["scales"]:
                sw, sh = ws * s, hs * s
                rows.append([cx - 0.5 * (sw - 1), cy - 0.5 * (sh - 1), cx + 0.5 * (sw - 1), cy + 0.5 * (sh - 1)])
        base_rows = np.asarray(rows, np.float32)
        fh, fw = -(-height // stride), -(-width // stride)
        sy, sx = np.meshgrid(np.arange(fh, dtype=np.float32) * stride, np.arange(fw, dtype=np.float32) * stride,
                             indexing="ij")
        shift = np.stack([sx, sy, sx, sy], -1)[:, :, None, :]
        out.append((base_rows[None, None] + shift).reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of (4,) box a against (n, 4) boxes b, "+1" areas, float32."""
    one = np.float32(1.0)
    iw = np.maximum(np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]) + one, np.float32(0))
    ih = np.maximum(np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]) + one, np.float32(0))
    inter = iw * ih
    area_a = (a[2] - a[0] + one) * (a[3] - a[1] + one)
    area_b = (b[:, 2] - b[:, 0] + one) * (b[:, 3] - b[:, 1] + one)
    with np.errstate(invalid="ignore", divide="ignore"):  # degenerate boxes: NaN, as on the program's side
        return inter / (area_a + area_b - inter)


def decode(anchors: np.ndarray, deltas: np.ndarray, lms: np.ndarray, width: int, height: int):
    """Boxes (n, 4) clipped to the frame and landmarks (n, 5, 2), float32."""
    one, half = np.float32(1.0), np.float32(0.5)
    w = anchors[:, 2] - anchors[:, 0] + one
    h = anchors[:, 3] - anchors[:, 1] + one
    cx = anchors[:, 0] + half * (w - one)
    cy = anchors[:, 1] + half * (h - one)
    pcx, pcy = deltas[:, 0] * w + cx, deltas[:, 1] * h + cy
    pw, ph = np.exp(deltas[:, 2]) * w, np.exp(deltas[:, 3]) * h
    boxes = np.stack([pcx - half * (pw - one), pcy - half * (ph - one), pcx + half * (pw - one),
                      pcy + half * (ph - one)], -1).astype(np.float32)
    bound = np.array([width - 1, height - 1, width - 1, height - 1], np.float32)
    boxes = np.minimum(np.maximum(boxes, np.float32(0)), bound)
    l = lms.reshape(-1, 5, 2)
    land = np.stack([l[..., 0] * w[:, None] + cx[:, None], l[..., 1] * h[:, None] + cy[:, None]], -1)
    return boxes, land.astype(np.float32)


def umeyama(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity [[a, -b, tx], [b, a, ty]] mapping src to dst
    (float64 normal equations), as float32."""
    src, dst = src.astype(np.float64), dst.astype(np.float64)
    ms, md = src.mean(0), dst.mean(0)
    s, d = src - ms, dst - md
    den = max((s ** 2).sum(), 1e-12)
    a = (s * d).sum() / den
    b = (s[:, 0] * d[:, 1] - s[:, 1] * d[:, 0]).sum() / den
    rot = np.array([[a, -b], [b, a]])
    return np.concatenate([rot, (md - rot @ ms)[:, None]], 1).astype(np.float32)


class Reference:
    """The configuration's pipeline from the shared weights, in float32 (TF32
    as the caller has set it: the control runs this with TF32 on)."""

    def __init__(self, cfg: dict, states: Dict[str, dict], margins: dict, device: torch.device, block: int = 16):
        self.cfg, self.margins, self.device, self.block = cfg, margins, device, block
        self.nets = {}
        for part in ("detector", "quality", "identification"):
            net = build(cfg[part])
            net.load_state_dict({k: v.to(device) for k, v in states[part].items()}, strict=True)
            self.nets[part] = net.to(device).eval()
        d = cfg["detector"]
        self.anchors = anchor_table(d["image_size"], d["feat_strides"], d["anchors"])

    # -- detection -------------------------------------------------------------

    def _raw(self, canvases: np.ndarray):
        """Scores (3, B, N) (the score, then its interval's ends), box deltas
        (B, N, 4), landmark deltas (B, N, 10)."""
        d = self.cfg["detector"]
        x = torch.from_numpy(canvases).to(self.device).float().flip(-1)
        mean = torch.tensor(d["pixel_means"], device=self.device)
        std = torch.tensor(d["pixel_stds"], device=self.device)
        x = ((x / d["pixel_scale"] - mean) / std).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            out = self.nets["detector"](x)
        levels = [out[s] for s in d["feat_strides"]]
        logits = torch.cat([lv[0] for lv in levels], 1)
        shift = torch.tensor([0.0, self.margins["logit"]], device=self.device)
        scores = torch.stack([torch.softmax(logits, -1)[..., 1], torch.softmax(logits - shift, -1)[..., 1],
                              torch.softmax(logits + shift, -1)[..., 1]])
        return (scores.cpu().numpy(), torch.cat([lv[1] for lv in levels], 1).cpu().numpy(),
                torch.cat([lv[2] for lv in levels], 1).cpu().numpy())

    def _detect_one(self, score3, deltas, lms, det_scale):
        """Detections in image pixels and whether an f32 rounding could flip them."""
        d, mg = self.cfg["detector"], self.margins
        width, height = d["image_size"]
        thr, iou_thr, k = np.float32(d["confidence_threshold"]), d["iou_threshold"], d["max_candidates"]
        di = mg["iou"]
        scores, s_lo, s_hi = score3
        masked = np.where(scores >= thr, scores, -np.inf).astype(np.float32)
        order = np.argsort(-masked, kind="stable")[:k]
        valid = np.isfinite(masked[order])
        cand = order[valid]
        boxes, land = decode(self.anchors[cand], deltas[cand], lms[cand], width, height)
        s, lo, hi = scores[cand], s_lo[cand], s_hi[cand]
        point = lo == hi
        keep = np.zeros(len(cand), bool)
        suppressed = np.zeros(len(cand), bool)
        ambiguous = ""
        # how far a box delta moved by ``delta`` moves a corner, over the box's side
        reach = mg["delta"] * self._reach(cand, boxes)
        for i in range(len(cand)):
            if suppressed[i]:
                continue
            keep[i] = True
            ov = iou(boxes[i], boxes[i + 1:])
            suppressed[i + 1:] |= ov > iou_thr
            later = slice(i + 1, None)
            # an IoU within its margin of the threshold (``iou``, plus what a
            # shift of ``px`` in each corner could move it), or an
            # overlapping near tie in order
            margin = di + 4.0 * np.maximum(reach[i], reach[later])
            if np.any(np.abs(ov - iou_thr) < margin):
                ambiguous = ambiguous or "nms_iou"
            meet = (lo[later] <= hi[i]) & (hi[later] >= lo[i]) & ~(point[later] & point[i] & (s[later] == s[i]))
            if np.any(meet & (ov > iou_thr - margin)):
                ambiguous = ambiguous or "nms_order"
        # candidates near the threshold or the top-k cut: each must be
        # suppressed by a kept box that robustly outscores and overlaps it
        border = (s_lo < thr) & (s_hi >= thr)
        if int(np.isfinite(masked).sum()) > k:
            cut = order[-1]
            border |= (s_hi >= s_lo[cut]) & (s_lo <= s_hi[cut]) & (s_hi >= thr)
        kept_boxes, kept_lo, kept_reach = boxes[keep], lo[keep], reach[keep]
        for a in np.nonzero(border)[0]:
            b, _ = decode(self.anchors[a:a + 1], deltas[a:a + 1], lms[a:a + 1], width, height)
            ov = iou(b[0], kept_boxes)
            margin = di + 4.0 * np.maximum(kept_reach, mg["delta"] * self._reach(np.array([a]), b)[0])
            if not np.any((kept_lo > s_hi[a]) & (ov > iou_thr + margin)):
                ambiguous = ambiguous or "threshold"
                break
        rows = np.nonzero(keep)[0][: d["max_detections"]]
        inv = np.float32(1.0) / np.float32(det_scale)
        det = np.concatenate([boxes[rows] * inv, s[rows, None]], 1).astype(np.float32)
        return det, (land[rows] * inv).astype(np.float32), ambiguous

    def _reach(self, rows: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        """Per box: its anchor's larger side over the box's smaller side."""
        a = self.anchors[rows]
        anchor = np.maximum(a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]) + 1.0
        side = np.minimum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]) + 1.0
        return anchor / np.maximum(side, 1.0)

    def _select(self, shape, det: np.ndarray):
        """(index of the selected row or None, ambiguous) by the selection rules."""
        if len(det) == 0:
            return None, ""
        c, px = self.cfg["selection"], self.margins["px"]
        height, width = float(shape[0]), float(shape[1])
        x1, y1, x2, y2 = (det[:, i] for i in range(4))
        area = (x2 - x1) * (y2 - y1)
        cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
        edge = min(50.0, c["margin_edge_ratio"] * width)
        x_cen = width / 2.0
        left, right = c["margin_center_left_ratio"] * width, c["margin_center_right_ratio"] * width
        valid = ((cx >= edge) & (cx <= width - edge) & (cy >= edge) & (cy <= height - edge)
                 & (area / (height * width) >= c["minimum_face_ratio"]))
        center = valid & (-left <= cx - x_cen) & (cx - x_cen <= right)
        near = (np.abs(cx - edge) < px) | (np.abs(cx - (width - edge)) < px) | (np.abs(cy - edge) < px)
        near |= (np.abs(cy - (height - edge)) < px) | (np.abs(cx - x_cen + left) < px)
        near |= np.abs(cx - x_cen - right) < px
        near |= np.abs(area - c["minimum_face_ratio"] * height * width) < 2 * px * ((x2 - x1) + (y2 - y1))
        idx = np.nonzero(center)[0]
        if idx.size == 0:
            idx = np.nonzero(valid)[0] if valid.any() else np.arange(len(det))
        sizes = (x2[idx] - x1[idx]) + (y2[idx] - y1[idx])
        best = int(np.argmax(sizes))
        top = np.sort(sizes)[::-1]
        ambiguous = "selection" if (near.any() or (len(top) > 1 and top[0] - top[1] < 4 * px)
                                    or abs(top[0]) < 4 * px) else ""
        if top[0] <= 0.0:
            return None, ambiguous
        return int(idx[best]), ambiguous

    # -- alignment and heads ----------------------------------------------------

    def _warp(self, canvases: torch.Tensor, mats: np.ndarray) -> torch.Tensor:
        """(F, 112, 112, 3) float BGR faces: each output pixel samples the
        canvas at M^-1 p bilinearly, zero outside."""
        out_w, out_h = self.cfg["alignment"]["image_size"]
        m = torch.from_numpy(mats.astype(np.float64)).to(self.device)
        a = m[:, :, :2]
        a_inv = torch.linalg.inv(a)
        t_inv = -(a_inv @ m[:, :, 2:])[..., 0]
        gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float64, device=self.device),
                                torch.arange(out_w, dtype=torch.float64, device=self.device), indexing="ij")
        sx = (a_inv[:, 0, 0, None, None] * gx + a_inv[:, 0, 1, None, None] * gy + t_inv[:, 0, None, None]).float()
        sy = (a_inv[:, 1, 0, None, None] * gx + a_inv[:, 1, 1, None, None] * gy + t_inv[:, 1, None, None]).float()
        img = canvases.float()
        n, h, w = img.shape[:3]
        x0, y0 = torch.floor(sx), torch.floor(sy)
        wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
        x0, y0 = x0.long(), y0.long()
        bi = torch.arange(n, device=self.device)[:, None, None]

        def px(yy, xx):
            inside = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
            return img[bi, yy.clamp(0, h - 1), xx.clamp(0, w - 1)] * inside

        top = px(y0, x0) * (1 - wx) + px(y0, x0 + 1) * wx
        bot = px(y0 + 1, x0) * (1 - wx) + px(y0 + 1, x0 + 1) * wx
        return top * (1 - wy) + bot * wy

    def _heads(self, faces: torch.Tensor):
        out = []
        for part in ("quality", "identification"):
            c = self.cfg[part]
            w, h = c["image_size"]
            x = faces.flip(-1)
            if (x.shape[1], x.shape[2]) != (h, w):
                raise ValueError("the reference aligns to the heads' own input size")
            mean = torch.tensor(c["mean"], device=self.device)
            scale = torch.tensor(c["scale"], device=self.device)
            x = ((x - mean) * scale).permute(0, 3, 1, 2).contiguous()
            with torch.no_grad():
                out.append(self.nets[part](x))
        probs, emb = out
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)
        return probs.cpu().numpy(), emb.cpu().numpy()

    # -- the whole request ------------------------------------------------------

    def answers(self, jpegs: List[bytes]) -> List[dict]:
        """One answer per JPEG: face_count, selected_face_box (5,) or None,
        face_quality, quality_score, facial_feature (512,) or None, and the
        flags ``ambiguous`` and ``quality_ambiguous``."""
        results = []
        for lo in range(0, len(jpegs), self.block):
            results += self._block(jpegs[lo: lo + self.block])
        return results

    def _block(self, jpegs: List[bytes]) -> List[dict]:
        import cv2

        d = self.cfg["detector"]
        width, height = d["image_size"]
        images = [cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_COLOR) for j in jpegs]
        boxed = [letterbox(im, width, height) for im in images]
        canvases = np.stack([c for c, _ in boxed])
        scores, deltas, lms = self._raw(canvases)
        template = np.asarray(self.cfg["alignment"]["template"], np.float32)
        results, mats, owners = [], [], []
        for i, (im, (_, scale)) in enumerate(zip(images, boxed)):
            det, land, amb = self._detect_one(scores[:, i], deltas[i], lms[i], scale)
            res = {"face_count": int(len(det)), "selected_face_box": None, "face_quality": None,
                   "quality_score": None, "facial_feature": None, "ambiguous": amb, "quality_ambiguous": False}
            row, sel_amb = self._select(im.shape[:2], det)
            res["ambiguous"] = amb or sel_amb  # the first reason, or ""
            if row is not None:
                res["selected_face_box"] = det[row]
                m = umeyama(land[row], template)
                m[:, :2] /= np.float32(scale)
                mats.append(m)
                owners.append(i)
            results.append(res)
        if owners:
            faces = self._warp(torch.from_numpy(canvases[owners]).to(self.device), np.stack(mats))
            probs, embs = self._heads(faces)
            q, dp = self.cfg["quality"], self.margins["prob"]
            for j, i in enumerate(owners):
                p = probs[j]
                cls = int(np.argmax(p))
                score = float(p[cls])
                if cls == 1 and score < q["threshold"]:
                    cls, score = 0, float(p[0])
                top = np.sort(p)[::-1]
                results[i]["quality_ambiguous"] = bool(top[0] - top[1] < dp or abs(p[1] - q["threshold"]) < dp)
                results[i].update(face_quality=cls, quality_score=score, facial_feature=embs[j])
        return results

