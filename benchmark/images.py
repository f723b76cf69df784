"""The JPEG pool a traffic mix draws its requests from, made from the seed.

Each image is a smooth seeded background (a base colour, two gradients and
noise) with 0, 1 or 2 copies of the real face crop pasted at a seeded size
and place, JPEG-encoded.  The share of each resolution and of each face
count is exact for every seed (the counts are fixed, their order is drawn),
and the face sizes are a fixed ladder in a drawn order, so that seeds change
which image comes when, not how much work the pool holds.

A one-face image has its face in the centre band that the selection
prefers; a two-face image adds a smaller face near the left or right edge,
outside that band.  Backgrounds and noise are drawn on the run's device by a
``torch.Generator``; the layout by numpy.  Encoding runs on a few threads.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def face_crop() -> np.ndarray:
    """The (160, 160, 3) uint8 BGR face crop of the repository's real photograph."""
    with np.load(os.path.join(HERE, "data", "real_face_crop.npz")) as data:
        return data["face"]


def exact_counts(n: int, shares: List[float]) -> List[int]:
    """Counts of n items that follow ``shares``, rounded so that they sum to n."""
    raw = np.asarray(shares, np.float64) * n / float(np.sum(shares))
    counts = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def layout(spec: dict, seed: int) -> List[dict]:
    """Per image: (width, height) and a list of (x, y, size) faces."""
    rng = np.random.default_rng([seed, 1])
    n = spec["count"]
    sizes = [tuple(s[:2]) for s in spec["sizes"]]
    res = np.repeat(np.arange(len(sizes)), exact_counts(n, [s[2] for s in spec["sizes"]]))
    kinds = np.repeat(np.arange(3), exact_counts(n, [spec["faces"][k] for k in ("none", "one", "two")]))
    res, kinds = rng.permutation(res), rng.permutation(kinds)
    lo, hi = spec["face_height"]
    ladder = rng.permutation(lo + (hi - lo) * (np.arange(n) + 0.5) / n)
    out = []
    for i in range(n):
        w, h = sizes[res[i]]
        faces = []
        if kinds[i] >= 1:
            s = int(ladder[i] * h)
            cx = w / 2 + rng.uniform(-0.2, 0.2) * w
            cy = rng.uniform(0.5 * s + 0.12 * h, h - 0.5 * s - 0.12 * h) if h - s > 0.24 * h else h / 2
            faces.append((int(np.clip(cx - s / 2, 0, w - s)), int(np.clip(cy - s / 2, 0, h - s)), s))
        if kinds[i] == 2:
            s2 = int(rng.uniform(lo, 0.3) * h)
            x2 = int(rng.uniform(0, max(1.0, 0.16 * w - s2 / 2)))
            if rng.random() < 0.5:
                x2 = w - s2 - x2
            y2 = int(rng.uniform(0, h - s2))
            faces.insert(0, (x2, y2, s2))  # pasted first: the central face stays whole
        out.append({"size": (w, h), "faces": faces})
    return out


def render(items: List[dict], seed: int, device: torch.device, chunk: int = 32) -> List[np.ndarray]:
    """(h, w, 3) uint8 BGR images for a layout, drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    face = torch.from_numpy(face_crop()).to(device).float()
    images: List[np.ndarray] = [None] * len(items)
    groups = {}
    for i, it in enumerate(items):
        groups.setdefault(it["size"], []).append(i)
    for (w, h), idx in sorted(groups.items()):
        yy = torch.linspace(0, 1, h, device=device)[:, None, None]
        xx = torch.linspace(0, 1, w, device=device)[None, :, None]
        for lo in range(0, len(idx), chunk):
            part = idx[lo: lo + chunk]
            k = len(part)
            p = torch.rand((k, 3, 3), generator=gen, device=device)
            base = 40 + 160 * p[:, 0]
            gy, gx = 120 * p[:, 1] - 60, 120 * p[:, 2] - 60
            img = (base[:, None, None] + yy[None] * gy[:, None, None] + xx[None] * gx[:, None, None]
                   + 6 * torch.randn((k, h, w, 3), generator=gen, device=device))
            for j, i in enumerate(part):
                for x, y, s in items[i]["faces"]:
                    rows = (torch.arange(s, device=device) * face.shape[0]) // s
                    cols = (torch.arange(s, device=device) * face.shape[1]) // s
                    img[j, y: y + s, x: x + s] = face[rows][:, cols]
            img = img.round_().clamp_(0, 255).to(torch.uint8).cpu().numpy()
            for j, i in enumerate(part):
                images[i] = img[j]
    return images


def encode(images: List[np.ndarray], quality: int, threads: int = 8) -> List[bytes]:
    import cv2

    def one(img):
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
        if not ok:
            raise RuntimeError("JPEG encoding failed")
        return buf.tobytes()

    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(one, images))


def make_pool(spec: dict, seed: int, device: torch.device) -> Tuple[List[bytes], List[dict]]:
    """(JPEG bytes, layout) of the pool a traffic file's ``images`` entry names."""
    items = layout(spec, seed)
    return encode(render(items, seed, device), spec["jpeg_quality"]), items
