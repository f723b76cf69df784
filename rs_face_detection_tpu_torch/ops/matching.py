"""Embedding matching: 1:1 verification and 1:N gallery identification.

Counterpart of rs_face_detection_tpu/ops/matching.py.  Cosine scoring of Q
probes against N enrolled rows is one (Q, D) x (D, N) f32 matmul on the
device (``torch.matmul``; the JAX package computes it outside any Pallas
kernel too, so there is no kernel to port).  The top-k keeps
``jax.lax.top_k``'s order on ties -- the lower index first -- by a stable
descending sort (``torch.topk`` promises no order on ties).

Embeddings are assumed L2-normalized per row (the pipelines emit them so);
``normalize_rows`` is provided for external vectors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize each row."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def cosine_scores(probes: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) cosine similarities in f32 (rows pre-normalized)."""
    return torch.matmul(probes.float(), gallery.float().T)


def search(probes: torch.Tensor, gallery: torch.Tensor, k: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery matches per probe: (scores (Q, k), indices (Q, k)),
    ties in index order."""
    scores, order = torch.sort(cosine_scores(probes, gallery), dim=1, descending=True, stable=True)
    return scores[:, :k], order[:, :k]


def verify(embedding_a: np.ndarray, embedding_b: np.ndarray, threshold: float = 0.4) -> Tuple[bool, float]:
    """1:1 comparison (default threshold = the eKYC same-person 0.4)."""
    a = np.asarray(embedding_a, np.float32).reshape(-1)
    b = np.asarray(embedding_b, np.float32).reshape(-1)
    a = a / max(np.linalg.norm(a), 1e-12)
    b = b / max(np.linalg.norm(b), 1e-12)
    sim = float(np.dot(a, b))
    return sim >= threshold, sim


class Gallery:
    """Identity gallery over L2-normalized embeddings.

    Enrollment is host-side bookkeeping; identification runs on ``device``
    (the card unless the caller asks for the CPU), where the matrix is kept
    and rebuilt lazily after enrollment changes.
    """

    def __init__(self, embedding_dim: int = 512, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self.embedding_dim = embedding_dim
        self._labels: list = []
        self._rows: list = []
        self._matrix = None  # device copy, rebuilt lazily

    def __len__(self) -> int:
        return len(self._labels)

    def enroll(self, label, embedding: np.ndarray) -> None:
        vec = np.asarray(embedding, np.float32).reshape(-1)
        if vec.shape[0] != self.embedding_dim:
            raise ValueError(f"embedding dim {vec.shape[0]} != gallery dim {self.embedding_dim}")
        self._labels.append(label)
        self._rows.append(vec / max(np.linalg.norm(vec), 1e-12))
        self._matrix = None

    def remove(self, label) -> int:
        """Remove all enrollments with this label; returns how many."""
        keep = [(lab, r) for lab, r in zip(self._labels, self._rows) if lab != label]
        removed = len(self._labels) - len(keep)
        self._labels = [lab for lab, _ in keep]
        self._rows = [r for _, r in keep]
        self._matrix = None
        return removed

    def identify(self, embeddings: np.ndarray, threshold: float = 0.4, k: int = 1):
        """Identify (Q, D) probes: per probe a list of (label, score), best
        first, below-threshold candidates dropped (empty means unknown)."""
        probes = np.atleast_2d(np.asarray(embeddings, np.float32))
        if not self._labels:
            return [[] for _ in range(probes.shape[0])]
        probes = probes / np.maximum(np.linalg.norm(probes, axis=1, keepdims=True), 1e-12)
        if self._matrix is None:
            self._matrix = torch.from_numpy(np.stack(self._rows)).to(self.device)
        scores, idx = search(torch.from_numpy(probes).to(self.device), self._matrix, min(k, len(self._labels)))
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        return [
            [(self._labels[int(i)], float(s)) for s, i in zip(scores[q], idx[q]) if s >= threshold]
            for q in range(probes.shape[0])
        ]
