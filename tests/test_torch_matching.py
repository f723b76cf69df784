"""1:1 verification and 1:N identification: the JAX package's cases
(tests/test_matching.py) through the port on the CPU, and the top-k order
on tied scores against ``jax.lax.top_k`` (the lower index first)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.ops import matching as jm
from rs_face_detection_tpu_torch.ops.matching import Gallery, cosine_scores, normalize_rows, search, verify


def _unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


def test_verify_thresholds():
    a = _unit(np.ones(8))
    ok, sim = verify(a, a)
    assert ok and sim == pytest.approx(1.0)
    b = _unit(np.concatenate([np.ones(4), -np.ones(4)]))
    ok, sim = verify(a, b, threshold=0.4)
    assert not ok and sim == pytest.approx(0.0, abs=1e-6)
    assert verify(a, b) == jm.verify(a, b)


def test_search_topk_equals_jax():
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(50, 16)).astype(np.float32)
    gallery = normalize_rows(torch.from_numpy(raw))
    np.testing.assert_allclose(gallery.numpy(), np.asarray(jm.normalize_rows(jnp.asarray(raw))), atol=1e-6)
    probes = gallery[torch.tensor([7, 33])]
    scores, idx = search(probes, gallery, k=3)
    assert idx.shape == (2, 3)
    assert int(idx[0, 0]) == 7 and int(idx[1, 0]) == 33
    assert float(scores[0, 0]) == pytest.approx(1.0, abs=1e-5)
    assert (np.diff(scores.numpy(), axis=1) <= 1e-6).all()
    want_s, want_i = jm.search(jnp.asarray(probes.numpy()), jnp.asarray(gallery.numpy()), k=3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s), atol=1e-6)
    np.testing.assert_allclose(
        cosine_scores(probes, gallery).numpy(),
        np.asarray(jm.cosine_scores(jnp.asarray(probes.numpy()), jnp.asarray(gallery.numpy()))), atol=1e-6,
    )


@pytest.mark.parametrize("k", [1, 3, 6])
def test_tied_scores_keep_top_k_order(k):
    """Duplicated gallery rows tie exactly: the lower index comes first, as
    in jax.lax.top_k."""
    rng = np.random.default_rng(k)
    base = np.stack([_unit(rng.normal(size=8)) for _ in range(3)])
    gallery = base[[2, 0, 1, 0, 2, 0, 1, 1]]  # every row three-way or two-way tied
    probes = np.stack([base[0], base[1], base[2], _unit(rng.normal(size=8))])
    scores, idx = search(torch.from_numpy(probes), torch.from_numpy(gallery), k=k)
    want_s, want_i = jax.lax.top_k(jnp.asarray(probes @ gallery.T), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s), atol=1e-6)
    assert list(idx[0, : min(k, 3)].numpy()) == [1, 3, 5][: min(k, 3)]  # the rows equal to probe 0


def test_gallery_lifecycle():
    rng = np.random.default_rng(1)
    g = Gallery(embedding_dim=16, device="cpu")
    people = {name: _unit(rng.normal(size=16)) for name in ("ana", "bo", "kim")}
    for name, vec in people.items():
        g.enroll(name, vec)
    assert len(g) == 3
    probe = _unit(people["bo"] + rng.normal(0, 0.05, 16).astype(np.float32))
    matches = g.identify(probe, threshold=0.5)
    assert matches[0][0][0] == "bo"
    assert matches[0][0][1] > 0.9
    q = rng.normal(size=16).astype(np.float32)
    for v in people.values():
        q -= np.dot(q, v) * v
    assert g.identify(_unit(q), threshold=0.4) == [[]]
    assert g.remove("bo") == 1
    matches = g.identify(probe, threshold=0.0)
    assert matches[0][0][0] != "bo"
    with pytest.raises(ValueError):
        g.enroll("x", np.ones(8, np.float32))
    assert Gallery(16, device="cpu").identify(probe) == [[]]


def test_gallery_batch_probes_equal_jax():
    rng = np.random.default_rng(2)
    g, ref = Gallery(8, device="cpu"), jm.Gallery(8)
    for i in range(5):
        vec = _unit(rng.normal(size=8))
        g.enroll(i, vec)
        ref.enroll(i, vec)
    probes = np.stack([_unit(rng.normal(size=8)) for _ in range(4)])
    out = g.identify(probes, threshold=-1.0, k=2)
    assert len(out) == 4 and all(len(m) == 2 for m in out)
    want = ref.identify(probes, threshold=-1.0, k=2)
    assert [[lab for lab, _ in m] for m in out] == [[lab for lab, _ in m] for m in want]
    for m, w in zip(out, want):
        np.testing.assert_allclose([s for _, s in m], [s for _, s in w], atol=1e-6)
