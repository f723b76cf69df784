"""The port's RetinaFace training (parallel/train.py) against the JAX
package's on the same seeded numpy inputs and the same weights.

The JAX Trainer runs on ``make_mesh(1)``; each JAX train step used here is
compiled once in this file.  JAX's gradients are read from its first step's
Adam moment (mu = (1 - b1) g from a zero state), so no second JAX program is
compiled for them.

Tolerances:
- ``match_anchors``: labels and ``best_gt`` equal;
- ``detection_loss`` and its parts: rtol 1e-5, ``num_pos`` equal;
- ``arcface_margin_loss``: rtol 1e-5;
- one mnet step at 64x64, b2: loss rtol 1e-5; gradients per leaf within
  1e-4 x max|g|; BatchNorm ``running_var`` rtol 1e-5 and ``running_mean``
  rtol 1e-5 with atol 1e-5 (a mean near 0 carries the convolutions'
  rounding, measured 9e-7 at most);
- AdamW on JAX's own gradients, three steps: params within 1e-6, moments
  within 1e-5 x max|moment| per leaf;
- the learning rate at every step within 1e-7 of optax's (peak 1.0);
- three steps, each from JAX's state before it: loss rtol 1e-5 and the
  buffers as above; run free, the losses part by 2e-2 at the third step
  (Adam's first update takes the sign of float32 rounding where the exact
  gradient is near 0), bound 5e-2;
- the R50 at 64x64, b1, and bf16: ill-conditioned in float32 (stride-32
  BatchNorms over 4 values) or coarse (bf16), so held against float64
  beside JAX: the loss within rtol 1e-3 (R50; bf16 5e-2) of float64, and
  the gradient (and R50 running variances) no farther from float64's
  than JAX's are.

Every gradient bound is on the scale of the whole gradient, max|g| over
every leaf.
"""

import math

import jax
import numpy as np
import optax
import pytest
import torch

from rs_face_detection_tpu.configs import FaceDetectionConfig as JaxDetectionConfig
from rs_face_detection_tpu.models.registry import _flatten
from rs_face_detection_tpu.parallel import train as jtrain
from rs_face_detection_tpu.parallel.mesh import make_mesh
from rs_face_detection_tpu_torch.configs import RPN_ANCHOR_CFG, FaceDetectionConfig
from rs_face_detection_tpu_torch.models import layers, weights
from rs_face_detection_tpu_torch.ops.anchors import full_anchor_table
from rs_face_detection_tpu_torch.parallel import train as ptrain

torch.set_num_threads(2)

SIZE = (64, 64)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_run(backbone="mobilenet025", batch=2, steps=1, dtype=None, **kw):
    """JAX's Trainer from seed 0 for ``steps`` steps on make_batch(seed=i):
    the initial variables, the batches, and after each step the metrics,
    params, batch_stats and Adam state."""
    import jax.numpy as jnp

    cfg = JaxDetectionConfig(image_size=SIZE, backbone=backbone)
    trainer = jtrain.Trainer(make_mesh(1), cfg, learning_rate=1e-3, dtype=dtype or jnp.float32, **kw)
    state = trainer.init_state(seed=0)
    init = {"params": _host(state.params), "batch_stats": _host(state.batch_stats)}
    step = trainer.make_train_step()
    out = {"init": init, "batches": [], "after": []}
    for i in range(steps):
        arrays = trainer.make_batch(batch, max_faces=4, seed=i)
        out["batches"].append(tuple(np.array(t) for t in arrays[:4]))
        state, metrics = step(state, arrays)
        out["after"].append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": _host(state.params),
            "batch_stats": _host(state.batch_stats),
            "adam": _host(state.opt_state[0]),
        })
    return out


@pytest.fixture(scope="module")
def jax_mnet():
    return _jax_run(steps=3)


def _port_trainer(backbone="mobilenet025", **kw):
    return ptrain.Trainer(FaceDetectionConfig(image_size=SIZE, backbone=backbone), learning_rate=1e-3,
                          device="cpu", **kw)


def _bridged(family, params, batch_stats):
    """A flax tree in the port's state_dict layout (gradients and moments
    bridge as parameters do)."""
    return weights.state_dict_from_jax(family, {"params": params, "batch_stats": batch_stats})


def _port_step(trainer, variables, batch_arrays):
    state = trainer.init_state(variables=variables)
    state, metrics = trainer.make_train_step()(state, ptrain.TrainBatch(*batch_arrays))
    return state, metrics


def _jax_grads(family, after):
    """JAX's gradients of its first step: mu / (1 - b1) from a zero moment."""
    return _bridged(family, jax.tree.map(lambda m: m / np.float32(0.1), after["adam"].mu), after["batch_stats"])


def _port_f64(backbone, variables, arrays):
    """The port's loss and gradients in float64 at the same weights and
    batch: the exact value both float32 steps are held against."""
    trainer = _port_trainer(backbone)
    model = trainer.init_state(variables=variables).model.double()
    b = trainer.prepare(ptrain.TrainBatch(*arrays))
    b = ptrain.TrainBatch(*(t.double() if t.is_floating_point() else t for t in b))
    loss = trainer.loss(trainer.forward(model, b.images), b)[0].mean()
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}, dict(model.named_buffers())


def _grad_err(model, ref):
    """max over leaves of max|g - ref|, over max|ref| across every leaf."""
    scale = max(float(g.abs().max()) for g in ref.values())
    return max(float((p.grad.double() - ref[n].double()).abs().max()) for n, p in model.named_parameters()) / scale


def _grad_dist(model, ref, exact):
    """||g - exact|| of the model's gradients and of ``ref``'s, over every
    leaf at once."""
    mine = sum(float(((p.grad.double() - exact[n]) ** 2).sum()) for n, p in model.named_parameters())
    theirs = sum(float(((ref[n].double() - exact[n]) ** 2).sum()) for n, _ in model.named_parameters())
    return math.sqrt(mine), math.sqrt(theirs)


def _var_err(buffers, ref):
    """Max elementwise relative error of the running variances."""
    return max(float(((buf.double() - ref[name].double()).abs() / ref[name].double().abs()).max())
               for name, buf in buffers.items() if name.endswith("running_var"))


def _bn_mismatch(model, ref):
    """Max elementwise relative error of the running variances, and whether
    the running means meet rtol 1e-5 with atol 1e-5."""
    means_ok = all(np.allclose(buf.numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-5)
                   for name, buf in model.named_buffers() if name.endswith("running_mean"))
    return _var_err(dict(model.named_buffers()), ref), means_ok


def _state_from_jax(trainer, family, snap):
    """A port state at JAX's state after a step: params, BatchNorm buffers,
    Adam moments and count."""
    state = trainer.init_state(variables={"params": snap["params"], "batch_stats": snap["batch_stats"]})
    adam = snap["adam"]
    mu, nu = (_bridged(family, m, snap["batch_stats"]) for m in (adam.mu, adam.nu))
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = {"step": torch.tensor(float(adam.count)), "exp_avg": mu[name].clone(),
                                    "exp_avg_sq": nu[name].clone()}
    state.step = int(adam.count)
    return state


# -- anchor matching and the loss ---------------------------------------------


def _anchors(size=(128, 128)):
    anchors, _ = full_anchor_table(size, RPN_ANCHOR_CFG, (32, 16, 8), False)
    return anchors


def _match_case(case, anchors):
    rng = np.random.default_rng(11)
    if case == "random":
        x1 = rng.uniform(0, 90, (3, 6))
        y1 = rng.uniform(0, 90, (3, 6))
        s = rng.uniform(8, 60, (3, 6))
        gt = np.stack([x1, y1, x1 + s, y1 + s], -1).astype(np.float32)
        valid = rng.uniform(size=(3, 6)) > 0.3
    elif case == "ties":
        # Duplicate gt rows (equal IoU against every anchor), a gt that is
        # an anchor exactly, and two gts sharing one best anchor.
        a = anchors[40]
        gt = np.asarray([[a, a, a + [1, 1, 1, 1], [10, 10, 40, 40], [10, 10, 40, 40], a + [0, 0, 2, 2]]], np.float32)
        valid = np.ones((1, 6), bool)
    else:  # padded: invalid zero rows whose argmax lands on anchor 0, which a valid gt also wants
        gt = np.zeros((2, 5, 4), np.float32)
        gt[:, 0] = anchors[0]
        gt[1, 1] = [30, 30, 70, 70]
        valid = np.asarray([[True, False, False, False, False], [True, True, False, False, False]])
    return gt, valid


@pytest.mark.parametrize("case", ["random", "ties", "padded"])
def test_match_anchors_matches_jax(case):
    anchors = _anchors()
    gt, valid = _match_case(case, anchors)
    labels, best, max_iou = ptrain.match_anchors(torch.from_numpy(anchors), torch.from_numpy(gt),
                                                 torch.from_numpy(valid))
    for i in range(gt.shape[0]):
        jl, jb, jm = jtrain.match_anchors(anchors, gt[i], valid[i])
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(best[i].numpy(), np.asarray(jb))
        np.testing.assert_allclose(max_iou[i].numpy(), np.asarray(jm), rtol=1e-6, atol=1e-7)
    assert (labels == 1).any()


def _loss_inputs(case, anchors):
    rng = np.random.default_rng(5)
    n, b = anchors.shape[0], 3
    logits = np.zeros((b, n, 2), np.float32) if case == "zero_logits" else rng.normal(size=(b, n, 2)).astype(np.float32)
    boxes = rng.normal(size=(b, n, 4)).astype(np.float32)
    lms = rng.normal(size=(b, n, 5, 2)).astype(np.float32)
    x1 = rng.uniform(0, 80, (b, 4))
    s = rng.uniform(10, 45, (b, 4))
    gt = np.stack([x1, x1 + 3, x1 + s, x1 + 3 + s], -1).astype(np.float32)
    gt_lms = (gt[:, :, None, :2] + rng.uniform(0, 10, (b, 4, 5, 2))).astype(np.float32)
    valid = np.asarray([[True, True, False, False], [True, False, False, False], [True, True, True, True]])
    lm_valid = np.asarray([[True, False, True, True], [False, True, True, True], [True, True, False, True]])
    ignore = np.zeros((b, 2, 4), np.float32)
    ignore[0, 0] = [90, 90, 120, 120]
    ignore[2, 1] = [2, 100, 20, 125]
    return logits, boxes, lms, gt, gt_lms, valid, lm_valid, ignore


@pytest.mark.parametrize("case", ["random", "zero_logits"])
def test_detection_loss_matches_jax(case):
    """Batched in the port, per image in JAX.  With zero logits every CE is
    ln 2 and OHEM's stable ranking decides which negatives count."""
    anchors = _anchors()
    logits, boxes, lms, gt, gt_lms, valid, lm_valid, ignore = _loss_inputs(case, anchors)
    t = torch.from_numpy
    total, parts = ptrain.detection_loss(
        t(logits), t(boxes), t(lms), t(anchors), t(gt), t(gt_lms), t(valid),
        gt_lm_valid=t(lm_valid), ignore_boxes=t(ignore),
    )
    for i in range(logits.shape[0]):
        jt, jp = jtrain.detection_loss(
            logits[i], boxes[i], lms[i], anchors, gt[i], gt_lms[i], valid[i],
            gt_lm_valid=lm_valid[i], ignore_boxes=ignore[i],
        )
        np.testing.assert_allclose(float(total[i]), float(jt), rtol=1e-5)
        for k in ("cls_loss", "box_loss", "lm_loss"):
            np.testing.assert_allclose(float(parts[k][i]), float(jp[k]), rtol=1e-5, err_msg=k)
        assert float(parts["num_pos"][i]) == float(jp["num_pos"])
        # The one-image form gives the batch's row.
        one, _ = ptrain.detection_loss(
            t(logits[i]), t(boxes[i]), t(lms[i]), t(anchors), t(gt[i]), t(gt_lms[i]), t(valid[i]),
            gt_lm_valid=t(lm_valid[i]), ignore_boxes=t(ignore[i]),
        )
        assert float(one) == float(total[i])
    if case == "zero_logits":
        # Every CE is ln 2, so which tied negatives OHEM keeps shows in the
        # gradient, not the value: the logits' gradients equal JAX's.
        logits_t = t(logits).requires_grad_(True)
        mine, _ = ptrain.detection_loss(
            logits_t, t(boxes), t(lms), t(anchors), t(gt), t(gt_lms), t(valid),
            gt_lm_valid=t(lm_valid), ignore_boxes=t(ignore),
        )
        mine.sum().backward()
        for i in range(logits.shape[0]):
            def cls_of(lg, i=i):
                return jtrain.detection_loss(lg, boxes[i], lms[i], anchors, gt[i], gt_lms[i], valid[i],
                                             gt_lm_valid=lm_valid[i], ignore_boxes=ignore[i])[0]

            want = np.asarray(jax.grad(cls_of)(logits[i]))
            np.testing.assert_allclose(logits_t.grad[i].numpy(), want, rtol=1e-6, atol=1e-7)
            kept = np.flatnonzero(np.abs(want).sum(-1) > 0)
            assert 0 < kept.size < logits.shape[1]


def test_detection_loss_ohem_selects_hard_negatives():
    n = 64
    anchors = np.zeros((n, 4), np.float32)
    for i in range(n):
        anchors[i] = [i * 20, 0, i * 20 + 15, 15]
    gt = np.array([[0, 0, 15, 15]], np.float32)
    logits = np.zeros((n, 2), np.float32)
    logits[10:13, 1] = 8.0  # a handful of confidently wrong (hard) negatives
    t = torch.from_numpy
    loss, metrics = ptrain.detection_loss(
        t(logits), torch.zeros(n, 4), torch.zeros(n, 5, 2), t(anchors), t(gt), torch.zeros(1, 5, 2),
        torch.tensor([True]),
    )
    assert math.isfinite(float(loss))
    assert float(metrics["num_pos"]) == 1
    # 1 positive at ratio 3: the 3 hard negatives (CE ~8 each), not the ~61
    # easy ones (ln 2 each, ~42 without OHEM).
    assert 20.0 < float(metrics["cls_loss"]) < 30.0


def test_arcface_margin_loss_behavior_and_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(10, 32)).astype(np.float32)
    labels = np.arange(8) % 10
    good = w[labels] + rng.normal(0, 0.01, (8, 32)).astype(np.float32)
    bad = w[(labels + 5) % 10].astype(np.float32)
    noisy = (w[labels] + rng.normal(0, 2.0, (8, 32))).astype(np.float32)
    t = torch.from_numpy

    def port(e, margin=0.5):
        return float(ptrain.arcface_margin_loss(t(e), t(labels), t(w), margin=margin))

    assert port(good) < port(bad)
    assert math.isfinite(port(good)) and math.isfinite(port(bad))
    assert port(noisy) > port(noisy, margin=0.0)
    # Past pi - margin the linear fallback applies: the bad embeddings.
    for e, margin in ((good, 0.5), (bad, 0.5), (noisy, 0.5), (noisy, 0.0), (bad, 1.2)):
        np.testing.assert_allclose(port(e, margin), float(jtrain.arcface_margin_loss(e, labels, w, margin=margin)),
                                   rtol=1e-5)


# -- the train step -----------------------------------------------------------


def test_train_step_matches_jax(jax_mnet, monkeypatch):
    """One mnet step from JAX-initialised weights: loss, gradients and the
    BatchNorm buffers, which follow flax's biased update; the buffers of
    nn.BatchNorm2d's unbiased update miss (n = 8 at stride 32: 14% on the
    batch variance's share).  The gradients are held against JAX's and
    against the float64 gradient on the scale of the whole gradient: the
    scales of BatchNorms that feed a depthwise conv and another BatchNorm
    are scale-invariant at initialisation, so their exact gradient is near
    0 and both float32 runs give rounding there."""
    family = "retinaface_mobilenet025"
    after = jax_mnet["after"][0]
    state, metrics = _port_step(_port_trainer(), jax_mnet["init"], jax_mnet["batches"][0])
    np.testing.assert_allclose(float(metrics["loss"]), after["metrics"]["loss"], rtol=1e-5)
    for k in ("cls_loss", "box_loss", "lm_loss"):
        np.testing.assert_allclose(float(metrics[k]), after["metrics"][k], rtol=1e-4, err_msg=k)
    assert float(metrics["num_pos"]) == after["metrics"]["num_pos"]
    jax_grads = _jax_grads(family, after)
    assert _grad_err(state.model, jax_grads) <= 1e-4
    loss64, grads64, _ = _port_f64("mobilenet025", jax_mnet["init"], jax_mnet["batches"][0])
    np.testing.assert_allclose(float(metrics["loss"]), loss64, rtol=1e-5)
    assert _grad_err(state.model, grads64) <= 1e-4
    ref = _bridged(family, after["params"], after["batch_stats"])
    var_err, means_ok = _bn_mismatch(state.model, ref)
    assert var_err <= 1e-5 and means_ok, var_err

    monkeypatch.setattr(layers.BatchNorm2d, "forward", torch.nn.BatchNorm2d.forward)
    unbiased, _ = _port_step(_port_trainer(), jax_mnet["init"], jax_mnet["batches"][0])
    assert _bn_mismatch(unbiased.model, ref)[0] > 1e-3


def test_adamw_update_on_jax_gradients(jax_mnet):
    """The port's optimizer, from JAX's state before each of three steps
    (params, Adam moments and count), applied to JAX's own gradients of
    that step, gives JAX's updated params (decay on kernels only, lr 1e-3,
    bias corrections at counts 1-3) and moments.  JAX's gradient of step k
    is (mu_k - b1 mu_(k-1)) / (1 - b1)."""
    family = "retinaface_mobilenet025"
    trainer = _port_trainer()
    prev = {"params": jax_mnet["init"]["params"], "batch_stats": jax_mnet["init"]["batch_stats"], "adam": None}
    for after in jax_mnet["after"]:
        bs = after["batch_stats"]
        if prev["adam"] is None:
            state = trainer.init_state(variables={"params": prev["params"], "batch_stats": bs})
            mu_prev = jax.tree.map(np.zeros_like, after["adam"].mu)
        else:
            state = _state_from_jax(trainer, family, prev)
            mu_prev = prev["adam"].mu
        grads = _bridged(family, jax.tree.map(lambda m, m0: (m - np.float32(0.9) * m0) / np.float32(0.1),
                                              after["adam"].mu, mu_prev), bs)
        for name, p in state.model.named_parameters():
            p.grad = grads[name].clone()
        state.optimizer.step()
        ref = _bridged(family, after["params"], bs)
        mu = _bridged(family, after["adam"].mu, bs)
        nu = _bridged(family, after["adam"].nu, bs)
        for name, p in state.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
            st = state.optimizer.state[p]
            for got, want in ((st["exp_avg"], mu[name]), (st["exp_avg_sq"], nu[name])):
                assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), name
        prev = after


def test_learning_rate_schedule_matches_optax():
    """The schedule at every count equals optax's warmup + cosine (read at
    the count of updates before the step: the first step's rate is 0), and
    the train step applies it: the first step leaves the weights as they
    were."""
    for warmup, total in ((3, 12), (1, 5), (4, 9)):
        mine = ptrain.warmup_cosine_decay_schedule(1.0, warmup, total)
        ref = optax.warmup_cosine_decay_schedule(0.0, 1.0, warmup, total)
        assert mine(0) == 0.0
        for count in range(total + 3):
            assert abs(mine(count) - float(ref(count))) <= 1e-7, (warmup, total, count)
    with pytest.raises(ValueError):
        ptrain.warmup_cosine_decay_schedule(1.0, 5, 5)

    trainer = ptrain.Trainer(FaceDetectionConfig(image_size=SIZE), learning_rate=1e-3, warmup_steps=2,
                             total_steps=6, device="cpu")
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 6)
    state = trainer.init_state(0)
    before = {k: v.clone() for k, v in state.model.state_dict().items() if "running" not in k}
    step = trainer.make_train_step()
    batch = trainer.make_batch(1, max_faces=2, seed=0)
    for count in range(5):
        state, _ = step(state, batch)
        for group in state.optimizer.param_groups:
            assert abs(group["lr"] - float(ref(count))) <= 1e-10
        if count == 0:
            after = state.model.state_dict()
            assert all(torch.equal(after[k], v) for k, v in before.items() if not k.endswith("num_batches_tracked"))


def test_weight_decay_mask_matches_jax(jax_mnet):
    """The decayed parameters are exactly those JAX's mask selects: a tree
    of ones where JAX decays and zeros where not, bridged to the port."""
    jax_mask = jtrain._weight_decay_mask(jax_mnet["init"]["params"])
    marks = jax.tree.map(lambda keep, p: np.full(np.shape(p), 1.0 if keep else 0.0, np.float32),
                         jax_mask, jax_mnet["init"]["params"])
    bridged = _bridged("retinaface_mobilenet025", marks, jax_mnet["init"]["batch_stats"])
    state = _port_trainer().init_state(0)
    mine = ptrain._weight_decay_mask(state.params)
    decayed = {id(p) for p in state.optimizer.param_groups[0]["params"]}
    assert state.optimizer.param_groups[0]["weight_decay"] == 1e-4
    assert state.optimizer.param_groups[1]["weight_decay"] == 0.0
    for name, p in state.model.named_parameters():
        want = bool(bridged[name].numpy().all())
        assert want == bool(bridged[name].numpy().any())
        assert mine[name] is want and (id(p) in decayed) is want, name
    n_flat = len(_flatten(jax_mnet["init"]["params"]))
    assert n_flat == len(mine)


def test_three_steps_match_jax(jax_mnet):
    """Three steps.  Each step of the port from JAX's state before it
    (params, BatchNorm buffers, Adam moments and count) gives JAX's loss
    within rtol 1e-5 and JAX's buffers.  Run free from the same start, the
    port's own states drift from JAX's: Adam's first update is lr x the
    sign of each gradient element, and the elements whose exact gradient is
    near 0 (see test_train_step_matches_jax) take float32 rounding's sign,
    so the losses part by 1e-3 at the second step and 2e-2 at the third
    (measured); they stay within 5e-2."""
    family = "retinaface_mobilenet025"
    trainer = _port_trainer()
    step = trainer.make_train_step()
    free = trainer.init_state(variables=jax_mnet["init"])
    for i, (arrays, after) in enumerate(zip(jax_mnet["batches"], jax_mnet["after"])):
        if i == 0:
            state = trainer.init_state(variables=jax_mnet["init"])
        else:
            state = _state_from_jax(trainer, family, jax_mnet["after"][i - 1])
        state, metrics = step(state, ptrain.TrainBatch(*arrays))
        assert state.step == i + 1
        np.testing.assert_allclose(float(metrics["loss"]), after["metrics"]["loss"], rtol=1e-5)
        var_err, means_ok = _bn_mismatch(state.model, _bridged(family, after["params"], after["batch_stats"]))
        assert var_err <= 1e-5 and means_ok, (i, var_err)
        free, free_metrics = step(free, ptrain.TrainBatch(*arrays))
        np.testing.assert_allclose(float(free_metrics["loss"]), after["metrics"]["loss"], rtol=5e-2)
    assert free.step == 3


def test_make_batch_matches_jax(jax_mnet):
    mine = _port_trainer().make_batch(2, max_faces=4, seed=1)
    for a, b in zip(mine, jax_mnet["batches"][1]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_remat_train_step_matches():
    """remat recomputes the backbone's blocks on the backward pass (more
    BatchNorm forwards) but updates the running statistics once: the loss,
    the updated params and the buffers match the plain step."""
    results = []
    for remat in (False, True):
        trainer = _port_trainer(remat=remat)
        state = trainer.init_state(0)
        calls = []
        for m in state.model.modules():
            if isinstance(m, layers.BatchNorm2d):
                m.register_forward_hook(lambda *a: calls.append(1))
        state, metrics = trainer.make_train_step()(state, trainer.make_batch(2, max_faces=4, seed=0))
        results.append((float(metrics["loss"]), state.model.state_dict(), len(calls)))
    (loss0, sd0, calls0), (loss1, sd1, calls1) = results
    assert calls1 > calls0
    np.testing.assert_allclose(loss0, loss1, rtol=1e-6)
    for k, v in sd0.items():
        if v.dtype.is_floating_point:
            np.testing.assert_allclose(sd1[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)


def test_ema_params_track_training():
    plain = _port_trainer()
    state0 = plain.init_state(0)
    batch = plain.make_batch(2, max_faces=4, seed=0)
    assert state0.ema_params is None
    state0, _ = plain.make_train_step()(state0, batch)
    assert state0.ema_params is None

    d = 0.5
    trainer = _port_trainer(ema_decay=d)
    state = trainer.init_state(0)
    init = {k: v.detach().clone() for k, v in state.params.items()}
    state, _ = trainer.make_train_step()(state, batch)
    for name, p in state.params.items():
        expect = d * init[name] + (1 - d) * p.detach()
        np.testing.assert_allclose(state.ema_params[name].numpy(), expect.numpy(), rtol=1e-5, atol=1e-7)
    exported = state.export_state_dict()
    assert all(torch.equal(exported[k], v) for k, v in state.ema_params.items())


def test_r50_step_matches_jax():
    """The R50 at 64x64, b1, through its own s2d stem (JAX's Trainer runs the
    XLA stem too).  At this size the stride-32 BatchNorms normalize 4 values
    per channel and both float32 runs sit 2-4e-4 from the float64 loss: the
    loss within rtol 1e-3 of JAX's and of float64, the gradient no farther
    from the float64 gradient than JAX's is, and the running variances no
    farther from float64's than JAX's are."""
    family = "retinaface_resnet50"
    run = _jax_run("resnet50", batch=1)
    after = run["after"][0]
    state, metrics = _port_step(_port_trainer("resnet50"), run["init"], run["batches"][0])
    loss64, grads64, bufs64 = _port_f64("resnet50", run["init"], run["batches"][0])
    np.testing.assert_allclose(float(metrics["loss"]), after["metrics"]["loss"], rtol=1e-3)
    np.testing.assert_allclose(float(metrics["loss"]), loss64, rtol=1e-3)
    mine, theirs = _grad_dist(state.model, _jax_grads(family, after), grads64)
    assert mine <= theirs, (mine, theirs)
    jax_bufs = {k: v for k, v in _bridged(family, after["params"], after["batch_stats"]).items() if "running" in k}
    assert _var_err(dict(state.model.named_buffers()), bufs64) <= _var_err(jax_bufs, bufs64)


def test_bf16_step_matches_jax():
    """bf16: autocast with float32 parameters in the port, flax's bf16
    compute in JAX.  Bound: each loss within 5e-2 of the float64 loss
    (measured: JAX 3.1e-2, the port 7e-3), the port's gradient no farther
    from the float64 gradient than JAX's, and float32 parameters."""
    import jax.numpy as jnp

    run = _jax_run(dtype=jnp.bfloat16)
    after = run["after"][0]
    state, metrics = _port_step(_port_trainer(dtype=torch.bfloat16), run["init"], run["batches"][0])
    loss64, grads64, _ = _port_f64("mobilenet025", run["init"], run["batches"][0])
    np.testing.assert_allclose(float(metrics["loss"]), loss64, rtol=5e-2)
    np.testing.assert_allclose(after["metrics"]["loss"], loss64, rtol=5e-2)
    mine, theirs = _grad_dist(state.model, _jax_grads("retinaface_mobilenet025", after), grads64)
    assert mine <= theirs, (mine, theirs)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
