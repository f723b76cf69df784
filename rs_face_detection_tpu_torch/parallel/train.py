"""RetinaFace training: multi-task loss, anchor matching and the train step,
on one device or sharded over a ("data", "model") mesh of ranks.

Counterpart of rs_face_detection_tpu/parallel/train.py.  The loss is the
RetinaFace paper's: 2-class softmax CE with hard-negative mining (OHEM) +
smooth-L1 box regression + smooth-L1 landmark regression over matched
anchors, computed for the whole batch at once where JAX vmaps it over
images.  The optimizer is optax's ``adamw`` as ``torch.optim.AdamW`` with
two parameter groups (decay on leaves of more than one dimension only), the
schedule optax's ``warmup_cosine_decay_schedule`` read at the count of
updates made before the step, and the EMA the JAX step's
``d * e + (1 - d) * p`` after each update.

A ``TrainState`` owns its module (parameters and BatchNorm buffers, whose
statistics follow flax's: models/layers.py::BatchNorm2d) and its optimizer;
the step updates them in place, as the JAX step consumes its donated state,
and returns the state.

With ``Trainer(mesh=...)`` (parallel/mesh.py::make_mesh; one process per
rank) the module is sharded by FSDP2 under the JAX package's FSDP rule
before the optimizer is built, every rank takes its data index's rows of
the global batch (``make_batch``, ``DetectionDataLoader.batches(mesh=)``),
the BatchNorms take the global batch's statistics over the "data" axis, and
the metrics the step returns are the global batch's means, the same on
every rank: the JAX step over a batch sharded on "data".  FSDP2 averages
the gradients over every rank; with the global statistics that is the
gradient of the mean loss over the global batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..configs import RPN_ANCHOR_CFG, FaceDetectionConfig
from ..models.layers import sync_batch_stats
from ..models.retinaface import RetinaFace
from ..models.weights import seeded_state, state_dict_from_jax
from ..ops.anchors import full_anchor_table
from ..ops.box_decode import bbox_overlaps
from ..utils.device import DeviceLike, resolve_device, to_device
from .mesh import axis_size, data_rows, shard_pytree_fsdp


class TrainBatch(NamedTuple):
    """One training batch with fixed-shape (padded) ground truth, arrays or
    tensors.

    images: (B, H, W, 3) float32 RGB in the raw 0-255 pixel range.
    gt_boxes: (B, M, 4) corner boxes; gt_lms: (B, M, 5, 2); gt_valid: (B, M).
    gt_lm_valid: (B, M) per-face landmark availability; None means all.
    gt_ignore: (B, K, 4) ignore regions (zero-area rows are padding); None
    means none.
    """

    images: Any
    gt_boxes: Any
    gt_lms: Any
    gt_valid: Any
    gt_lm_valid: Any = None
    gt_ignore: Any = None


@dataclass
class TrainState:
    """The module (parameters and BatchNorm buffers), its AdamW optimizer,
    the number of steps taken and, with ``Trainer(ema_decay>0)``, the
    exponential moving average of the parameters (the weights to export)."""

    model: RetinaFace
    optimizer: torch.optim.AdamW
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return {
            name: buf for name, buf in self.model.named_buffers()
            if not name.endswith("num_batches_tracked")
        }

    def export_state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's state_dict on the CPU with the EMA parameters in
        place of the raw ones when they are kept: what the entry point
        exports.  A sharded state is gathered whole (a collective: every
        rank calls it)."""
        sd = {k: _full(v) for k, v in self.model.state_dict().items()}
        if self.ema_params is not None:
            sd.update({k: _full(v) for k, v in self.ema_params.items()})
        return sd


def _full(t: torch.Tensor) -> torch.Tensor:
    """A detached CPU copy of a tensor, gathered whole if it is a DTensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().clone()


def _smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    absx = x.abs()
    return torch.where(absx < beta, 0.5 * x * x / beta, absx - 0.5 * beta)


def _centers_sizes(boxes: torch.Tensor):
    """(w, h, cx, cy) under the +1 inclusive-corner convention, shared by
    box encoding and landmark targets."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * (w - 1.0)
    cy = boxes[..., 1] + 0.5 * (h - 1.0)
    return w, h, cx, cy


def _intersection_over_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (..., M, 4) -> (..., N, M) intersection area over the smaller
    box area (+1 convention)."""
    a_, b_ = a[..., :, None, :], b[..., None, :, :]
    iw = torch.clamp(torch.minimum(a_[..., 2], b_[..., 2]) - torch.maximum(a_[..., 0], b_[..., 0]) + 1.0, min=0.0)
    ih = torch.clamp(torch.minimum(a_[..., 3], b_[..., 3]) - torch.maximum(a_[..., 1], b_[..., 1]) + 1.0, min=0.0)
    area_a = (a_[..., 2] - a_[..., 0] + 1.0) * (a_[..., 3] - a_[..., 1] + 1.0)
    area_b = (b_[..., 2] - b_[..., 0] + 1.0) * (b_[..., 3] - b_[..., 1] + 1.0)
    return iw * ih / torch.minimum(area_a, area_b)


def _encode_boxes(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Corner gt -> center/size deltas against the anchors: the inverse of
    ops/box_decode.py::bbox_pred."""
    aw, ah, acx, acy = _centers_sizes(anchors)
    gw, gh, gcx, gcy = _centers_sizes(gt)
    return torch.stack(
        [(gcx - acx) / (aw + 1e-14), (gcy - acy) / (ah + 1e-14), torch.log(gw / aw), torch.log(gh / ah)],
        dim=-1,
    )


def match_anchors(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    pos_iou: float = 0.5,
    neg_iou: float = 0.3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Match (N,) anchors to (..., M) padded ground truth.

    Returns (labels, best_gt, max_iou), each (..., N): labels in {1 pos,
    0 neg, -1 ignore}, best_gt the matched gt row.  Every valid gt's best
    anchor is forced positive; the force is a scatter-max, so a padded gt
    whose argmax lands on the same anchor cannot undo a valid gt's.
    """
    iou = bbox_overlaps(anchors, gt_boxes)  # (..., N, M)
    iou = torch.where(gt_valid[..., None, :], iou, torch.full_like(iou, -1.0))
    best_gt = torch.argmax(iou, dim=-1)
    max_iou = torch.amax(iou, dim=-1)
    labels = torch.where(
        max_iou >= pos_iou, 1, torch.where(max_iou < neg_iou, 0, -1)
    )
    best_anchor = torch.argmax(iou, dim=-2)  # (..., M)
    forced = torch.zeros(labels.shape, dtype=torch.int64, device=labels.device).scatter_reduce(
        -1, best_anchor, gt_valid.long(), "amax"
    ).bool()
    labels = torch.where(forced, 1, labels)
    best_gt = torch.where(forced & (max_iou <= 0.0), torch.zeros_like(best_gt), best_gt)
    return labels, best_gt, max_iou


def flatten_raw_outputs(
    net_out: Dict[int, Dict[str, torch.Tensor]],
    level_order: Tuple[int, ...],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-level raw maps -> (..., N, 2) logits, (..., N, 4) deltas and
    (..., N, 5, 2) landmark deltas in anchor-table order, for one image
    ((H, W, A, 2) maps) or a batch."""
    logits_l, box_l, lm_l = [], [], []
    for stride in level_order:
        maps = net_out[stride]
        lead = maps["score"].shape[:-4]
        logits_l.append(maps["score"].reshape(*lead, -1, 2))
        box_l.append(maps["bbox"].reshape(*lead, -1, 4))
        lm_l.append(maps["landmark"].reshape(*lead, -1, 5, 2))
    dim = len(lead)
    return torch.cat(logits_l, dim), torch.cat(box_l, dim), torch.cat(lm_l, dim)


def detection_loss(
    logits: torch.Tensor,
    box_deltas: torch.Tensor,
    lm_deltas: torch.Tensor,
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_lms: torch.Tensor,
    gt_valid: torch.Tensor,
    box_weight: float = 2.0,
    lm_weight: float = 1.0,
    ohem_ratio: float = 3.0,
    pos_iou: float = 0.5,
    neg_iou: float = 0.3,
    gt_lm_valid: Optional[torch.Tensor] = None,
    ignore_boxes: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RetinaFace multi-task loss of one image ((N, 2) logits, (M, 4) gt) or
    of a batch ((B, N, 2), (B, M, 4)); per-image totals and parts.

    OHEM keeps every positive and the hardest negatives, ``ohem_ratio`` per
    positive, ranked by a stable sort so that negatives of equal loss count
    in anchor order, as JAX's ``argsort`` does (with zero-initialised heads
    every negative's loss is ln 2, and the ties decide which count).
    Anchors whose intersection over the smaller box is >= 0.5 with a
    non-degenerate ignore row leave the negative pool.
    """
    single = logits.dim() == 2
    if single:
        logits, box_deltas, lm_deltas, gt_boxes, gt_lms, gt_valid = (
            t[None] for t in (logits, box_deltas, lm_deltas, gt_boxes, gt_lms, gt_valid)
        )
        gt_lm_valid = None if gt_lm_valid is None else gt_lm_valid[None]
        ignore_boxes = None if ignore_boxes is None else ignore_boxes[None]
    labels, best_gt, _ = match_anchors(anchors, gt_boxes, gt_valid, pos_iou=pos_iou, neg_iou=neg_iou)
    if ignore_boxes is not None and ignore_boxes.shape[-2]:
        valid_ign = (ignore_boxes[..., 2] > ignore_boxes[..., 0]) & (ignore_boxes[..., 3] > ignore_boxes[..., 1])
        iom = _intersection_over_min(anchors, ignore_boxes)
        iom = torch.where(valid_ign[..., None, :], iom, torch.zeros_like(iom))
        labels = torch.where((labels == 0) & (torch.amax(iom, dim=-1) >= 0.5), -1, labels)
    pos = labels == 1
    neg = labels == 0
    num_pos = torch.clamp(pos.sum(dim=-1), min=1)

    # Classification CE with hard-negative mining: rank[i] = the number of
    # negatives ahead of i in the stable descending order of their loss.
    logp = F.log_softmax(logits, dim=-1)
    target = torch.clamp(labels, 0, 1)
    ce = -torch.gather(logp, -1, target[..., None])[..., 0]
    neg_ce = torch.where(neg, ce.detach(), torch.full_like(ce, -math.inf))
    order = torch.argsort(-neg_ce, dim=-1, stable=True)
    ranks = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ranks)
    keep_neg = neg & (rank < (ohem_ratio * num_pos).to(rank.dtype)[..., None])
    zero = torch.zeros_like(ce)
    cls_loss = (torch.where(pos, ce, zero).sum(-1) + torch.where(keep_neg, ce, zero).sum(-1)) / num_pos

    # Box regression on positives.
    matched_boxes = torch.gather(gt_boxes, -2, best_gt[..., None].expand(*best_gt.shape, 4))
    box_err = _smooth_l1(box_deltas - _encode_boxes(anchors, matched_boxes))
    box_loss = torch.where(pos[..., None], box_err, torch.zeros_like(box_err)).sum((-2, -1)) / num_pos

    # Landmark regression on the positives whose face has landmarks,
    # normalized by their own count.
    aw, ah, acx, acy = _centers_sizes(anchors)
    matched_lms = torch.gather(gt_lms, -3, best_gt[..., None, None].expand(*best_gt.shape, 5, 2))
    lm_targets = torch.stack(
        [(matched_lms[..., 0] - acx[:, None]) / aw[:, None], (matched_lms[..., 1] - acy[:, None]) / ah[:, None]],
        dim=-1,
    )
    lm_ok = pos if gt_lm_valid is None else pos & torch.gather(gt_lm_valid, -1, best_gt)
    num_lm = torch.clamp(lm_ok.sum(dim=-1), min=1)
    lm_err = _smooth_l1(lm_deltas - lm_targets)
    lm_loss = torch.where(lm_ok[..., None, None], lm_err, torch.zeros_like(lm_err)).sum((-3, -2, -1)) / num_lm

    total = cls_loss + box_weight * box_loss + lm_weight * lm_loss
    metrics = {"cls_loss": cls_loss, "box_loss": box_loss, "lm_loss": lm_loss, "num_pos": num_pos.float()}
    if single:
        return total[0], {k: v[0] for k, v in metrics.items()}
    return total, metrics


def arcface_margin_loss(
    embeddings: torch.Tensor,
    labels: torch.Tensor,
    class_weights: torch.Tensor,
    margin: float = 0.5,
    scale: float = 64.0,
) -> torch.Tensor:
    """Additive-angular-margin softmax loss (ArcFace): cosine logits between
    L2-normalized (B, D) embeddings and (C, D) class weights, the target
    angle shifted by ``margin`` (past pi - margin the linear fallback
    cos - margin * sin(margin)), all scaled by ``scale``."""
    emb = embeddings / torch.clamp(torch.linalg.norm(embeddings, dim=1, keepdim=True), min=1e-12)
    w = class_weights / torch.clamp(torch.linalg.norm(class_weights, dim=1, keepdim=True), min=1e-12)
    cos = torch.clamp(emb @ w.T, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos)
    target = F.one_hot(labels.long(), class_weights.shape[0]).to(cos.dtype)
    margined = torch.where(theta <= math.pi - margin, torch.cos(theta + margin), cos - margin * math.sin(margin))
    logits = scale * torch.where(target > 0, margined, cos)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(target * logp, dim=-1))


def _weight_decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """True for the leaves that take weight decay: conv kernels; biases and
    normalization scales and offsets (every 1-D leaf) are exempt."""
    return {name: p.dim() > 1 for name, p in params.items()}


def warmup_cosine_decay_schedule(peak_value: float, warmup_steps: int, decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay) as a
    function of the update count: linear from 0 over ``warmup_steps``, then
    cosine to 0 over ``decay_steps - warmup_steps`` (``decay_steps``
    counts the warmup)."""
    span = decay_steps - warmup_steps
    if not span > 0:
        raise ValueError(f"the cosine decay needs decay_steps > warmup_steps, got {decay_steps} and {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return -peak_value * frac + peak_value
        c = min(count - warmup_steps, span)
        return peak_value * (0.5 * (1.0 + math.cos(math.pi * c / span)))

    return schedule


class Trainer:
    """RetinaFace trainer on one device, or with ``mesh`` on this rank's
    device of a ("data", "model") mesh: data parallel over "data", FSDP
    parameters over "model" (``device``: the card by default)."""

    def __init__(
        self,
        cfg: Optional[FaceDetectionConfig] = None,
        learning_rate: float = 1e-3,
        dtype: torch.dtype = torch.float32,
        pos_iou: float = 0.5,
        neg_iou: float = 0.3,
        remat: bool = False,
        warmup_steps: int = 0,
        total_steps: int = 0,
        weight_decay: float = 1e-4,
        ema_decay: float = 0.0,
        mesh: Optional[DeviceMesh] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        """pos/neg_iou: the anchor-match thresholds (detection_loss).
        dtype: float32, or bfloat16 for autocast with float32 parameters.
        remat: recompute the backbone's blocks on the backward pass.
        total_steps > 0 turns on linear warmup then cosine decay.
        mesh: parallel/mesh.py::make_mesh's mesh, on ``device``'s type."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a mesh of {mesh.device_type} devices for a Trainer on {self.device}")
        self.cfg = cfg or FaceDetectionConfig()
        self.pos_iou = pos_iou
        self.neg_iou = neg_iou
        self.dtype = dtype
        self.remat = remat
        anchors, level_info = full_anchor_table(
            self.cfg.image_size, RPN_ANCHOR_CFG, self.cfg.feat_strides, self.cfg.dense_anchor
        )
        self.anchors = torch.from_numpy(anchors).to(self.device)
        counts = {a for _stride, _fh, _fw, a in level_info}
        if len(counts) != 1:
            raise ValueError(f"per-level anchor counts differ: {sorted(counts)}")
        self.num_anchors = counts.pop()
        if total_steps > 0:
            self.schedule = warmup_cosine_decay_schedule(learning_rate, max(warmup_steps, 1), total_steps)
        else:
            self.schedule = lambda count: learning_rate
        self.weight_decay = weight_decay
        self.ema_decay = float(ema_decay)

    @property
    def family(self) -> str:
        return f"retinaface_{self.cfg.backbone}"

    def new_model(self) -> RetinaFace:
        """A RetinaFace of the trainer's backbone, anchors and remat, on the
        CPU, with untouched default weights."""
        return RetinaFace(self.cfg.backbone, self.num_anchors, remat=self.remat)

    def init_state(self, seed: int = 0, variables: Any = None) -> TrainState:
        """A fresh state: seeded weights (models/weights.py::seeded_state,
        flax's default initializers drawn from numpy), or the JAX package's
        ``variables`` (or a registry .npz) bridged by
        models/weights.py::state_dict_from_jax."""
        model = self.new_model()
        sd = seeded_state(model, seed) if variables is None else state_dict_from_jax(self.family, variables)
        model.load_state_dict(sd)
        model.to(self.device).train()
        if self.mesh is not None:
            if axis_size(self.mesh, "data") > 1:
                sync_batch_stats(model, self.mesh.get_group("data"))
            shard_pytree_fsdp(model, self.mesh)
        mask = _weight_decay_mask(dict(model.named_parameters()))
        decay = [p for n, p in model.named_parameters() if mask[n]]
        rest = [p for n, p in model.named_parameters() if not mask[n]]
        optimizer = torch.optim.AdamW(
            [{"params": decay, "weight_decay": self.weight_decay}, {"params": rest, "weight_decay": 0.0}],
            lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
        )
        ema = {n: p.detach().clone() for n, p in model.named_parameters()} if self.ema_decay > 0 else None
        return TrainState(model, optimizer, 0, ema)

    def prepare(self, batch: TrainBatch) -> TrainBatch:
        """The batch as tensors on the trainer's device, with a missing
        ``gt_lm_valid`` filled with ones and a missing ``gt_ignore`` with one
        zero row per image."""
        dev = self.device
        images, boxes, lms = (to_device(t, dev).float() for t in batch[:3])
        valid = to_device(batch.gt_valid, dev).bool()
        lm_valid = torch.ones_like(valid) if batch.gt_lm_valid is None else to_device(batch.gt_lm_valid, dev).bool()
        ignore = (
            torch.zeros((valid.shape[0], 1, 4), dtype=torch.float32, device=dev)
            if batch.gt_ignore is None else to_device(batch.gt_ignore, dev).float()
        )
        return TrainBatch(images, boxes, lms, valid, lm_valid, ignore)

    def forward(self, model: RetinaFace, images: torch.Tensor) -> Dict[int, Dict[str, torch.Tensor]]:
        """The raw maps of (B, H, W, 3) images, the module in its current
        mode (under bf16 autocast with ``dtype=torch.bfloat16``)."""
        x = images.permute(0, 3, 1, 2).contiguous()
        with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.dtype == torch.bfloat16):
            return model(x, raw=True)

    def loss(
        self, net_out: Dict[int, Dict[str, torch.Tensor]], batch: TrainBatch
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Per-image losses and their parts of the raw maps against a
        prepared batch, in float32 (float64 maps stay float64)."""
        flat = flatten_raw_outputs(net_out, tuple(self.cfg.feat_strides))
        logits, boxes, lms = (t.to(torch.promote_types(t.dtype, torch.float32)) for t in flat)
        return detection_loss(
            logits, boxes, lms, self.anchors.to(logits.dtype), batch.gt_boxes, batch.gt_lms, batch.gt_valid,
            pos_iou=self.pos_iou, neg_iou=self.neg_iou,
            gt_lm_valid=batch.gt_lm_valid, ignore_boxes=batch.gt_ignore,
        )

    def make_train_step(self) -> Callable[[TrainState, TrainBatch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
        """``step(state, batch) -> (state, metrics)``: one AdamW update of
        the mean per-image loss, made in place; the metrics are 0-d tensors
        on the device (the batch means of the parts, and ``loss``).  With a
        mesh, ``batch`` is this rank's rows of the global batch and the
        metrics are the global batch's."""

        def step(state: TrainState, batch: TrainBatch):
            batch = self.prepare(batch)
            model, opt = state.model, state.optimizer
            model.train()
            lr = self.schedule(state.step)
            for group in opt.param_groups:
                group["lr"] = lr
            losses, metrics = self.loss(self.forward(model, batch.images), batch)
            loss = losses.mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            if state.ema_params is not None:
                d = self.ema_decay
                with torch.no_grad():
                    names = list(state.ema_params)
                    ema = [state.ema_params[n] for n in names]
                    params = dict(model.named_parameters())
                    torch._foreach_mul_(ema, d)
                    torch._foreach_add_(ema, torch._foreach_mul([params[n].detach() for n in names], 1.0 - d))
            state.step += 1
            out = {k: v.detach().mean() for k, v in metrics.items()}
            out["loss"] = loss.detach()
            if self.mesh is not None:
                out = self._global_means(out)
            return state, out

        return step

    def _global_means(self, local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Means over the "data" axis of each rank's batch means (equal
        shares of the global batch): the global batch's means."""
        data = axis_size(self.mesh, "data")
        if data == 1:
            return local
        names = list(local)
        summed = torch.stack([local[k] for k in names])
        dist.all_reduce(summed, group=self.mesh.get_group("data"))
        return {k: v / data for k, v in zip(names, summed.unbind())}

    def make_batch(self, batch_size: int, max_faces: int = 8, seed: int = 0) -> TrainBatch:
        """Synthetic batch for smoke tests, on the trainer's device: the JAX
        Trainer's ``make_batch`` arrays for the same arguments (with a mesh,
        this rank's rows of them; ``batch_size`` is the global batch)."""
        rng = np.random.default_rng(seed)
        width, height = self.cfg.image_size
        images = rng.uniform(0, 255, (batch_size, height, width, 3)).astype(np.float32)
        x1 = rng.uniform(0, width * 0.6, (batch_size, max_faces))
        y1 = rng.uniform(0, height * 0.6, (batch_size, max_faces))
        bw = rng.uniform(8, width * 0.3, (batch_size, max_faces))
        bh = rng.uniform(8, height * 0.3, (batch_size, max_faces))
        boxes = np.stack([x1, y1, x1 + bw, y1 + bh], axis=-1).astype(np.float32)
        lms = np.stack(
            [
                x1[..., None] + bw[..., None] * rng.uniform(0.2, 0.8, (batch_size, max_faces, 5)),
                y1[..., None] + bh[..., None] * rng.uniform(0.2, 0.8, (batch_size, max_faces, 5)),
            ],
            axis=-1,
        ).astype(np.float32)
        valid = np.arange(max_faces)[None, :] < rng.integers(1, max_faces + 1, batch_size)[:, None]
        rows = data_rows(self.mesh, batch_size)
        dev = self.device
        return TrainBatch(*(torch.from_numpy(a[rows]).to(dev) for a in (images, boxes, lms, valid)))
