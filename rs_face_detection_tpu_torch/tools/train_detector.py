"""Train a RetinaFace detector on a real dataset and write a registry checkpoint.

Counterpart of the JAX package's tools/train_detector.py, with the same
flags, plus ``--device`` (default ``cuda``) in place of the device mesh:

    python -m rs_face_detection_tpu_torch.tools.train_detector \\
        --labels widerface/train/label.txt --images widerface/train/images \\
        --out face_detection_retina.npz [--backbone mobilenet025] [--size 640x640] \\
        [--batch 8] [--steps 1000] [--lr 1e-3] [--max-faces 32] [--remat] \\
        [--wider-gt] [--device cpu]

Data flows through parallel/data.py::DetectionDataLoader (the serving
letterbox, static-padded ground truth, per-face landmark validity) into
parallel/train.py::Trainer.  The output is the JAX package's registry .npz
(models/weights.py::save_flax_checkpoint): put it in $RSFD_CHECKPOINT_DIR to
serve it from either package.  ``--checkpoint-dir`` saves the train state
every ``--save-every`` steps (parallel/checkpoint.py) and resumes from the
latest; with ``--eval-every`` and ``--val-labels`` the output holds the
best-validation-AP weights (the AP of ops/eval.py::evaluate_detector through
the port's RetinaFaceDetection), recorded in ``<out>.bestap.json`` so that a
resumed run never overwrites a better checkpoint.

Under ``torchrun`` (``python -m torch.distributed.run --nproc-per-node N -m
rs_face_detection_tpu_torch.tools.train_detector ...``) it trains data
parallel over the N processes, one card each (gloo with ``--device cpu``):
``--batch`` is the global batch and must divide by N, every rank decodes its
rows of each batch and saves its shards of the train state, and only rank 0
writes the .npz, its sidecar and the log.  Without ``torchrun`` it runs in
one process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--labels", required=True, help="label.txt (RetinaFace format) or wider bbx_gt file")
    p.add_argument("--images", required=True, help="image root directory")
    p.add_argument("--out", required=True, help="output .npz checkpoint")
    p.add_argument("--wider-gt", action="store_true",
                   help="labels are WIDER bbx_gt (boxes only) instead of the RetinaFace label.txt format")
    p.add_argument("--backbone", default="mobilenet025", choices=["mobilenet025", "resnet50"])
    p.add_argument("--size", default="640x640")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max-faces", type=int, default=32)
    p.add_argument("--pos-iou", type=float, default=0.5)
    p.add_argument("--neg-iou", type=float, default=0.3)
    p.add_argument("--remat", action="store_true", help="recompute backbone blocks (less activation memory)")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help=">0 turns on linear-warmup + cosine decay to --steps")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help=">0 tracks an EMA of params and exports THOSE weights (e.g. 0.999)")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--val-labels", default=None,
                   help="validation annotations (same format as --labels); with --eval-every, the exported "
                   "checkpoint is the best-val-AP weights instead of the final step's")
    p.add_argument("--val-images", default=None, help="validation image root (default: --images)")
    p.add_argument("--val-max-images", type=int, default=64, help="cap on validation images per eval")
    p.add_argument("--eval-every", type=int, default=0, help=">0: evaluate val AP every N steps (needs --val-labels)")
    p.add_argument("--val-iou", type=float, default=0.5)
    p.add_argument("--checkpoint-dir", default=None,
                   help="train-state directory: saves every --save-every steps and auto-resumes from the latest")
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--device", default="cuda", help="torch device (default: the card; 'cpu' for small runs)")
    args = p.parse_args(argv)
    if args.eval_every > 0 and not args.val_labels:
        raise SystemExit("--eval-every needs --val-labels")
    return args


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)

    import cv2
    import numpy as np

    from ..utils.device import resolve_device

    device = resolve_device(args.device)  # no card, no work: raise before reading the data
    import torch.distributed as dist

    from ..parallel.mesh import initialize_distributed, make_mesh

    mesh = None
    if "WORLD_SIZE" in os.environ:  # launched by torchrun: one process per card
        world = int(os.environ["WORLD_SIZE"])
        if args.batch % world:  # refused before any rank joins the group
            raise SystemExit(f"--batch {args.batch} not divisible by {world} processes")
        initialize_distributed(device=args.device)
        mesh = make_mesh(world, device=args.device)
        device = resolve_device(args.device)  # this rank's card
    rank0 = mesh is None or dist.get_rank() == 0
    log = print if rank0 else (lambda *a, **k: None)

    from ..configs import FaceDetectionConfig
    from ..models.weights import save_flax_checkpoint
    from ..ops.eval import evaluate_detector
    from ..parallel.checkpoint import latest_step, restore_train_state, save_train_state
    from ..parallel.data import DetectionDataLoader, parse_retinaface_label, wider_examples
    from ..parallel.train import Trainer
    from ..pipeline.detection import RetinaFaceDetection

    read_labels = wider_examples if args.wider_gt else parse_retinaface_label
    examples = read_labels(args.labels)
    log(f"{len(examples)} annotated images from {args.labels}")
    if len(examples) < args.batch:
        # The loader yields only full batches per epoch.
        raise SystemExit(
            f"{len(examples)} examples < --batch {args.batch}; lower --batch or check the labels file format"
        )

    w, h = (int(v) for v in args.size.lower().split("x"))
    cfg = FaceDetectionConfig(backbone=args.backbone, image_size=(w, h))
    trainer = Trainer(
        cfg, learning_rate=args.lr, pos_iou=args.pos_iou, neg_iou=args.neg_iou, remat=args.remat,
        warmup_steps=args.warmup_steps, total_steps=args.steps if args.warmup_steps > 0 else 0,
        ema_decay=args.ema_decay, mesh=mesh, device=device,
    )

    # Validation set: (original BGR image, gt boxes in original coordinates).
    val_set = []
    if args.val_labels:
        val_root = args.val_images or args.images
        for ex in read_labels(args.val_labels)[: args.val_max_images]:
            img = cv2.imread(os.path.join(val_root, ex.rel_path))
            if img is not None:
                val_set.append((img, np.asarray(ex.boxes, np.float32).reshape(-1, 4)))
        log(f"{len(val_set)} validation images from {args.val_labels}")
        if args.eval_every > 0 and not val_set:
            # Every eval would be skipped and nothing exported.
            raise SystemExit(
                f"no readable validation images under {val_root!r} (--eval-every {args.eval_every} would never run)"
            )

    def eval_ap(st) -> float:
        # Every rank evaluates the same gathered weights on the same images,
        # so the ranks agree on each new best.
        model = trainer.new_model()
        model.load_state_dict(st.export_state_dict())
        det = RetinaFaceDetection(cfg, model=model, device=trainer.device)
        return evaluate_detector(det, val_set, iou_threshold=args.val_iou)["ap"]

    state = trainer.init_state(seed=0)
    start = 0
    if args.checkpoint_dir and latest_step(args.checkpoint_dir) is not None:
        state = restore_train_state(args.checkpoint_dir, state)
        start = state.step
        log(f"resumed from step {start} ({args.checkpoint_dir})")

    step_fn = trainer.make_train_step()
    sidecar = args.out + ".bestap.json"
    best_ap, wrote_best = -1.0, False
    if args.eval_every > 0 and os.path.exists(sidecar):
        if os.path.exists(args.out):
            try:
                with open(sidecar) as f:
                    best_ap = float(json.load(f)["ap"])
                log(f"previous best val AP {best_ap:.4f} ({sidecar})")
            except (OSError, ValueError, KeyError):
                pass
        else:
            # A sidecar without its checkpoint would suppress every write.
            log(f"ignoring stale {sidecar} (no {args.out} next to it)")
            if rank0:
                os.remove(sidecar)

    t0 = time.perf_counter()
    g = start
    with DetectionDataLoader(
        examples, args.images, image_size=(w, h), batch_size=args.batch, max_faces=args.max_faces
    ) as loader:
        for i, batch in enumerate(loader.batches(epochs=None, device=trainer.device, mesh=mesh)):
            if g >= args.steps:
                break
            state, metrics = step_fn(state, batch)
            g = start + i + 1
            if (g - 1) % args.log_every == 0 or g == args.steps:
                m = {k: float(v) for k, v in metrics.items()}
                log(
                    f"step {g - 1}: loss={m['loss']:.4f} cls={m['cls_loss']:.4f} box={m['box_loss']:.4f} "
                    f"lm={m['lm_loss']:.4f} pos={m['num_pos']:.1f} ({(time.perf_counter() - t0) / (i + 1):.2f}s/step)"
                )
            if args.eval_every > 0 and val_set and (g % args.eval_every == 0 or g == args.steps):
                ap = eval_ap(state)
                marker = ""
                if ap > best_ap:
                    best_ap = ap
                    sd = state.export_state_dict()
                    if rank0:
                        save_flax_checkpoint(args.out, trainer.family, sd)
                        with open(sidecar, "w") as f:
                            json.dump({"ap": ap, "step": g}, f)
                    wrote_best = True
                    marker = f"  (new best -> {args.out})"
                log(f"step {g}: val AP {ap:.4f}{marker}")
            if args.checkpoint_dir and (g % args.save_every == 0 or g == args.steps):
                save_train_state(args.checkpoint_dir, state, step=g)

    if args.eval_every > 0:
        # --out already holds the best-val-AP weights (written on each new
        # best, possibly by an earlier run of a resumed job).
        if wrote_best:
            log(f"{args.out} = best-val-AP {best_ap:.4f} weights")
        elif os.path.exists(args.out):
            log(f"no eval beat the recorded best ({best_ap:.4f}); {args.out} left untouched")
        else:
            log("WARNING: no eval ran and no prior checkpoint exists; nothing written")
    else:
        which = "EMA" if state.ema_params is not None else "raw"
        sd = state.export_state_dict()
        if rank0:
            save_flax_checkpoint(args.out, trainer.family, sd)
        log(f"wrote {args.out} ({which} weights)")
    if mesh is not None:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
