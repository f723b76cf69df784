"""Evaluate a detector on a local WIDER FACE validation tree.

Counterpart of the JAX package's tools/eval_wider.py, with the same flags
and the same last JSON line, plus ``--device`` (default ``cuda``):

    # overall AP from the txt annotations:
    python -m rs_face_detection_tpu_torch.tools.eval_wider --root /data/WIDER \\
        [--backbone resnet50] [--checkpoint path.npz] [--size 640] [--max-images N]

    # the official per-difficulty AP from the .mat side files:
    python -m rs_face_detection_tpu_torch.tools.eval_wider --root /data/WIDER --split all

    # multi-scale + flip TTA (the published WIDER protocol):
    python -m rs_face_detection_tpu_torch.tools.eval_wider --root /data/WIDER --split all \\
        --tta --tta-sizes 640,1280

The tree is ``<root>/WIDER_val/images/<event>/<image>.jpg`` and
``<root>/wider_face_split/`` (``wider_face_val_bbx_gt.txt``, the official
``.mat`` files).  Detection runs through ``DetectionServer.detect_stream``
(batched; one NMS launch per batch on the card) unless ``--no-batched``
or ``--tta``.  ``--checkpoint`` takes a fixture ``.npz`` (the JAX package's
registry file, bridged by models/weights.py) or a self-describing file
with ``__meta__`` (models/checkpoint_io.py); without one the registry
serves ``$RSFD_CHECKPOINT_DIR/<model_name>.npz`` or seeded weights.
"""

import argparse
import dataclasses
import json
import os
import sys


def build_detector(args):
    from ..configs import FaceDetectionConfig
    from ..models.checkpoint_io import load_imported_model, registry_checkpoint_path
    from ..pipeline.detection import RetinaFaceDetection
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    if args.detector == "scrfd":
        return build_scrfd_detector(args, device)
    # Dense-scene eval cap: WIDER-hard crowd scenes need more NMS candidates
    # than the 128 serving default, so the protocol pins 256 (--max-candidates).
    cfg = FaceDetectionConfig(
        backbone=args.backbone,
        image_size=(args.size, args.size),
        max_candidates=args.max_candidates,
        confidence_threshold=args.confidence,
        candidate_selection=args.candidate_selection,
    )
    if args.checkpoint:
        import numpy as np

        with np.load(args.checkpoint) as z:
            has_meta = "__meta__" in z.files
        if has_meta:
            model = load_imported_model(args.checkpoint, expect_family="retinaface")
            return RetinaFaceDetection(cfg, model, device)
        from ..utils.fixtures import load_trained_detector

        return load_trained_detector(args.checkpoint, cfg, device)
    if registry_checkpoint_path(cfg.model_name) is None:
        print("WARNING: seeded random weights (no --checkpoint) — AP will be ~0")
    return RetinaFaceDetection(cfg, device=device)


def build_scrfd_detector(args, device):
    """The eKYC pipeline's SCRFD detector: ``--checkpoint`` takes a
    self-describing file (models/checkpoint_io.py); without one the registry
    serves ``$RSFD_CHECKPOINT_DIR/scrfd.npz`` or seeded weights."""
    from ..models.checkpoint_io import load_imported_model, registry_checkpoint_path
    from ..pipeline.ekyc_pipeline import SCRFDDetection

    size = (args.size, args.size)
    model = None
    if args.checkpoint:
        model = load_imported_model(args.checkpoint, expect_family="scrfd")
    elif registry_checkpoint_path("scrfd") is None:
        print("WARNING: seeded random weights (no --checkpoint) — AP will be ~0")
    return SCRFDDetection(
        model=model, device=device, image_size=size, confidence_threshold=args.confidence
    )


def wrap_tta(det, args):
    """Multi-scale + flip TTA: one detector per size in --tta-sizes (the
    base --size always included), sharing the base detector's module and,
    for SCRFD, its select/NMS settings."""
    from ..pipeline.detection import RetinaFaceDetection
    from ..pipeline.ekyc_pipeline import SCRFDDetection
    from ..pipeline.tta import TTADetection
    from ..serving.detection_server import detector_image_size

    sizes = sorted({int(s) for s in args.tta_sizes.split(",")} | {args.size})
    detectors = [det]
    for s in sizes:
        if (s, s) == detector_image_size(det):
            continue
        if isinstance(det, SCRFDDetection):
            sel = det.sel_cfg
            detectors.append(
                SCRFDDetection(
                    model=det.model, device=det.device, image_size=(s, s),
                    confidence_threshold=sel.confidence_threshold,
                    iou_threshold=sel.iou_threshold,
                    max_candidates=sel.max_candidates,
                    max_detections=sel.max_detections,
                )
            )
        else:
            detectors.append(
                RetinaFaceDetection(dataclasses.replace(det.cfg, image_size=(s, s)), det.model, det.device)
            )
    return TTADetection(detectors, flip=not args.tta_no_flip, merge=args.tta_merge)


def make_detect_many(det, args):
    """A path-list detector: TTA or single images one by one, else the
    DetectionServer stream over the files' bytes."""
    from ..ops.wider import read_image

    if args.tta or args.no_batched:
        # TTA runs several views per image and merges on the host: the
        # accuracy protocol's path, not the batched serving path.
        one = wrap_tta(det, args) if args.tta else det

        def detect_many(paths):
            for p in paths:
                yield one(read_image(p))

        return detect_many

    from ..serving.detection_server import DetectionServer

    def detect_many(paths):
        def payloads():
            for p in paths:
                with open(p, "rb") as f:
                    yield f.read()

        with DetectionServer(det, batch_size=args.batch_size) as server:
            for batch in server.detect_stream(payloads()):
                yield from batch

    return detect_many


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m rs_face_detection_tpu_torch.tools.eval_wider")
    parser.add_argument("--root", default=None, help="WIDER root directory")
    parser.add_argument("--backbone", default="resnet50")
    parser.add_argument(
        "--detector",
        default="retinaface",
        choices=("retinaface", "scrfd"),
        help="detector family: the RetinaFace pipeline (default) or the "
        "eKYC pipeline's SCRFD (both ride DetectionServer batching)",
    )
    parser.add_argument("--checkpoint", default=None, help=".npz trained weights")
    parser.add_argument("--size", type=int, default=640)
    parser.add_argument(
        "--device", default="cuda", help="torch device to detect on (default: the CUDA card)"
    )
    parser.add_argument(
        "--confidence",
        type=float,
        default=0.02,
        help="detector confidence threshold; AP protocols keep it low "
        "(0.02, the insightface eval convention) so the precision/recall "
        "ranking sees the full score range",
    )
    parser.add_argument(
        "--candidate-selection",
        default="exact",
        choices=("exact", "approx"),
        dest="candidate_selection",
        help="pre-NMS top-k mode; approx runs the exact top-k, as "
        "jax.lax.approx_max_k does off the TPU (recall 1 >= its 0.95 target)",
    )
    parser.add_argument(
        "--max-candidates",
        type=int,
        default=256,
        dest="max_candidates",
        help="pre-NMS candidate cap (retinaface detector; default 256, "
        "since WIDER-hard crowd scenes need more than the 128 serving default)",
    )
    parser.add_argument("--iou", type=float, default=0.5)
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument(
        "--dump-predictions",
        default=None,
        dest="dump_predictions",
        metavar="DIR",
        help="also write the detection sweep as an official WIDER "
        "submission tree (<DIR>/<event>/<image>.txt, eval_tools format); "
        "requires --split",
    )
    parser.add_argument(
        "--split",
        default=None,
        choices=("easy", "medium", "hard", "all"),
        help="official per-difficulty protocol from the .mat side files "
        "(default: overall AP from the txt annotations)",
    )
    parser.add_argument("--batch-size", type=int, default=8, help="serving batch size")
    parser.add_argument(
        "--no-batched", action="store_true", help="bypass DetectionServer; run images one by one"
    )
    parser.add_argument(
        "--tta",
        action="store_true",
        help="multi-scale + flip TTA with scale-aware view filtering "
        "(the published WIDER test protocol; implies per-image detection)",
    )
    parser.add_argument(
        "--tta-sizes",
        default="640,1280",
        help="comma list of square detector sizes for --tta (the base --size is always included)",
    )
    parser.add_argument(
        "--tta-merge",
        default="nms",
        choices=("nms", "vote"),
        help="cross-view merge: nms (default) or vote (bbox voting, the many-view protocol)",
    )
    parser.add_argument(
        "--tta-no-flip",
        action="store_true",
        help="multi-scale views only, no mirrored views (for detectors without flip-augmented training)",
    )
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.dump_predictions and not args.split:
        print("--dump-predictions requires --split (the official protocol)")
        return 2

    from ..ops.wider import evaluate_wider, evaluate_wider_batched, find_wider_root

    root = args.root or find_wider_root()
    if root is None:
        print(
            "no WIDER tree found (set --root or WIDER_ROOT); "
            "expected <root>/WIDER_val/images + wider_face_split/..."
        )
        return 2

    det = build_detector(args)
    images_root = os.path.join(root, "WIDER_val", "images")
    split_dir = os.path.join(root, "wider_face_split")

    if args.split:
        from ..ops.wider_split import evaluate_wider_official, find_split_mats

        gt_mat = os.path.join(split_dir, "wider_face_val.mat")
        if not os.path.exists(gt_mat):
            print(f"missing {gt_mat} (official split needs the .mat side files)")
            return 2
        split_mats = find_split_mats(split_dir)
        if args.split != "all":
            if args.split not in split_mats:
                print(f"missing wider_{args.split}_val.mat under {split_dir}")
                return 2
            split_mats = {args.split: split_mats[args.split]}
        res = evaluate_wider_official(
            make_detect_many(det, args),
            images_root,
            gt_mat,
            split_mats,
            iou_threshold=args.iou,
            max_images=args.max_images,
            progress_every=50,
            dump_dir=args.dump_predictions,
        )
        print(json.dumps({d: {k: round(v, 4) for k, v in r.items()} for d, r in res.items()}))
        return 0

    gt_file = os.path.join(split_dir, "wider_face_val_bbx_gt.txt")
    if args.no_batched and not args.tta:
        res = evaluate_wider(
            det, images_root, gt_file,
            iou_threshold=args.iou, max_images=args.max_images, progress_every=50,
        )
    else:
        res = evaluate_wider_batched(
            make_detect_many(det, args), images_root, gt_file,
            iou_threshold=args.iou, max_images=args.max_images, progress_every=50,
        )
    print(json.dumps({k: round(v, 4) for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
