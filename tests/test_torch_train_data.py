"""The port's training input (parallel/data.py) and its entry point
(tools/train_detector.py): the tests of tests/test_data_loader.py on the
port, and the loader's batches against the JAX package's loader on the same
files and seed, bit for bit."""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from rs_face_detection_tpu.parallel import data as jdata
from rs_face_detection_tpu.parallel.serving import letterbox_host as jax_letterbox_host
from rs_face_detection_tpu_torch.configs import RPN_ANCHOR_CFG, FaceDetectionConfig
from rs_face_detection_tpu_torch.ops.anchors import full_anchor_table
from rs_face_detection_tpu_torch.ops.box_decode import bbox_overlaps
from rs_face_detection_tpu_torch.ops.image import letterbox_geometry
from rs_face_detection_tpu_torch.parallel.checkpoint import latest_step
from rs_face_detection_tpu_torch.parallel.data import (
    DetectionDataLoader,
    FaceExample,
    letterbox_host,
    parse_retinaface_label,
    wider_examples,
)
from rs_face_detection_tpu_torch.parallel.train import Trainer, _weight_decay_mask, detection_loss
from rs_face_detection_tpu_torch.tools import train_detector

torch.set_num_threads(2)

LABEL_TXT = """\
# scene_a/img0.jpg
10 20 40 50 15.0 30.0 0.0 35.0 30.0 0.0 25.0 45.0 0.0 18.0 58.0 0.0 33.0 58.0 0.0 0.9
# scene_b/img1.jpg
5 5 30 30 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 0.8
60 10 20 20 62.0 14.0 0.0 75.0 14.0 0.0 70.0 20.0 0.0 64.0 26.0 0.0 74.0 26.0 0.0 1.0
"""


def _same_examples(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.rel_path == b.rel_path
        for field in ("boxes", "lms", "lm_valid", "ignore_boxes"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_parse_retinaface_label(tmp_path):
    p = tmp_path / "label.txt"
    p.write_text(LABEL_TXT)
    ex = parse_retinaface_label(str(p))
    assert [e.rel_path for e in ex] == ["scene_a/img0.jpg", "scene_b/img1.jpg"]
    assert ex[0].boxes.shape == (1, 4)
    np.testing.assert_allclose(ex[0].boxes[0], [10, 20, 49, 69])
    assert ex[0].lm_valid.tolist() == [True]
    np.testing.assert_allclose(ex[0].lms[0, 0], [15.0, 30.0])
    assert ex[1].boxes.shape == (2, 4)
    assert ex[1].lm_valid.tolist() == [False, True]
    _same_examples(ex, jdata.parse_retinaface_label(str(p)))


def test_wider_adapter(tmp_path):
    gt = tmp_path / "wider_face_val_bbx_gt.txt"
    gt.write_text("a/b.jpg\n2\n10 10 20 20 0 0 0 0 0 0\n40 40 8 8 0 0 0 1 0 0\n")
    ex = wider_examples(str(gt))
    assert len(ex) == 1 and ex[0].boxes.shape == (1, 4)
    assert ex[0].lm_valid.tolist() == [False]
    assert ex[0].ignore_boxes.shape == (1, 4)
    _same_examples(ex, jdata.wider_examples(str(gt)))


def test_negative_edge_landmark_is_still_annotated(tmp_path):
    p = tmp_path / "label.txt"
    p.write_text(
        "# scene_c/img2.jpg\n"
        "0 20 40 50 -3.0 30.0 0.0 20.0 30.0 0.0 8.0 45.0 0.0 "
        "2.0 58.0 0.0 18.0 58.0 0.0 0.9\n"
        "50 50 20 20 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 0.8\n"
    )
    (ex,) = parse_retinaface_label(str(p))
    assert ex.lm_valid.tolist() == [True, False]
    np.testing.assert_allclose(ex.lms[0, 0], [-3.0, 30.0])


def _write_dataset(root, n=16, size=(200, 160), crowd=False):
    """n images with one known face box each (with ``crowd``, every third
    image has 7 faces and an ignore box, so max_faces 4 overflows); returns
    the port's examples and JAX's."""
    w, h = size
    mine, theirs = [], []
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "ev"), exist_ok=True)
    for i in range(n):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        rel = f"ev/im{i}.jpg"
        cv2.imwrite(os.path.join(root, rel), img)
        k = 7 if crowd and i % 3 == 0 else 1
        box = np.asarray([[20.0 + i + 9 * j, 30.0 + 5 * j, 80.0 + i + 6 * j, 100.0 - 4 * j] for j in range(k)],
                         np.float32)
        lms = np.tile(np.asarray([[[30, 50], [60, 50], [45, 70], [35, 85], [60, 85]]], np.float32), (k, 1, 1))
        lmv = np.asarray([(i + j) % 2 == 0 for j in range(k)], bool)
        ign = np.zeros((0, 4), np.float32)
        if crowd and i % 4 == 0:
            ign = np.asarray([[5.0, 5.0, 15.0 + i, 15.0]], np.float32)
        mine.append(FaceExample(rel, box, lms, lmv, ign))
        theirs.append(jdata.FaceExample(rel, box.copy(), lms.copy(), lmv.copy(), ign.copy()))
    return mine, theirs


def test_loader_letterbox_geometry(tmp_path):
    examples, _ = _write_dataset(str(tmp_path))
    loader = DetectionDataLoader(examples, str(tmp_path), image_size=(64, 64), batch_size=2, max_faces=4, seed=1)
    batch = next(loader.batches())
    assert batch.images.shape == (2, 64, 64, 3)
    assert batch.gt_boxes.shape == (2, 4, 4)
    assert batch.gt_lm_valid.shape == (2, 4)
    _, _, det_scale = letterbox_geometry(160, 200, 64, 64)
    assert batch.gt_valid.sum() == 2
    for b in range(2):
        (box,) = batch.gt_boxes[b][batch.gt_valid[b]]
        assert 15 * det_scale <= box[0] <= 30 * det_scale + 2
        assert (box[2] - box[0]) == pytest.approx(60 * det_scale, abs=0.01)
    assert 0.0 <= float(np.min(batch.images)) and float(np.max(batch.images)) <= 255.0


def test_loader_batches_equal_jax(tmp_path):
    """Two epochs from the same files and seed, with faces beyond max_faces
    and ignore boxes: every array bit for bit, as numpy and as tensors on a
    device; the letterbox equal to JAX's."""
    mine, theirs = _write_dataset(str(tmp_path), n=10, crowd=True)
    kw = dict(image_size=(64, 48), batch_size=3, max_faces=4, seed=7, decode_workers=2)
    with DetectionDataLoader(mine, str(tmp_path), **kw) as a, DetectionDataLoader(mine, str(tmp_path), **kw) as t:
        ref = jdata.DetectionDataLoader(theirs, str(tmp_path), **kw)
        try:
            got = list(a.batches(epochs=2))
            on_device = list(t.batches(epochs=2, device="cpu"))
            want = list(ref.batches(epochs=2))
        finally:
            ref.close()
    assert len(got) == len(want) == 6
    for g, d, w in zip(got, on_device, want):
        for x, y, z in zip(g, d, w):
            assert x.dtype == np.asarray(z).dtype and np.array_equal(x, np.asarray(z))
            assert isinstance(y, torch.Tensor) and np.array_equal(y.numpy(), x)
    assert any(np.asarray(w.gt_ignore).any() for w in want)
    img = cv2.imread(os.path.join(str(tmp_path), "ev/im3.jpg"))
    for size in ((64, 48), (640, 640), (97, 211)):
        canvas, scale = letterbox_host(img, *size)
        ref_canvas, ref_scale = jax_letterbox_host(img, *size)
        assert scale == ref_scale and np.array_equal(canvas, ref_canvas)


def test_lm_valid_masks_landmark_loss():
    anchors = torch.from_numpy(full_anchor_table((64, 64), RPN_ANCHOR_CFG)[0])
    n = anchors.shape[0]
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
    boxes = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    lms = torch.from_numpy(rng.normal(size=(n, 5, 2)).astype(np.float32))
    gt_boxes = torch.tensor([[10.0, 10.0, 40.0, 40.0]])
    gt_lms = torch.from_numpy(rng.normal(size=(1, 5, 2)).astype(np.float32)) * 10
    gt_valid = torch.tensor([True])
    _, with_lm = detection_loss(logits, boxes, lms, anchors, gt_boxes, gt_lms, gt_valid,
                                gt_lm_valid=torch.tensor([True]))
    _, no_lm = detection_loss(logits, boxes, lms, anchors, gt_boxes, gt_lms, gt_valid,
                              gt_lm_valid=torch.tensor([False]))
    assert float(with_lm["lm_loss"]) > 0
    assert float(no_lm["lm_loss"]) == 0.0
    assert float(no_lm["cls_loss"]) == pytest.approx(float(with_lm["cls_loss"]))
    assert float(no_lm["box_loss"]) == pytest.approx(float(with_lm["box_loss"]))


def test_train_step_on_loader_batches(tmp_path):
    examples, _ = _write_dataset(str(tmp_path))
    trainer = Trainer(FaceDetectionConfig(image_size=(64, 64)), learning_rate=1e-3, device="cpu")
    loader = DetectionDataLoader(examples, str(tmp_path), image_size=(64, 64), batch_size=2, max_faces=4, seed=3)
    state = trainer.init_state(seed=0)
    step = trainer.make_train_step()
    for i, batch in enumerate(loader.batches(epochs=None, device="cpu")):
        state, metrics = step(state, batch)
        if i >= 1:
            break
    loader.close()
    assert np.isfinite(float(metrics["loss"]))
    assert state.step == 2


def test_process_shard_partitions_examples(tmp_path):
    examples, _ = _write_dataset(str(tmp_path), n=16)
    shards = [
        DetectionDataLoader(examples, str(tmp_path), image_size=(64, 64), batch_size=2, max_faces=4, seed=0,
                            process_shard=(i, 4))
        for i in range(4)
    ]
    seen = [e.rel_path for s in shards for e in s.examples]
    assert sorted(seen) == sorted(e.rel_path for e in examples)
    assert len(set(seen)) == len(examples)
    with pytest.raises(ValueError):
        DetectionDataLoader(examples, str(tmp_path), batch_size=2, process_shard=(4, 4))


def test_uneven_process_shards_truncate_equal(tmp_path):
    examples, _ = _write_dataset(str(tmp_path), n=14)
    shards = [
        DetectionDataLoader(examples, str(tmp_path), image_size=(64, 64), batch_size=2, max_faces=4, seed=0,
                            process_shard=(i, 4))
        for i in range(4)
    ]
    assert [len(s.examples) for s in shards] == [3, 3, 3, 3]


def test_ignore_regions_excluded_from_negatives():
    anchors = torch.from_numpy(full_anchor_table((64, 64), RPN_ANCHOR_CFG)[0])
    n = anchors.shape[0]
    rng = np.random.default_rng(7)
    gt_boxes = torch.tensor([[4.0, 4.0, 20.0, 20.0]])
    gt_lms = torch.zeros((1, 5, 2))
    gt_valid = torch.tensor([True])
    ignore = torch.tensor([[40.0, 40.0, 60.0, 60.0]])
    padding = torch.zeros((1, 4))
    # The anchors over the ignore region are made the hardest negatives.
    over_ignore = bbox_overlaps(anchors, ignore).max(dim=1).values.numpy() >= 0.3
    logits_np = rng.normal(size=(n, 2)).astype(np.float32)
    logits_np[over_ignore, 1] += 20.0
    logits = torch.from_numpy(logits_np)
    boxes = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    lms = torch.from_numpy(rng.normal(size=(n, 5, 2)).astype(np.float32))
    assert over_ignore.sum() > 0
    _, base = detection_loss(logits, boxes, lms, anchors, gt_boxes, gt_lms, gt_valid, ignore_boxes=padding)
    _, masked = detection_loss(logits, boxes, lms, anchors, gt_boxes, gt_lms, gt_valid, ignore_boxes=ignore)
    assert float(masked["cls_loss"]) < float(base["cls_loss"]) - 1.0
    assert float(base["num_pos"]) == float(masked["num_pos"])
    assert float(base["box_loss"]) == pytest.approx(float(masked["box_loss"]))


def test_loader_carries_ignore_boxes(tmp_path):
    examples, _ = _write_dataset(str(tmp_path), n=2)
    examples[0].ignore_boxes = np.asarray([[5.0, 5.0, 15.0, 15.0]], np.float32)
    loader = DetectionDataLoader(examples, str(tmp_path), image_size=(64, 64), batch_size=2, max_faces=4, seed=1)
    batch = next(loader.batches())
    assert batch.gt_ignore.shape == (2, 4, 4)
    _, _, s = letterbox_geometry(160, 200, 64, 64)
    flat = np.asarray(batch.gt_ignore).reshape(-1, 4)
    nonzero = flat[(flat != 0).any(axis=1)]
    assert nonzero.shape == (1, 4)
    np.testing.assert_allclose(nonzero[0], np.asarray([5, 5, 15, 15]) * s, rtol=1e-5)


def test_lr_schedule_and_decay_mask():
    """Weight decay exempts 1-D leaves, and a warmup + cosine Trainer steps."""
    mask = _weight_decay_mask({"conv.weight": torch.zeros(8, 4, 3, 3), "conv.bias": torch.zeros(8),
                               "bn.weight": torch.zeros(8), "bn.bias": torch.zeros(8)})
    assert mask == {"conv.weight": True, "conv.bias": False, "bn.weight": False, "bn.bias": False}
    trainer = Trainer(FaceDetectionConfig(image_size=(64, 64)), learning_rate=1e-3, warmup_steps=2, total_steps=10,
                      device="cpu")
    state = trainer.init_state(seed=0)
    state, metrics = trainer.make_train_step()(state, trainer.make_batch(2, max_faces=4, seed=0))
    assert np.isfinite(float(metrics["loss"]))


def _cli_dataset(tmp_path, n=8):
    root = tmp_path / "data"
    (root / "s").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        rel = f"s/im{i}.jpg"
        cv2.imwrite(str(root / rel), rng.integers(0, 255, (96, 96, 3), dtype=np.uint8))
        lines += [f"# {rel}", "20 20 40 40 30.0 30.0 0.0 50.0 30.0 0.0 40.0 45.0 0.0 32.0 52.0 0.0 48.0 52.0 0.0 1.0"]
    labels = tmp_path / "label.txt"
    labels.write_text("\n".join(lines) + "\n")
    return root, labels


def test_train_cli_val_best_and_resume(tmp_path, capsys):
    """The entry point on the CPU: validation AP gating the exported weights
    (with its sidecar), periodic train-state saves, and a resume from the
    latest step that runs no further step and still exports."""
    root, labels = _cli_dataset(tmp_path)
    out = tmp_path / "trained.npz"
    ckpt_dir = tmp_path / "ckpts"
    argv = [
        "--labels", str(labels), "--images", str(root), "--out", str(out), "--size", "64x64",
        "--batch", "2", "--steps", "2", "--log-every", "1", "--val-labels", str(labels),
        "--val-max-images", "2", "--eval-every", "1", "--checkpoint-dir", str(ckpt_dir), "--save-every", "1",
        "--device", "cpu",
    ]
    assert train_detector.main(argv) == 0
    assert out.exists() and (tmp_path / "trained.npz.bestap.json").exists()
    assert latest_step(str(ckpt_dir)) == 2
    first = capsys.readouterr().out
    assert "step 1: val AP" in first and "step 2: val AP" in first
    assert train_detector.main(argv) == 0
    assert "resumed from step 2" in capsys.readouterr().out
    with np.load(out) as data:
        assert "params/body/conv1/Conv_0/kernel" in data.files
        assert "batch_stats/body/conv1/BatchNorm_0/var" in data.files


def test_trainer_cli_rejects_undersized_dataset(tmp_path):
    root = tmp_path / "imgs"
    root.mkdir()
    cv2.imwrite(str(root / "one.jpg"), np.zeros((32, 32, 3), np.uint8))
    labels = tmp_path / "label.txt"
    labels.write_text("# one.jpg\n10 10 12 12 " + " ".join(["-1.0"] * 15) + " 1.0\n")
    with pytest.raises(SystemExit, match="--batch"):
        train_detector.main(["--labels", str(labels), "--images", str(root), "--out", str(tmp_path / "o.npz"),
                             "--size", "64x64", "--batch", "8", "--steps", "1", "--device", "cpu"])


def test_trainer_cli_rejects_eval_without_readable_validation(tmp_path):
    root, labels = _cli_dataset(tmp_path, n=2)
    with pytest.raises(SystemExit, match="--eval-every needs --val-labels"):
        train_detector.main(["--labels", str(labels), "--images", str(root), "--out", str(tmp_path / "o.npz"),
                             "--eval-every", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no readable validation images"):
        train_detector.main(["--labels", str(labels), "--images", str(root), "--out", str(tmp_path / "o.npz"),
                             "--batch", "2", "--eval-every", "1", "--val-labels", str(labels),
                             "--val-images", str(tmp_path / "missing"), "--device", "cpu"])
