"""The port's WIDER protocols (ops/wider.py, ops/wider_split.py) against the
JAX package's.

Both are host numpy copies, so the tolerance is none: parsed boxes, keep
indices, per-image matches, curves and every AP are the same floats.  The
inputs cover the count-0 placeholder row, invalid faces, zero-size boxes,
images without GT or without detections, tied scores, a single-event
``.mat`` and a split file without ``event_list``; the ``.mat`` files are
written in the official cell layout with ``scipy.io.savemat``, as
tests/test_wider_split.py builds them.  On a WIDER-format tree of the
fixture scenes the port's RetinaFaceDetection (CPU) scores JAX's AP within
1e-6, serially and through the port's DetectionServer.
"""

import itertools
import os

import numpy as np
import pytest
import torch

scipy_io = pytest.importorskip("scipy.io")
pytest.importorskip("cv2")

from rs_face_detection_tpu.ops import wider as jwider
from rs_face_detection_tpu.ops import wider_split as jsplit
from rs_face_detection_tpu_torch.ops import wider as pwider
from rs_face_detection_tpu_torch.ops import wider_split as psplit
from test_wider import _build_wider_tree
from test_wider_split import _cell, _perfect_predictions, _write_mats

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

GT_TEXT = (
    "a/x.jpg\n3\n10 20 30 40 0 0 0 0 0 0\n50 60 7 8 0 0 0 1 0 0\n5 5 0 9 0 0 0 0 0 0\n"
    "\n"
    "b/empty.jpg\n0\n0 0 0 0 0 0 0 0 0 0\n"
    "c/y.jpg\n2\n1 2 3 4 0 0 0 0 0 0\n0 0 20 20 0 0 0 0 0 0\n"
)


def _same_entries(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.rel_path == w.rel_path
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.invalid_boxes, w.invalid_boxes)


def test_parse_gt_file_equals_jax(tmp_path):
    gt = tmp_path / "gt.txt"
    gt.write_text(GT_TEXT)
    _same_entries(pwider.parse_gt_file(str(gt)), jwider.parse_gt_file(str(gt)))


def test_score_entry_equals_jax(tmp_path):
    """Detections that best-overlap an invalid face are dropped as JAX drops
    them, then matched; over seeded detections with tied scores."""
    gt = tmp_path / "gt.txt"
    gt.write_text(GT_TEXT)
    entries = list(zip(pwider.parse_gt_file(str(gt)), jwider.parse_gt_file(str(gt))))
    rng = np.random.default_rng(0)
    for _ in range(10):
        for pe, je in entries:
            n = int(rng.integers(0, 6))
            xy = rng.integers(0, 12, size=(n, 2)) * 5.0
            dets = np.concatenate(
                [xy, xy + rng.integers(1, 8, size=(n, 2)) * 5.0, rng.integers(0, 3, size=(n, 1)) / 2], 1
            ).astype(np.float32)
            for thr in (0.3, 0.5):
                got = pwider._score_entry(dets, pe, thr)
                want = jwider._score_entry(dets, je, thr)
                assert got.num_gt == want.num_gt
                np.testing.assert_array_equal(got.scores, want.scores)
                np.testing.assert_array_equal(got.matched, want.matched)


def _scripted_tree(tmp_path):
    """A WIDER tree of blank images with GT_TEXT's annotations, and scripted
    detections per image."""
    import cv2

    root = tmp_path / "images"
    for rel in ("a/x.jpg", "b/empty.jpg", "c/y.jpg"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(root / rel), np.zeros((16, 16, 3), np.uint8))
    gt = tmp_path / "gt.txt"
    gt.write_text(GT_TEXT)
    dets = [
        np.array([[10, 20, 39, 59, 0.9], [50, 60, 56, 67, 0.95], [0, 0, 5, 5, 0.9]], np.float32),
        np.array([[1, 1, 9, 9, 0.99]], np.float32),
        np.array([[1, 2, 3, 5, 0.5], [0, 0, 19, 19, 0.5]], np.float32),
    ]
    return str(root), str(gt), dets


def test_evaluate_wider_runners_equal_jax(tmp_path):
    root, gt, dets = _scripted_tree(tmp_path)
    lookup = dict(zip(("a/x.jpg", "b/empty.jpg", "c/y.jpg"), dets))
    calls = itertools.cycle(dets)

    def detector(img):
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
        return next(calls), None

    assert pwider.evaluate_wider(detector, root, gt) == jwider.evaluate_wider(detector, root, gt)

    def detect_many(paths):
        for p in paths:
            yield lookup[os.path.relpath(p, root)], None

    for limit in (None, 2):
        got = pwider.evaluate_wider_batched(detect_many, root, gt, max_images=limit)
        assert got == jwider.evaluate_wider_batched(detect_many, root, gt, max_images=limit)
    with pytest.raises(RuntimeError, match="yielded 1 results for 3 images"):
        pwider.evaluate_wider_batched(lambda paths: iter([(dets[0], None)]), root, gt)
    os.remove(os.path.join(root, "c/y.jpg"))
    with pytest.raises(FileNotFoundError):
        pwider.evaluate_wider(detector, root, gt)


def test_find_wider_root_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("WIDER_ROOT", str(tmp_path))
    assert pwider.find_wider_root() is None and jwider.find_wider_root() is None
    (tmp_path / "wider_face_split").mkdir()
    (tmp_path / "wider_face_split" / "wider_face_val_bbx_gt.txt").write_text("")
    (tmp_path / "WIDER_val" / "images").mkdir(parents=True)
    assert pwider.find_wider_root() == jwider.find_wider_root() == str(tmp_path)
    assert pwider.find_wider_root(["/nonexistent", str(tmp_path)]) == str(tmp_path)


def test_find_wider_root_searches_the_jax_places(tmp_path, monkeypatch):
    """With no argument, ``$WIDER_ROOT`` empty and ``HOME`` a temp dir, both
    functions probe the same places in the same order; then each place in
    turn is made to hold a tree (the probes of that place answered by a temp
    tree), and both find it."""
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("WIDER_ROOT", "")
    tree = tmp_path / "tree"
    (tree / "wider_face_split").mkdir(parents=True)
    (tree / "wider_face_split" / "wider_face_val_bbx_gt.txt").write_text("")
    (tree / "WIDER_val" / "images").mkdir(parents=True)
    exists, isdir = os.path.exists, os.path.isdir
    probed, present = [], [None]

    def redirect(path):
        path = str(path)
        probed.append(path)
        root = present[0]
        return str(tree) + path[len(root):] if root and path.startswith(root + os.sep) else path

    monkeypatch.setattr(os.path, "exists", lambda p: exists(redirect(p)))
    monkeypatch.setattr(os.path, "isdir", lambda p: isdir(redirect(p)))
    assert jwider.find_wider_root() is None
    jax_probes, probed[:] = list(probed), []
    assert pwider.find_wider_root() is None
    assert probed == jax_probes and len(jax_probes) >= 3, (probed, jax_probes)
    places = [p[: -len("/wider_face_split/wider_face_val_bbx_gt.txt")] for p in jax_probes if p.endswith(".txt")]
    assert str(home / "WIDER") in places
    for place in places:
        present[0] = place
        assert pwider.find_wider_root() == jwider.find_wider_root() == place


def test_fixture_tree_ap_equals_jax_serial_and_batched(tmp_path):
    from rs_face_detection_tpu.utils.fixtures import load_trained_detector as jload
    from rs_face_detection_tpu_torch.serving.detection_server import DetectionServer
    from rs_face_detection_tpu_torch.utils.fixtures import load_trained_detector

    images_root, gt_path = _build_wider_tree(tmp_path)
    ckpt = os.path.join(FIXTURES, "trained_mnet64.npz")
    det = load_trained_detector(ckpt, device="cpu")
    serial = pwider.evaluate_wider(det, images_root, gt_path)
    want = jwider.evaluate_wider(jload(ckpt), images_root, gt_path)
    assert serial["num_images"] == want["num_images"] == 6.0
    assert serial["ap"] >= 0.7, serial
    for key in ("ap", "precision", "recall"):
        assert abs(serial[key] - want[key]) <= 1e-6, (key, serial, want)

    def detect_many(paths):
        def payloads():
            for p in paths:
                with open(p, "rb") as f:
                    yield f.read()

        with DetectionServer(det, batch_size=4) as server:
            for batch in server.detect_stream(payloads()):
                yield from batch

    batched = pwider.evaluate_wider_batched(detect_many, images_root, gt_path)
    assert batched["num_images"] == serial["num_images"]
    assert abs(batched["ap"] - serial["ap"]) <= 1e-6


# ---------------------------------------------------------------------------
# the official protocol
# ---------------------------------------------------------------------------


def test_mat_parsing_equals_jax(tmp_path):
    gt_mat, split_mats = _write_mats(tmp_path)
    got, want = psplit.load_gt_mat(gt_mat), jsplit.load_gt_mat(gt_mat)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for path in split_mats.values():
        got, want = psplit.load_split_mat(path), jsplit.load_split_mat(path)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert psplit.find_split_mats(str(tmp_path)) == jsplit.find_split_mats(str(tmp_path)) == split_mats

    one = str(tmp_path / "one_event.mat")
    scipy_io.savemat(one, {
        "event_list": _cell(["0--Solo"]),
        "file_list": _cell([_cell(["img_x", "img_y"])]),
        "face_bbx_list": _cell([_cell([np.array([[0, 0, 10, 10]], float),
                                       np.array([[5, 5, 8, 8], [30, 30, 6, 6]], float)])]),
    })
    got, want = psplit.load_gt_mat(one), jsplit.load_gt_mat(one)
    assert list(got) == list(want) == ["0--Solo/img_x", "0--Solo/img_y"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    broken = str(tmp_path / "broken.mat")
    scipy_io.savemat(broken, {"file_list": _cell([_cell(["img_a"])]), "gt_list": _cell([_cell([np.array([[1.0]])])])})
    for mod in (psplit, jsplit):
        with pytest.raises(ValueError, match="event_list"):
            mod.load_split_mat(broken)


def _random_predictions(rng, gt):
    """Per image: jittered copies of some GT faces, clutter and tied scores;
    one image left out, one with zero rows."""
    preds = {}
    for i, (key, boxes) in enumerate(gt.items()):
        if i == 1:
            continue
        rows = []
        for b in boxes:
            if rng.uniform() < 0.8:
                jit = rng.integers(-2, 3, size=4).astype(np.float32)
                rows.append([*(b + jit), float(rng.integers(1, 5)) / 4])
        for _ in range(int(rng.integers(0, 3))):
            x, y = rng.integers(0, 60, size=2)
            rows.append([x, y, x + 9, y + 9, float(rng.integers(1, 5)) / 4])
        preds[key] = np.asarray(rows, np.float32).reshape(-1, 5)
    return preds


def test_norm_scores_and_image_eval_equal_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        g, d = int(rng.integers(0, 5)), int(rng.integers(0, 8))
        gt = np.concatenate([rng.integers(0, 40, size=(g, 2)), rng.integers(40, 80, size=(g, 2))], 1).astype(np.float32)
        xy = rng.integers(0, 40, size=(d, 2))
        pred = np.concatenate([xy, xy + rng.integers(5, 40, size=(d, 2)), rng.integers(0, 4, size=(d, 1)) / 3], 1)
        pred = pred[np.argsort(-pred[:, 4], kind="stable")].astype(np.float32)
        keep = rng.uniform(size=g) < 0.6
        for thr in (0.3, 0.5):
            for a, b in zip(psplit.image_eval(pred, gt, keep, thr), jsplit.image_eval(pred, gt, keep, thr)):
                np.testing.assert_array_equal(a, b)
        pr, prop = jsplit.image_eval(pred, gt, keep, 0.5)
        np.testing.assert_array_equal(
            psplit._threshold_curve(pred[:, 4], pr, prop, 50), jsplit._threshold_curve(pred[:, 4], pr, prop, 50)
        )
    preds = {"a": np.array([[0, 0, 1, 1, 3.0]], np.float32), "b": np.zeros((0, 5), np.float32),
             "c": np.array([[0, 0, 1, 1, -1.0], [0, 0, 1, 1, 3.0]], np.float32)}
    for p in (preds, {"a": preds["a"]}, {"b": preds["b"]}, {}):
        got, want = psplit.norm_scores(p), jsplit.norm_scores(p)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for r, p in ((np.array([1.0]), np.array([1.0])), (np.array([0.2, 0.5, 0.5, 0.9]), np.array([1.0, 0.4, 0.6, 0.3])),
                 (np.zeros(0), np.zeros(0))):
        assert psplit.voc_ap(r, p) == jsplit.voc_ap(r, p)


def test_evaluate_predictions_equals_jax(tmp_path):
    gt_mat, split_mats = _write_mats(tmp_path)
    gt = jsplit.load_gt_mat(gt_mat)
    splits = {d: jsplit.load_split_mat(p) for d, p in split_mats.items()}
    rng = np.random.default_rng(2)
    cases = [_perfect_predictions(), {}] + [_random_predictions(rng, gt) for _ in range(8)]
    zero_gt = dict(gt, **{"0--Ev/img_b": np.zeros((0, 4), np.float32)})  # an image without GT
    for preds in cases:
        for g in (gt, zero_gt):
            for thr in (0.3, 0.5):
                assert psplit.evaluate_predictions(preds, g, splits, thr) == jsplit.evaluate_predictions(
                    preds, g, splits, thr
                )


def test_dump_and_official_runner_equal_jax(tmp_path):
    import cv2

    gt_mat, split_mats = _write_mats(tmp_path)
    preds = _random_predictions(np.random.default_rng(3), jsplit.load_gt_mat(gt_mat))
    preds["0--Ev/img_b"] = np.zeros((0, 5), np.float32)
    for mod, name in ((psplit, "port"), (jsplit, "jax")):
        assert mod.dump_predictions(preds, str(tmp_path / name)) == len(preds)
    for root, _, files in os.walk(tmp_path / "jax"):
        for fn in files:
            mine = os.path.join(str(tmp_path / "port"), os.path.relpath(os.path.join(root, fn), tmp_path / "jax"))
            assert open(mine).read() == open(os.path.join(root, fn)).read()
    got, want = psplit.load_dumped_predictions(str(tmp_path / "port")), jsplit.load_dumped_predictions(str(tmp_path / "jax"))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    images_root = tmp_path / "images"
    for key in jsplit.load_gt_mat(gt_mat):
        p = images_root / f"{key}.jpg"
        p.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(p), np.zeros((8, 8, 3), np.uint8))

    def detect_many(paths):
        for path in paths:
            key = os.path.splitext(os.path.relpath(path, images_root))[0].replace(os.sep, "/")
            yield preds.get(key, np.zeros((0, 5), np.float32)), None

    keys = sorted(jsplit.load_gt_mat(gt_mat))
    got = psplit.collect_predictions(detect_many, str(images_root), keys)
    want = jsplit.collect_predictions(detect_many, str(images_root), keys)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for limit in (None, 2):
        got = psplit.evaluate_wider_official(detect_many, str(images_root), gt_mat, split_mats, max_images=limit,
                                             dump_dir=str(tmp_path / "dump"))
        want = jsplit.evaluate_wider_official(detect_many, str(images_root), gt_mat, split_mats, max_images=limit)
        assert got == want
