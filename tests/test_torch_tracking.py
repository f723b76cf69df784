"""The port's IouTracker and VideoPipeline (pipeline/tracking.py) against the
JAX package's.

The tracker is a numpy copy: on seeded detection streams (births, tied
overlaps, misses, deaths, keypoints or none) every frame's active tracks
are equal to JAX's, field for field and bit for bit.  The VideoPipeline over
the port's DetectionServer(device="cpu") and the JAX VideoPipeline over the
JAX DetectionServer (as tests/test_tracking.py runs it), with the trained
fixture detector on both sides, give the same track ids on every frame and
boxes within 1e-3 px (the networks sum in other orders).
"""

import os

import numpy as np
import pytest
import torch

from rs_face_detection_tpu.pipeline import tracking as jtrack
from rs_face_detection_tpu_torch.pipeline import tracking as ptrack

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TRAINED = os.path.join(FIXTURES, "trained_mnet64.npz")


def _stream(seed, n_frames=24, with_kps=True):
    """Seeded detections of up to 4 objects that drift, vanish and return,
    plus clutter; corners on a 4-px grid so overlaps tie."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 40, size=(4, 2)) * 4.0
    frames = []
    for _ in range(n_frames):
        pos += rng.integers(-2, 3, size=pos.shape) * 4.0
        rows = [
            [x, y, x + 40, y + 40, float(rng.integers(1, 4)) / 4]
            for (x, y) in pos
            if rng.uniform() > 0.25
        ]
        for _ in range(int(rng.integers(0, 3))):
            x, y = rng.integers(0, 60, size=2) * 4.0
            rows.append([x, y, x + 12, y + 12, 0.5])
        dets = np.asarray(rows, np.float32).reshape(-1, 5)
        kps = rng.uniform(0, 200, size=(len(dets), 5, 2)).astype(np.float32) if with_kps else None
        frames.append((dets, kps))
    return frames


def _same_tracks(got, want, atol=0.0, score_atol=0.0):
    """Equal ids and counters; boxes and keypoints within atol px, scores
    within score_atol (0: bit for bit, NaN equal to NaN)."""
    assert [t.track_id for t in got] == [t.track_id for t in want]
    for g, w in zip(got, want):
        assert (g.hits, g.age, g.frames) == (w.hits, w.age, w.frames)
        np.testing.assert_allclose(g.box, w.box, rtol=0, atol=atol)
        np.testing.assert_allclose(g.score, w.score, rtol=0, atol=score_atol)
        if w.keypoints is None:
            assert g.keypoints is None
        else:
            np.testing.assert_allclose(g.keypoints, w.keypoints, rtol=0, atol=atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("params", [(0.3, 5, 2), (0.1, 1, 1), (0.5, 0, 3)])
def test_tracker_equals_jax(seed, params):
    thr, max_age, min_hits = params
    jt = jtrack.IouTracker(iou_threshold=thr, max_age=max_age, min_hits=min_hits)
    pt = ptrack.IouTracker(iou_threshold=thr, max_age=max_age, min_hits=min_hits)
    for dets, kps in _stream(seed, with_kps=seed != 1):
        _same_tracks(pt.update(dets, kps), jt.update(dets, kps))
        _same_tracks(pt.tracks, jt.tracks)
    assert pt._next_id == jt._next_id


def test_tracker_edge_cases_equal_jax():
    for tracker in (jtrack.IouTracker(min_hits=1), ptrack.IouTracker(min_hits=1)):
        with pytest.raises(ValueError, match="4 box columns"):
            tracker.update(np.zeros((2, 3), np.float32))
    jt, pt = jtrack.IouTracker(min_hits=1), ptrack.IouTracker(min_hits=1)
    frames = [
        np.array([[0, 0, 9, 9]], np.float32),  # 4 columns: every score 1
        np.array([[0, 0, 9, 9, 0.5], [0, 0, 9, 9, 0.7]], np.float32),  # tied overlaps
        np.zeros((0, 5), np.float32),
        [[1, 1, 10, 10, 0.9]],  # a plain list
        np.array([[np.nan, 0, 9, 9, 0.5], [5, 5, 4, 4, 0.5]], np.float32),  # NaN, zero union
    ]
    for dets in frames:
        _same_tracks(pt.update(dets), jt.update(dets))


def test_snapshots_are_not_the_live_tracks():
    tracker = ptrack.IouTracker(min_hits=1)
    first = tracker.update(np.array([[0, 0, 40, 40, 0.9]], np.float32))
    tracker.update(np.array([[4, 0, 44, 40, 0.8]], np.float32))
    np.testing.assert_array_equal(first[0].box, [0, 0, 40, 40])
    assert first[0].hits == 1 and tracker.tracks[0].hits == 2


def _clip(n=12, h=64, w=80):
    """A face-like square moving 3 px a frame on a seeded noise background,
    blanked in frames 5-6."""
    rng = np.random.default_rng(3)
    bg = rng.uniform(0, 50, (h, w, 3)).astype(np.float32)
    frames = []
    for i in range(n):
        frame = bg.copy()
        if i not in (5, 6):
            s, x, y = 22, 4 + 3 * i, 14
            frame[y : y + s, x : x + s] = 220.0
            frame[y + s // 4 : y + s // 4 + 2, x + s // 4 : x + s // 4 + 2] = 30
            frame[y + s // 4 : y + s // 4 + 2, x + 3 * s // 4 : x + 3 * s // 4 + 2] = 30
        frames.append(np.clip(frame, 0, 255).astype(np.uint8))
    return frames


def test_video_pipeline_equals_jax():
    from rs_face_detection_tpu.parallel.serving import DetectionServer as JDetectionServer
    from rs_face_detection_tpu.utils.fixtures import load_trained_detector as jload
    from rs_face_detection_tpu_torch.serving.detection_server import DetectionServer
    from rs_face_detection_tpu_torch.utils.fixtures import load_trained_detector

    frames = _clip()
    jpipe = jtrack.VideoPipeline(JDetectionServer(jload(TRAINED), batch_size=4), jtrack.IouTracker(min_hits=2))
    want = list(jpipe.run(iter(frames)))
    with DetectionServer(load_trained_detector(TRAINED, device="cpu"), batch_size=4) as server:
        got = list(ptrack.VideoPipeline(server, ptrack.IouTracker(min_hits=2)).run(iter(frames)))
    assert [i for i, _ in got] == list(range(len(frames)))
    for (gi, gt), (wi, wt) in zip(got, want):
        assert gi == wi
        _same_tracks(gt, wt, atol=1e-3, score_atol=1e-5)
    # One id holds across the clip and is re-matched after the gap.
    assert [[t.track_id for t in tracks] for _, tracks in got] == [[]] + [[0]] * 4 + [[], []] + [[0]] * 5
