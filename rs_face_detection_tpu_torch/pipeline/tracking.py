"""Track-by-IoU over streamed detections, and the video pipeline.

The port's copy of rs_face_detection_tpu/pipeline/tracking.py: the numpy
tracker (``iou_matrix_np``, ``Track``, ``IouTracker``: greedy global-best
matching, birth after ``min_hits``, coasting up to ``max_age`` missed frames,
snapshots returned, never the live objects) is the original's, line for
line; tests/test_torch_tracking.py holds it equal to JAX's.  ``VideoPipeline``
drives the port's serving/detection_server.py::DetectionServer.detect_stream,
whose results are already (det, kps) in numpy: the device detects (one NMS
kernel launch per streamed batch on the card), the host keeps the books.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np


def iou_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) IoU with the project's "+1" convention (host numpy)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    iw = np.maximum(
        np.minimum(a[:, None, 2], b[None, :, 2])
        - np.maximum(a[:, None, 0], b[None, :, 0])
        + 1.0,
        0.0,
    )
    ih = np.maximum(
        np.minimum(a[:, None, 3], b[None, :, 3])
        - np.maximum(a[:, None, 1], b[None, :, 1])
        + 1.0,
        0.0,
    )
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0] + 1.0) * (a[:, 3] - a[:, 1] + 1.0)
    area_b = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    union = area_a[:, None] + area_b[None, :] - inter
    # Zero-union guard (degenerate/collapsed boxes): 0/0 would be NaN, and
    # NaN wins argmax in the greedy matcher — same rule as
    # ops.box_decode.bbox_overlaps' inter>0 guard.
    return np.where(
        (inter > 0) & (union > 0), inter / np.maximum(union, 1e-12), 0.0
    ).astype(np.float32)


@dataclass
class Track:
    track_id: int
    box: np.ndarray  # (4,)
    score: float
    keypoints: Optional[np.ndarray]  # (5, 2) or None
    hits: int = 1
    age: int = 0  # frames since last match
    frames: int = 1  # total frames alive


@dataclass
class IouTracker:
    """Greedy IoU tracker."""

    iou_threshold: float = 0.3
    max_age: int = 5
    min_hits: int = 2

    _tracks: List[Track] = field(default_factory=list)
    _next_id: int = 0

    def update(
        self,
        boxes: np.ndarray,
        keypoints: Optional[np.ndarray] = None,
    ) -> List[Track]:
        """Advance one frame with (N, 5+) detections; returns active tracks.

        Active = matched THIS frame with at least min_hits matches.  Tracks
        coasting on a missed detection survive internally (up to max_age)
        and resume when re-matched, but are NOT yielded while unmatched —
        consumers see only boxes corroborated by the current frame.
        """
        boxes = np.asarray(boxes, np.float32)
        boxes = boxes.reshape(-1, boxes.shape[-1] if boxes.size else 5)
        if boxes.size and boxes.shape[1] < 4:
            raise ValueError(f"detections need >= 4 box columns, got {boxes.shape[1]}")
        det_boxes = boxes[:, :4]
        det_scores = boxes[:, 4] if boxes.shape[1] > 4 else np.ones(len(boxes))

        track_boxes = np.stack([t.box for t in self._tracks]) if self._tracks else np.zeros((0, 4))
        iou = iou_matrix_np(track_boxes, det_boxes)

        matched_tracks: set = set()
        matched_dets: set = set()
        # Greedy: repeatedly take the global best pair above threshold.
        while iou.size:
            t_idx, d_idx = np.unravel_index(np.argmax(iou), iou.shape)
            if iou[t_idx, d_idx] < self.iou_threshold:
                break
            track = self._tracks[t_idx]
            track.box = det_boxes[d_idx].copy()
            track.score = float(det_scores[d_idx])
            track.keypoints = (
                keypoints[d_idx].copy() if keypoints is not None else None
            )
            track.hits += 1
            track.age = 0
            track.frames += 1
            matched_tracks.add(t_idx)
            matched_dets.add(int(d_idx))
            iou[t_idx, :] = -1.0
            iou[:, d_idx] = -1.0

        # Age unmatched tracks; drop the expired.
        survivors = []
        for i, track in enumerate(self._tracks):
            if i in matched_tracks:
                survivors.append(track)
            else:
                track.age += 1
                track.frames += 1
                if track.age <= self.max_age:
                    survivors.append(track)
        self._tracks = survivors

        # Birth new tracks from unmatched detections.
        for d in range(len(det_boxes)):
            if d not in matched_dets:
                self._tracks.append(
                    Track(
                        track_id=self._next_id,
                        box=det_boxes[d].copy(),
                        score=float(det_scores[d]),
                        keypoints=keypoints[d].copy() if keypoints is not None else None,
                    )
                )
                self._next_id += 1

        # Snapshot copies: internal Track objects mutate on later frames, so
        # returning them live would retroactively rewrite callers' history.
        return [
            Track(
                track_id=t.track_id,
                box=t.box.copy(),
                score=t.score,
                keypoints=None if t.keypoints is None else t.keypoints.copy(),
                hits=t.hits,
                age=t.age,
                frames=t.frames,
            )
            for t in self._tracks
            if t.hits >= self.min_hits and t.age == 0
        ]

    @property
    def tracks(self) -> List[Track]:
        return list(self._tracks)


class VideoPipeline:
    """Streaming detect + track: frames in, per-frame active tracks out.

    Drives ``DetectionServer.detect_stream`` (batched detection, the next
    batch staged while this one computes) and associates the results with an
    IouTracker.  Feed an iterable of frames (encoded bytes or (H, W, 3) uint8
    BGR arrays); ``run`` yields (frame_index, tracks).  Without a server it
    serves the default detector on the card (``DetectionServer()``), and
    raises where there is none.
    """

    def __init__(self, server=None, tracker: Optional[IouTracker] = None) -> None:
        if server is None:
            from ..serving.detection_server import DetectionServer

            server = DetectionServer()
        self.server = server
        self.tracker = tracker or IouTracker()

    def run(self, frames) -> Iterator[Tuple[int, List[Track]]]:
        idx = 0
        for chunk in self.server.detect_stream(frames):
            for boxes, kps in chunk:
                yield idx, self.tracker.update(boxes, kps)
                idx += 1
