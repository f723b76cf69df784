"""The comparison that decides ``correct``: the program's answers against the reference's.

Each sampled request's answer (the served reply's JSON, or a bulk result in
the same form) is held against the reference's answer to the same JPEG:

- ``unanswered``: requests with no answer or an error answer;
- ``mismatches``: judged requests whose face count, whether a face was
  selected, or (unless the reference's class is a near tie) quality class
  differ;
- ``box_gap_px``: the widest gap of a selected box's corners, in pixels;
- ``score_gap``: of its detection score;
- ``quality_gap``: of the quality score (classes that are not near ties);
- ``embedding_gap``: the widest gap of an element of the L2-normalised
  512-d embedding.

A request is judged unless the reference marks it ``ambiguous`` (see
reference/pipeline.py).  Each number has its limit in the configuration's
limits file; ``correct`` is every number within its limit.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

NUMBERS = ("unanswered", "mismatches", "box_gap_px", "score_gap", "quality_gap", "embedding_gap")


def parse_reply(body: Optional[str]) -> Optional[dict]:
    if body is None:
        return None
    try:
        return json.loads(body)
    except ValueError:
        return {"error": "reply is not JSON"}


def compare(program: List[Optional[dict]], reference: List[dict]) -> Dict[str, float]:
    """The numbers compared, and the counts they were taken over."""
    out = dict.fromkeys(NUMBERS, 0.0)
    out.update(judged=0, ambiguous=0, faces=0, why_ambiguous={}, why_mismatch=[])
    for p, r in zip(program, reference):
        if p is None or "error" in p:
            out["unanswered"] += 1
            continue
        if r["ambiguous"]:
            out["ambiguous"] += 1
            out["why_ambiguous"][r["ambiguous"]] = out["why_ambiguous"].get(r["ambiguous"], 0) + 1
            continue
        out["judged"] += 1
        p_box, r_box = p.get("selected_face_box"), r["selected_face_box"]
        if p.get("face_count") != r["face_count"] or (p_box is None) != (r_box is None):
            out["mismatches"] += 1
            out["why_mismatch"].append({"face_count": [p.get("face_count"), r["face_count"]],
                                        "selected": [None if p_box is None else [float(x) for x in p_box],
                                                     None if r_box is None else [float(x) for x in r_box]]})
            continue
        if r_box is None:
            continue
        p_emb = p.get("facial_feature")
        if p_emb is None or len(p_emb) != len(r["facial_feature"]) or len(p_box) != 5:
            out["mismatches"] += 1
            continue
        out["faces"] += 1
        p_box, r_box = np.asarray(p_box, np.float64), np.asarray(r_box, np.float64)
        out["box_gap_px"] = max(out["box_gap_px"], float(np.max(np.abs(p_box[:4] - r_box[:4]))))
        out["score_gap"] = max(out["score_gap"], float(abs(p_box[4] - r_box[4])))
        gap = np.max(np.abs(np.asarray(p_emb, np.float64) - np.asarray(r["facial_feature"], np.float64)))
        out["embedding_gap"] = max(out["embedding_gap"], float(gap) if np.isfinite(gap) else float("inf"))
        if not r["quality_ambiguous"]:
            if p.get("face_quality") != r["face_quality"] or p.get("quality_score") is None:
                out["mismatches"] += 1
                out["why_mismatch"].append({"face_quality": [p.get("face_quality"), r["face_quality"]],
                                            "quality_score": [p.get("quality_score"), r["quality_score"]]})
                continue
            out["quality_gap"] = max(out["quality_gap"], abs(float(p["quality_score"]) - r["quality_score"]))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> (bool, Dict[str, dict]):
    """(correct, {number: {"value", "limit"}}); a number is within its limit
    when it is finite and at most the limit."""
    lines = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in lines.values())
    return bool(ok and numbers["judged"] > 0), lines
