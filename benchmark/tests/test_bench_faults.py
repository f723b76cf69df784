"""A run whose timed path is broken underneath comes out not correct: half
of each batch left out, and an answer altered where it is produced.  (The
cells hold no state that a step could leave unchanged, and run on one
card, so no exchange between cards can be left out.)"""

import os
import time

import pytest
import torch

from benchmark.run import execute

CPU = torch.device("cpu")


def run(root, workload):
    return execute(workload, 2**31 + 5, 2.0, False, CPU, root=root, bench_dir=os.path.join(root, "benchmark"),
                   t0=time.perf_counter(), log=lambda *a: None)


@pytest.mark.parametrize("workload", ["faceid_mnet.served", "faceid_mnet.bulk_b32"])
def test_half_the_batch_left_out(tiny_root, workload, monkeypatch):
    from rs_face_detection_tpu_torch.pipeline import face_pipeline as fp

    real = fp.FacePipeline.extract_batch

    def half(self, payloads):
        keep = (len(payloads) + 1) // 2
        return real(self, payloads[:keep]) + [fp.FaceExtractionResult() for _ in payloads[keep:]]

    monkeypatch.setattr(fp.FacePipeline, "extract_batch", half)
    result, details = run(tiny_root, workload)
    assert not result["correct"]
    assert details["numbers"]["mismatches"] > 0


@pytest.mark.parametrize("workload", ["faceid_mnet.served", "faceid_mnet.bulk_b32"])
def test_an_answer_altered_where_it_is_produced(tiny_root, workload, monkeypatch):
    from rs_face_detection_tpu_torch.pipeline import face_pipeline as fp

    real = fp.FacePipeline.heads

    def altered(self, faces):
        probs, emb = real(self, faces)
        return probs, emb + 0.05 * (torch.arange(emb.shape[1], device=emb.device) == 0)

    monkeypatch.setattr(fp.FacePipeline, "heads", altered)
    result, details = run(tiny_root, workload)
    assert not result["correct"]
    assert details["lines"]["embedding_gap"]["value"] > details["lines"]["embedding_gap"]["limit"]
