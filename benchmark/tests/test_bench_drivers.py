"""Both drivers end to end on the CPU at small sizes, through every part of a
run but the look for a card; and the command itself, which refuses
without one."""

import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.run import execute
from conftest import REPO

CPU = torch.device("cpu")


def run(root, workload, trace=False, seconds=2.0, seed=2**31 + 77):
    return execute(workload, seed, seconds, trace, CPU, root=root, bench_dir=os.path.join(root, "benchmark"),
                   t0=time.perf_counter(), log=lambda *a: None)


@pytest.mark.parametrize("workload", ["faceid_mnet.served", "faceid_mnet.bulk_b32", "faceid_r50.bulk_b32"])
def test_a_run_on_the_cpu(tiny_root, workload):
    result, details = run(tiny_root, workload)
    assert result["correct"], details["numbers"]
    assert result["failed"] == 0 and result["attempted"] > 0
    e2e = set(result["metrics"])
    assert "setup_s" in e2e and "peak_mem_gib" in e2e
    assert ("extract_req_per_s" in e2e) == workload.endswith("served")
    assert details["numbers"]["judged"] > 0
    assert list(details["lines"]) == ["unanswered", "mismatches", "box_gap_px", "score_gap", "quality_gap",
                                      "embedding_gap"]


def test_a_traced_run_reads_the_counters(tiny_root):
    result, details = run(tiny_root, "faceid_mnet.served", trace=True, seconds=3.0)
    assert result["correct"]
    got = result["metrics"]
    for name in ("runtime.queue_ms.served", "runtime.batch_size.served", "detect.ms_per_img.served",
                 "heads.ms_per_face.served", "pipeline.host_ms_per_img.served", "latency.p95_ms.served"):
        assert name in got and got[name]["value"] > 0
    assert "breakdown" in result


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "faceid_mnet.served",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_the_command_refuses_in_a_bare_directory(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "faceid_mnet.served",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
