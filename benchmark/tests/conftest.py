"""Fixtures of the benchmark's tests.

Tests marked ``gpu`` need the card and skip inside their fixture without
one; everything else runs on the CPU at small sizes.  ``tiny_root`` is a
copy of the benchmark in a temporary checkout whose configurations and
mixes are cut to sizes a CPU run holds (the same files, smaller numbers).
"""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def shrink(root: str) -> None:
    """Cut the copy's configurations and mixes to CPU sizes."""
    bench = os.path.join(root, "benchmark")
    for name in os.listdir(os.path.join(bench, "configs")):
        path = os.path.join(bench, "configs", name)
        cfg = json.load(open(path))
        cfg["detector"]["image_size"] = [320, 320]
        cfg["identification"]["layers"] = [2, 2, 2, 2]
        json.dump(cfg, open(path, "w"))
    for name in os.listdir(os.path.join(bench, "traffic")):
        path = os.path.join(bench, "traffic", name)
        mix = json.load(open(path))
        mix["images"]["count"] = 16
        mix["images"]["sizes"] = [[w // 2, h // 2, s] for w, h, s in mix["images"]["sizes"]]
        mix["check_sample"] = 8
        mix["trace_seconds"] = 1.0
        if "batch" in mix:
            mix["batch"] = 4
            mix["max_img_per_s"] = 200
        else:
            mix["warmup_bursts"] = [1, 2]
        json.dump(mix, open(path, "w"))
    for name in os.listdir(os.path.join(bench, "cells")):
        json.dump({"rate_per_s": 4.0}, open(os.path.join(bench, "cells", name), "w"))


@pytest.fixture
def tiny_root(tmp_path):
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "rs_face_detection_tpu_torch"), os.path.join(root, "rs_face_detection_tpu_torch"))
    shrink(root)
    return root
