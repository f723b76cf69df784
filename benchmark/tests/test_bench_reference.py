"""The plain reference against the program at small sizes on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import check, images, port, weights
from benchmark.reference.pipeline import Reference, anchor_table
from conftest import REPO

CPU = torch.device("cpu")


def small(name):
    cfg = json.load(open(os.path.join(REPO, "benchmark", "configs", f"{name}.json")))
    cfg["detector"]["image_size"] = [320, 320]
    cfg["identification"]["layers"] = [2, 2, 2, 2]
    return cfg


SPEC = {"count": 12, "sizes": [[320, 240, 0.7], [640, 360, 0.3]], "jpeg_quality": 90,
        "faces": {"none": 0.0, "one": 0.7, "two": 0.3}, "face_height": [0.25, 0.5]}


@pytest.mark.parametrize("name", ["faceid_mnet", "faceid_r50"])
def test_reference_agrees_with_the_program(name):
    torch.manual_seed(0)
    cfg = small(name)
    lim = json.load(open(os.path.join(REPO, "benchmark", "limits", f"{name}.json")))
    pool, _ = images.make_pool(SPEC, 11, CPU)
    states = weights.make_states(cfg, 11, CPU, REPO, pool)
    pipe, _ = port.build(cfg, states, CPU)
    from rs_face_detection_tpu_torch.runtime.server import extract_reply

    program = [extract_reply(r) for r in pipe.extract_batch(pool)]
    ref = Reference(cfg, states, lim["margins"], CPU).answers(pool)
    numbers = check.compare(program, ref)
    assert numbers["unanswered"] == 0 and numbers["mismatches"] == 0
    assert numbers["judged"] >= 3 and numbers["faces"] >= 2
    assert numbers["embedding_gap"] < 1e-2 and numbers["box_gap_px"] < 0.1


def test_anchor_table_matches_the_program():
    from rs_face_detection_tpu_torch.configs import RPN_ANCHOR_CFG
    from rs_face_detection_tpu_torch.ops.anchors import full_anchor_table

    cfg = json.load(open(os.path.join(REPO, "benchmark", "configs", "faceid_mnet.json")))["detector"]
    want, _ = full_anchor_table((640, 640), RPN_ANCHOR_CFG, (32, 16, 8))
    assert np.array_equal(anchor_table([640, 640], cfg["feat_strides"], cfg["anchors"]), want)


def test_the_s2d_stem_is_the_7x7_stem():
    import torch.nn.functional as F

    from benchmark.weights import stem_to_s2d

    g = torch.Generator().manual_seed(1)
    k = torch.randn((64, 3, 7, 7), generator=g)
    x = torch.randn((2, 3, 32, 32), generator=g)
    want = F.conv2d(x, k, stride=2, padding=3)
    s2d = x.reshape(2, 3, 16, 2, 16, 2).permute(0, 3, 5, 1, 2, 4).reshape(2, 12, 16, 16)
    got = F.conv2d(F.pad(s2d, (2, 1, 2, 1)), stem_to_s2d(k))
    assert torch.allclose(got, want, atol=1e-4)


def test_seeded_weights_are_a_function_of_the_seed():
    cfg = small("faceid_mnet")
    pool, _ = images.make_pool(SPEC, 2, CPU)
    a = weights.make_states(cfg, 5, CPU, REPO, pool)
    b = weights.make_states(cfg, 5, CPU, REPO, pool)
    c = weights.make_states(cfg, 6, CPU, REPO, pool)
    key = "layer1.0.conv1.weight"
    assert torch.equal(a["identification"][key], b["identification"][key])
    assert not torch.equal(a["identification"][key], c["identification"][key])
    assert torch.equal(a["detector"]["body.stage1.0.0.weight"], c["detector"]["body.stage1.0.0.weight"])  # the file
