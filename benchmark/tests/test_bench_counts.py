"""The operation and byte counts against hand counts at small shapes."""

import pytest
import torch

from benchmark.counts import HBM_BYTES_PER_S, TF32_FLOPS, k1, k2, share
from benchmark.counts.model import program_flops


def test_k1_bytes_and_operations():
    assert k1.launch_bytes((2, 3, 4)) == 2 * 3 * 16 + 2 * 2 * 3
    valid = torch.tensor([[1, 1, 1, 0], [1, 0, 1, 1]], dtype=torch.bool)
    keep = torch.tensor([[1, 0, 1, 0], [1, 0, 1, 0]], dtype=torch.bool)
    # image 0: box 0 kept, 2 later valid; box 2 kept, 0 later valid
    # image 1: box 0 kept, 2 later valid; box 2 kept, 1 later valid
    assert k1.launch_flops(valid, keep) == 15 * (2 + 0 + 2 + 1)


def test_k1_roofline_scales_to_the_traced_launches():
    v = torch.ones((8, 128), dtype=torch.bool)
    launches = [((8, 128, 4), v, v), ((8, 128, 4), v, v)]
    one = k1.roofline(launches[:1], 1e-5, 1)
    assert one == pytest.approx(k1.roofline(launches, 3e-5, 3))
    assert k1.roofline([], 1e-5, 1) is None and k1.roofline(launches, 0.0, 0) is None


def test_k2_counts_the_algorithm_not_the_implementation():
    flops = k2.launch_flops((8, 640, 640, 3))
    assert flops == 2 * 8 * 320 * 320 * 64 * 192
    assert flops / 1e9 == pytest.approx(20.13, abs=0.01)  # not the 40.3 of two TF32 products
    assert k2.launch_bytes((8, 640, 640, 3), (8, 64, 160, 160)) == 8 * 640 * 640 * 3 + 4 * 8 * 64 * 160 * 160
    t = share(0, flops, TF32_FLOPS, 0.4242e-3)
    assert t == pytest.approx(100 * flops / TF32_FLOPS / 0.4242e-3)
    assert share(3.35e12, 0, TF32_FLOPS, 1.0) == pytest.approx(100.0 * 3.35e12 / HBM_BYTES_PER_S)


def test_model_flops_by_hand():
    cfg = {"detector": {"arch": "resnet18_classifier", "num_classes": 4, "image_size": [32, 32]},
           "quality": {"arch": "resnet18_classifier", "num_classes": 4, "image_size": [32, 32]},
           "identification": {"arch": "iresnet", "layers": [1, 1, 1, 1], "embedding_dim": 8, "image_size": [112, 112]}}

    def conv(h, w, cin, cout, k):
        return 2 * h * w * cout * cin * k * k

    r18 = conv(16, 16, 3, 64, 7)
    for (h, cin, cout, down) in ((8, 64, 64, False), (4, 64, 128, True), (2, 128, 256, True), (1, 256, 512, True)):
        r18 += conv(h, h, cin, cout, 3) + 3 * conv(h, h, cout, cout, 3) + (conv(h, h, cin, cout, 1) if down else 0)
    r18 += 2 * 512 * 4
    ires = conv(112, 112, 3, 64, 3)
    for (h, cin, cout) in ((56, 64, 64), (28, 64, 128), (14, 128, 256), (7, 256, 512)):
        ires += conv(2 * h, 2 * h, cin, cout, 3) + conv(h, h, cout, cout, 3) + conv(h, h, cin, cout, 1)
    ires += 2 * 512 * 49 * 8
    got = program_flops(cfg)
    assert got["per_image"] == r18
    assert got["per_face"] == r18 + ires
