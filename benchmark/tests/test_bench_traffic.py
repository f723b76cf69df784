"""The traffic generators: the same for a seed, different across seeds, and
every seed the same work in another order."""

from collections import Counter

import numpy as np
import pytest
import torch

from benchmark import images, schedule

SPEC = {"count": 40, "sizes": [[64, 48, 0.7], [128, 72, 0.3]], "jpeg_quality": 90,
        "faces": {"none": 0.05, "one": 0.85, "two": 0.10}, "face_height": [0.19, 0.5]}
BIG = 2**31 + 987654321


@pytest.mark.parametrize("seed", [0, BIG])
def test_pool_is_a_function_of_the_seed(seed):
    a, la = images.make_pool(SPEC, seed, torch.device("cpu"))
    b, lb = images.make_pool(SPEC, seed, torch.device("cpu"))
    assert a == b and la == lb
    c, _ = images.make_pool(SPEC, seed + 1, torch.device("cpu"))
    assert a != c


def test_every_seed_holds_the_same_mix():
    mixes = []
    for seed in (1, 2, BIG):
        items = images.layout(SPEC, seed)
        mixes.append((Counter(it["size"] for it in items), Counter(len(it["faces"]) for it in items),
                      sorted(f[2] for it in items for f in it["faces"][-1:])))
    assert mixes[0][0] == mixes[1][0] == mixes[2][0] == Counter({(64, 48): 28, (128, 72): 12})
    assert mixes[0][1] == mixes[1][1] == Counter({0: 2, 1: 34, 2: 4})


def test_faces_fit_their_images_and_the_central_one_is_central():
    for it in images.layout(SPEC, 3):
        w, h = it["size"]
        for x, y, s in it["faces"]:
            assert 0 <= x and x + s <= w and 0 <= y and y + s <= h
        if it["faces"]:
            x, _, s = it["faces"][-1]
            assert abs(x + s / 2 - w / 2) <= 0.2 * w + 1


def test_exact_counts():
    assert images.exact_counts(512, [0.05, 0.85, 0.10]) == [26, 435, 51]
    assert sum(images.exact_counts(7, [1, 1, 1])) == 7


def test_open_loop_schedule():
    due, img = schedule.open_loop(50.0, 10.0, 64, 5)
    due2, img2 = schedule.open_loop(50.0, 10.0, 64, 5)
    assert np.array_equal(due, due2) and np.array_equal(img, img2)
    due3, img3 = schedule.open_loop(50.0, 10.0, 64, 6)
    assert not np.array_equal(due, due3)
    assert len(due) == 500 and due[0] == 0.0 and due[-1] < 10.0 and np.all(np.diff(due) > 0)
    assert np.allclose(np.sort(np.diff(np.append(due, 10.0))), np.sort(np.diff(np.append(due3, 10.0))))
    assert Counter(img[:448].tolist()) == Counter(img3[:448].tolist())  # whole epochs of the pool


def test_batches_are_distinct_within_and_seeded():
    plan = schedule.batches(64, 8, 20, 9)
    assert all(len(set(b.tolist())) == 8 for b in plan)
    assert all(np.array_equal(a, b) for a, b in zip(plan, schedule.batches(64, 8, 20, 9)))
    with pytest.raises(ValueError):
        schedule.batches(60, 8, 2, 9)


def test_sample_is_seeded():
    assert np.array_equal(schedule.sample(1000, 50, 3), schedule.sample(1000, 50, 3))
    assert len(schedule.sample(10, 50, 3)) == 10
