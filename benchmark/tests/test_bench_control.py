"""The control, on the card: the reference with TF32 on, put in the
program's place, comes out not correct on three seeds.  Run by

    python -m pytest benchmark/tests -m gpu -p no:cacheprovider
"""

import pytest

from benchmark.readings import control


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["faceid_mnet.bulk_b32", "faceid_r50.bulk_b32"])
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_tf32_control_is_not_correct(card, workload, seed):
    numbers = control(workload, seed, card)
    assert not numbers["correct"], numbers
