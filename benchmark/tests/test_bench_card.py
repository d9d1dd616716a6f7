"""The precision control on the card, at each cell's own size: the
reference in bfloat16, put in the program's place, has to come out as not
correct on three seeds.  Skips where there is no CUDA card.

    python -m pytest benchmark/tests/test_bench_card.py -q -s
"""

import pytest

from benchmark.harness import spec
from benchmark.harness.readings import readings

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_precision_control_fails(cuda, name):
    got = readings(name, [2**31 + 101, 2**31 + 202, 2**31 + 303], 3.0, control=True, device=cuda)
    for r in got:
        print(r)
    assert not any(r["correct"] for r in got)
