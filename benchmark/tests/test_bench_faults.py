"""A run of each cell on the CPU at a tiny size (the port's plain twins in
place of its kernels), past the harness's look for a card: sound, it comes
out correct; with the timed path broken underneath, once for each fault the
cell can have (its kind's ``FAULTS``), ``correct`` comes out false.
"""

import time

import pytest
import torch

from benchmark.harness import spec
from benchmark.harness.main import measure

CPU = torch.device("cpu")
ORBIT8 = {"views": 2, "radius": 0.9, "height": 0.75, "center": [0.5, 0.3, 0.5]}
TINY = {
    "progressive": ({"depth": 4}, {"width": 24, "height": 16, "target_spp": 16, "warmup_views": 1, "orbit": ORBIT8,
                                   "check": {"views": 2, "pixels": 48, "block": 4096}}, 3.0),
    "train": ({"depth": 4}, {"views": 2, "width": 12, "height": 12, "warmup_steps": 1,
                             "check": {"steps": 3, "views_per_block": 1}}, 0.5),
}
CELLS = [(w["name"], spec.cell(w["name"])["traffic"]["kind"]) for w in spec.benchmark()["workloads"]]
FAULTS = [(name, kind, f) for name, kind in CELLS for f in spec.kind(kind).FAULTS]


def tiny(cell: dict) -> tuple:
    """The cell at a size the CPU runs: the scene at its depth, the
    traffic's sizes, and the window's seconds."""
    cfg, traffic, seconds = TINY[cell["traffic"]["kind"]]
    b = cell["config_file"]["builder"]
    config = dict(cell["config_file"], **cfg, builder=dict(b, kwargs=dict(b["kwargs"], **cfg)))
    return dict(cell, config_file=config, traffic=dict(cell["traffic"], **traffic)), seconds


def _run(name: str, seed: int = 2**31 + 7):
    cell, seconds = tiny(spec.cell(name))
    return measure(cell, seed, seconds, False, CPU, time.perf_counter())[0]


@pytest.mark.parametrize("name,kind", CELLS)
def test_sound_run_is_correct(name, kind):
    res = _run(name)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("name,kind,fault", FAULTS)
def test_broken_timed_path_is_not_correct(name, kind, fault):
    planted = spec.kind(kind).fault_patches(fault)
    for p in planted:
        p.start()
    try:
        res = _run(name)
    finally:
        for p in planted:
            p.stop()
    assert not res["correct"], res["check"]
