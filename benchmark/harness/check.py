"""What every kind's check shares (``kinds/<kind>.py``'s ``check``): the
comparison that decides ``correct`` sets what the timed path produced
against the plain reference (``benchmark/reference``), once the window has
closed and the program's state is freed.

Each kind gives a few numbers; ``checks/<cell>.json`` gives each its
limit, and the run is correct where every number is at or below its
limit.  ``control=True`` puts the reference, computed in bfloat16 where
the configuration states float32, in the program's place: the precision
control, which has to fail.
"""

from __future__ import annotations

import numpy as np
import torch


def bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def round_state(st: dict) -> dict:
    """The control's lane state: the throughput and radiance kept in
    bfloat16 between bounces."""
    return dict(st, throughput=bf16(st["throughput"]), radiance=bf16(st["radiance"]))


def choose(seed: int, items: list, count: int) -> list:
    """``count`` of ``items`` drawn from the seed, in their order."""
    rng = np.random.default_rng([seed, 2])
    picked = rng.choice(len(items), size=min(count, len(items)), replace=False)
    return [items[i] for i in sorted(picked)]


def judge(numbers: dict, limits: dict) -> bool:
    """Correct where every limited number is there and at or below its
    limit."""
    return all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= lim for k, lim in limits.items())
