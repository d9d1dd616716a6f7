"""The least time a kernel's call could take on the card: a frozen copy of
``chip_smoke.py``'s ``bound`` and of the byte and operation counts of K5
(the live-lane compaction) and P2 (the uniforms), with the published H100
SXM peaks.

A share of the roofline is ``bound / device time``.  The peaks assume the
card's full 700 W; :func:`power_limit_w` reads the limit the card runs
under, which the harness prints beside every share.
"""

from __future__ import annotations

import subprocess

MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# K5 per lane: the state's rows (origin, dir, throughput, radiance), flags
# (active, specular), medium and carried index, read once and written once;
# pos written; the bounce's 21 uniform words read and written
K5_STATE_BYTES = 48 + 2 + 4 + 4
K5_LANE_BYTES = 2 * K5_STATE_BYTES + 4 + 2 * 84

# P2: 10 rounds of 2 mul-hi/lo pairs, 4 xor, 2 key adds; 4 float maps
PHILOX_OPS_PER_BLOCK = 112


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(seconds, "bytes" | "operations"): the larger of bytes over the
    memory rate and operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / MEM_BYTES_PER_S, n_ops / OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def compact_bound(lanes: int) -> tuple:
    """One ``compact_forward`` call over ``lanes`` lanes (chip_smoke's
    ``lanes * K5_LANE_BYTES + 4``: the lane rows and the live count)."""
    return bound(lanes * K5_LANE_BYTES + 4, 0)


def uniforms_bound(n: int) -> tuple:
    """One P2 call drawing ``n`` float32 uniforms: ``4 n`` bytes written,
    ``n / 4`` Philox blocks."""
    return bound(4 * n, (n // 4) * PHILOX_OPS_PER_BLOCK)


BOUNDS = {"compact": compact_bound, "uniforms": uniforms_bound}


def power_limit_w() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ("700.00 W"), or
    "unknown"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"
