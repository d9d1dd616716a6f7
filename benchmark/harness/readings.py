"""The readings a cell's limits are set from, in one process: the numbers
the check compares for the program on many seeds, and for the precision
control (the reference in bfloat16 in the program's place), each after a
short window at the cell's own load.  The benchmark's own runs do not run
this.

    python3 -m benchmark.harness.readings --workload <cell> --seeds 1 2 3 [--control | --fault F] [--seconds 4]

One JSON line per seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import time


def readings(name: str, seeds, seconds: float, control: bool, device=None, fault: str | None = None) -> list:
    """One reading per seed: {"workload", "seed", "control", "fault",
    "correct", "numbers"}.  ``fault`` plants one of the cell's kind's faults
    (``kinds/<kind>.py``) in the program first."""
    import torch

    from . import spec
    from .main import measure

    cell = spec.cell(name)
    device = device or torch.device("cuda", 0)
    planted = spec.kind(cell["traffic"]["kind"]).fault_patches(fault) if fault else []
    out = []
    for p in planted:
        p.start()
    try:
        for seed in seeds:
            res, compared = measure(cell, int(seed), seconds, False, device, time.perf_counter(), control=control)
            out.append({"workload": name, "seed": int(seed), "control": control, "fault": fault,
                        "correct": res["correct"], "numbers": {k: v for k, (v, _) in compared.items()}})
    finally:
        for p in planted:
            p.stop()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.harness.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", help="one of the kind's FAULTS")
    args = p.parse_args(argv)
    for r in readings(args.workload, args.seeds, args.seconds, args.control, fault=args.fault):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
