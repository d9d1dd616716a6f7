"""One run of one cell: set up, measure for ``--seconds``, check, print.

The last line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` the per-layer
metrics, ``busy_s``, ``window_s`` and ``breakdown``); the numbers the check
compared, each beside its limit, are the last lines of standard error and
the result's last key.  A run without the CUDA cards the cell asks for, or
with ``jax`` or the JAX package loaded once the window has closed, prints
no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "octree_pathtracing_tpu")


@dataclasses.dataclass
class Run:
    name: str
    config_file: dict
    traffic: dict
    seed: int
    device: object
    driver: object = None


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is ``jax``, ``jaxlib``, ``flax`` or the JAX package."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN and sys.modules[m] is not None)


def measure(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float, control: bool = False):
    """Set up, run the window and check it: (result dict, {number: (value,
    limit)}).  ``cell`` is ``spec.cell``'s record; ``control`` puts the
    precision control in the program's place in the check."""
    import torch

    from . import check, trace as tracing

    kind = spec.kind(cell["traffic"]["kind"])
    run = Run(cell["workload"]["name"], cell["config_file"], cell["traffic"], seed, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_driver = time.perf_counter()
    run.driver = kind.Driver(run.config_file, run.traffic, device, seed)
    setup_s = time.perf_counter() - t_start
    phases = dict(start=t_driver - t_start, **run.driver.setup_phases)
    print("benchmark: set-up phases " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()), file=sys.stderr)
    if trace:
        out = {}
        with tracing.profiled(out):
            with torch.profiler.record_function(tracing.WINDOW_SPAN):
                win = run.driver.window(seconds)
        timeline = out["timeline"]
    else:
        win = run.driver.window(seconds)
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0

    if trace:
        ctx = dataclasses.make_dataclass("Ctx", ["timeline", "units", "calls"])(timeline, win.units, win.calls)
        metrics = {}
        for m in cell["per_layer"]:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win.end_to_end, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell["end_to_end"]}

    answers = win.answers
    run.driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = kind.check(run, answers, control=control)
    print(f"benchmark: {run.name} seed {seed}: set-up {setup_s:.2f} s, window {win.seconds:.2f} s, "
          f"check {time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    limits = cell["check"]["limits"]
    result = {"correct": check.judge(numbers, limits), "attempted": win.attempted, "failed": 0,
              "metrics": metrics, "device": {}}
    if device.type == "cuda":
        from ..rooflines.bounds import power_limit_w

        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                            "count": int(cell["workload"]["chips"]), "memory_peak_bytes": peak,
                            "power_limit": power_limit_w()}
    if trace:
        result["device"].update(busy_s=timeline.busy_s, window_s=timeline.window_s)
        result["breakdown"] = timeline.breakdown()
    compared = {k: (numbers.get(k, float("nan")), lim) for k, lim in limits.items()}
    compared.update({k: (v, None) for k, v in numbers.items() if k not in limits})
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result, compared


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = spec.cell(args.workload)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s), this machine has {have}", file=sys.stderr)
        return 2
    result, compared = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of jax or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for k, (v, lim) in compared.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
