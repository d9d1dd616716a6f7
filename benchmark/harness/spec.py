"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, and under ``benchmark/`` a file per configuration, traffic
mix, per-layer metric and cell check.

- ``configs/<config>.json``: the deployment.  ``builder`` names the scene
  builder under the port's package (``port``) and under
  ``benchmark/reference`` (``reference``), with the keyword arguments
  both are called with (``kwargs``); ``depth`` sets the scene's side,
  ``2**depth``, that the cameras are placed by; then the lighting
  strategies, the bounce cap and the precision it states.
- ``traffic/<mix>.json``: the traffic mix's parameters, read by the
  driver of the ``kind`` it names.
- ``kinds/<kind>.py``: a kind's ``Driver``, its ``check`` and its
  planted faults.
- ``metrics/<metric>.json``: a per-layer metric's reader and its
  parameters (``harness/layers.py``), or ``metrics/<metric>.py`` with a
  ``read(ctx)`` of its own.
- ``checks/<cell>.json``: the numbers that decide a cell's ``correct``
  and their limits.
"""

from __future__ import annotations

import importlib
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str, bench: dict | None = None) -> dict:
    """The ``workloads`` entry of ``name`` with its configuration entry,
    the configuration's file, the traffic file, its end-to-end and
    per-layer metrics and its check: {"workload", "config", "config_file",
    "traffic", "end_to_end", "per_layer", "check"}."""
    bench = bench or benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def reported(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "workload": w,
        "config": config,
        "config_file": _load(os.path.join(ROOT, config["file"])),
        "traffic": _load(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")),
        "end_to_end": [m for m in bench["end_to_end"] if reported(m)],
        "per_layer": [m for m in bench["per_layer"] if reported(m)],
        "check": _load(os.path.join(BENCH_DIR, "checks", f"{name}.json")),
    }


def kind(name: str):
    """The traffic kind ``name``'s module, ``kinds/<name>.py``."""
    if not os.path.exists(os.path.join(BENCH_DIR, "kinds", f"{name}.py")):
        raise KeyError(f"no traffic kind {name!r} under benchmark/kinds")
    return importlib.import_module(f"benchmark.kinds.{name}")


def metric_reader(name: str):
    """The per-layer metric ``name``'s reader: ``metrics/<name>.py``'s
    ``read`` where that file exists, else the general reader named by
    ``metrics/<name>.json``, bound to that file's parameters."""
    py = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if os.path.exists(py):
        import importlib.util

        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", py)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
    from . import layers

    params = _load(os.path.join(BENCH_DIR, "metrics", f"{name}.json"))
    reader = getattr(layers, params["reader"])
    return lambda ctx: reader(ctx, params)


def kernel_layers() -> dict:
    """{layer: [kernel name, ...]}: the port's ``__global__`` kernels by
    the layer they belong to (``metrics/kernels.json``)."""
    return _load(os.path.join(BENCH_DIR, "metrics", "kernels.json"))
