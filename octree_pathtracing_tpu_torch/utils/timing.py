"""Timing on the card: what a caller pays per call, and what the device
spends on it.

- :func:`call_ms`: CUDA events around back-to-back calls.  It includes the
  host path (Python, argument checks, allocation, the launch itself), so it
  is what an eager caller pays whenever that host path is longer than the
  kernel.
- :func:`device_ms`: the same calls captured into one CUDA graph and
  replayed, CUDA events around the replays, divided by the calls: device
  time alone.  A kernel launched through ``ctypes`` on PyTorch's current
  stream captures like any other.  Where capture fails, torch.profiler's
  device time stands in, and the result says so.

Run as a script, it times kernels P1 (row gather) and P2 (Philox uniforms)
of one or more checkouts of the port beside the PyTorch calls that compute
the same functions (``torch.index_select``, ``torch.rand``)::

    python3 octree_pathtracing_tpu_torch/utils/timing.py [--out FILE] ROOT [ROOT ...]

Each ROOT is a directory holding ``octree_pathtracing_tpu_torch/`` (this
checkout, or an older commit unpacked with ``git archive``); each is timed
in a process of its own, in the order given, so "parent, change, change,
parent" compares two commits on one card.  Shapes: P1 at the probe's
(131072, 8) int32 table with 4096 indices, and at the emitter grid's
(4096, 8) int32 and float32 tables with 65536 random indices; the emitter
pick's two gathers (one pair launch, or two single launches where the
checkout has no pair); P2 on the (65536, 5, 21) uniform block.  Every
kernel result is checked bit for bit against its plain-torch twin first.
Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

CALLS = 200  # back-to-back calls per call_ms
GRAPH_CALLS = 100  # calls captured per graph
REPLAYS = 5


def card_line() -> str:
    """``name, power.limit`` of the card in use, as nvidia-smi prints them."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    idx = int(first) if first.isdigit() else 0
    return lines[idx] if idx < len(lines) else lines[0]


def call_ms(fn, repeats: int = CALLS) -> float:
    """Mean ms per call over ``repeats`` back-to-back calls, after one
    warm-up: CUDA events, so the host path counts where it is longer than
    the device work."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def _graph_ms(fn, calls: int, replays: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def _profiler_ms(fn, calls: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / calls


def device_ms(fn, calls: int = GRAPH_CALLS, replays: int = REPLAYS):
    """(ms, how): device ms per call of ``fn``, from ``calls`` calls
    captured into one CUDA graph (how = "graph"); where capture fails, from
    torch.profiler's device time (how = "profiler: <the capture error>")."""
    try:
        return _graph_ms(fn, calls, replays), "graph"
    except Exception as e:  # noqa: BLE001 -- said on the result
        torch.cuda.synchronize()
        return _profiler_ms(fn, calls), f"profiler: capture failed ({type(e).__name__}: {e})"


def both(fn) -> dict:
    """{"call_ms", "device_ms", "device_by"} of ``fn``."""
    dms, how = device_ms(fn)
    return {"call_ms": call_ms(fn), "device_ms": dms, "device_by": how}


def _time_checkout() -> dict:
    """P1 and P2 of the package on ``sys.path`` (see the module's text)."""
    import octree_pathtracing_tpu_torch as port
    from octree_pathtracing_tpu_torch.ops import gather
    from octree_pathtracing_tpu_torch.ops.random import philox_uniforms, philox_uniforms_reference

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator().manual_seed(3)
    probe = torch.randint(-2**31, 2**31 - 1, (1 << 17, 8), generator=g, dtype=torch.int32).to(dev)
    probe_idx = torch.randint(0, 1 << 17, (4096,), generator=g, dtype=torch.int32).to(dev)
    grid_idx = torch.randint(0, 128, (4096, 8), generator=g, dtype=torch.int32).to(dev)
    grid_w = torch.rand((4096, 8), generator=g).to(dev)
    cells = torch.randint(0, 4096, (65536,), generator=g, dtype=torch.int32).to(dev)
    pair = getattr(gather, "row_gather_pair", None)
    if pair is None:  # a checkout from before the pair: the pick's two launches
        def pair(a, b, i):
            return gather.row_gather(a, i), gather.row_gather(b, i)

    def bits(x):
        return x.view(torch.int32)

    for table, idx in ((probe, probe_idx), (probe, probe_idx.long()), (grid_idx, cells), (grid_w, cells)):
        if not torch.equal(bits(gather.row_gather(table, idx)), bits(gather.row_gather_reference(table, idx))):
            raise AssertionError("P1 disagrees with its twin")
    if not all(torch.equal(bits(k), bits(gather.row_gather_reference(t, cells)))
               for k, t in zip(pair(grid_idx, grid_w, cells), (grid_idx, grid_w))):
        raise AssertionError("the pair disagrees with its twin")
    n_block = 65536 * 5 * 21
    if not torch.equal(philox_uniforms(12345, 7, n_block, dev), philox_uniforms_reference(12345, 7, n_block, dev)):
        raise AssertionError("P2 disagrees with its twin")

    probe_long, cells_long = probe_idx.long(), cells.long()
    out = {"package": os.path.dirname(port.__file__), "card": card_line(),
           "pair_launches": 1 if hasattr(gather, "row_gather_pair") else 2}
    cases = {
        "P1 probe int32 idx": lambda: gather.row_gather(probe, probe_idx),
        "P1 probe int64 idx": lambda: gather.row_gather(probe, probe_long),
        "index_select probe": lambda: torch.index_select(probe, 0, probe_long),
        "P1 grid_idx": lambda: gather.row_gather(grid_idx, cells),
        "P1 grid_w": lambda: gather.row_gather(grid_w, cells),
        "index_select grid_w": lambda: torch.index_select(grid_w, 0, cells_long),
        "P1 pick (grid_idx + grid_w)": lambda: pair(grid_idx, grid_w, cells),
        "2 x index_select pick": lambda: (torch.index_select(grid_idx, 0, cells_long),
                                          torch.index_select(grid_w, 0, cells_long)),
        "P2 (65536, 5, 21)": lambda: philox_uniforms(12345, 7, n_block, dev),
        "torch.rand (65536, 5, 21)": lambda: torch.rand((65536, 5, 21), device=dev),
    }
    for name, fn in cases.items():
        out[name] = both(fn)
    return out


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args[:1] == ["--one"]:  # a child: time the checkout at args[1]
        sys.path.insert(0, os.path.abspath(args[1]))
        if not torch.cuda.is_available():
            print("timing: no CUDA device", file=sys.stderr)
            return 1
        print("RESULT " + json.dumps(_time_checkout()), flush=True)
        return 0
    out_file = None
    if args[:1] == ["--out"]:
        out_file, args = args[1], args[2:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in args:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"timing {root} failed (exit {proc.returncode})")
        runs.append(dict(root=root, **json.loads(lines[-1][len("RESULT "):])))
        print(f"{root}: {runs[-1]['package']} [{runs[-1]['card']}]", flush=True)
    for name in (k for k, v in runs[0].items() if isinstance(v, dict)):
        cells = " | ".join(f"{r['root']}: call {r[name]['call_ms']!r} device {r[name]['device_ms']!r}"
                           + ("" if r[name]["device_by"] == "graph" else f" ({r[name]['device_by']})")
                           for r in runs)
        print(f"{name}: {cells}", flush=True)
    if out_file:
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        with open(out_file, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.path.pop(0)  # this file's directory: the checkout to time comes first
    sys.exit(main())
