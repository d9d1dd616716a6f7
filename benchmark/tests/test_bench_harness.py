"""The harness's arithmetic and data on the CPU: rates and tails, the
timeline's idle share, the roofline byte counts, ``BENCHMARK.json``'s names
and units, and every per-layer metric's cells.

    python -m pytest benchmark/tests -q
"""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.harness import spec, stats
from benchmark.harness.trace import Timeline
from benchmark.rooflines import bounds

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_rate_counts_the_whole_window_and_a_stall_moves_it():
    passes = [0.05] * 40
    steady = stats.rate(40 * 100, sum(passes))
    stalled = stats.rate(40 * 100, sum(passes) + 0.5)  # the window holds a 0.5 s stall
    assert steady == pytest.approx(2000.0)
    assert stalled == pytest.approx(4000 / 2.5)


def test_tail_is_over_every_sample_and_a_stall_moves_it():
    times = [0.010] * 95 + [0.020] * 5
    assert stats.percentile(times, 95) == pytest.approx(0.0105)
    times_stalled = times[:-10] + [0.300] * 10
    assert stats.percentile(times_stalled, 95) == pytest.approx(0.300)
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0


def _ev(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def test_idle_share_from_a_synthetic_timeline():
    events = [
        _ev("user_annotation", "bench.window", 0, 1000),
        _ev("kernel", "void esvo_traverse_kernel<0>(Batch, AlphaTables, ShadowIO)", 100, 300),
        _ev("kernel", "void shade_forward_kernel<false>(ForwardParams)", 350, 100),  # overlaps the walk
        _ev("gpu_memset", "Memset (Device)", 600, 100),
        _ev("kernel", "outside", 2000, 50),  # after the window: not counted
        _ev("cpu_op", "aten::item", 450, 150),
        _ev("cuda_runtime", "cudaStreamSynchronize", 700, 300),
    ]
    tl = Timeline.from_events(events)
    assert tl.window_s == pytest.approx(1e-3)
    assert tl.busy_s == pytest.approx(450e-6)  # 100-450 and 600-700
    assert tl.idle_share() == pytest.approx(0.55)
    assert tl.device_seconds(r"\besvo_traverse_kernel\b") == pytest.approx(300e-6)
    gaps = dict(tl.breakdown()["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(150e-6)  # 450-600
    assert gaps["cudaStreamSynchronize"] == pytest.approx(300e-6)  # 700-1000
    assert gaps["bench.window"] == pytest.approx(100e-6)  # 0-100: only the window span runs
    ops = dict(tl.breakdown()["device_ops"])
    assert ops["esvo_traverse_kernel<0>"] == pytest.approx(300e-6)


def test_k5_and_p2_byte_counts_match_chip_smoke():
    import chip_smoke

    lanes = 65536
    assert bounds.K5_LANE_BYTES == chip_smoke.K5_LANE_BYTES == 288
    assert bounds.compact_bound(lanes)[0] * 1e3 == pytest.approx(chip_smoke.bound(lanes * 288 + 4, 0)[0])
    n = lanes * 5 * 21  # chip_smoke's P2 row: the headline's (65536, 5, 21) block
    expect = chip_smoke.bound(4 * n, (n // 4) * chip_smoke.PHILOX_OPS_PER_BLOCK)
    assert bounds.uniforms_bound(n)[0] * 1e3 == pytest.approx(expect[0])
    assert bounds.uniforms_bound(n)[1] == expect[1] == "bytes"
    assert bounds.MEM_BYTES_PER_S == chip_smoke.MEM_BYTES_PER_S and bounds.OPS_PER_S == chip_smoke.OPS_PER_S


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_every_file_under_paths_is_named_from_name_characters():
    bad = []
    for base in BENCH["paths"]:
        out = subprocess.run(["git", "ls-files", base], cwd=spec.ROOT, capture_output=True, text=True).stdout
        bad += [p for p in out.split() if not re.match(r"^[A-Za-z0-9_./-]+$", p)]
    assert not bad


def _reports(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        listed = m.get("workloads", cells)
        assert listed and all(c in cells for c in listed), m["name"]
        assert all(_reports(c, e2e[m["moves"]]) for c in listed), m["name"]
        assert os.path.exists(os.path.join(spec.BENCH_DIR, "metrics", m["name"] + ".json")) or os.path.exists(
            os.path.join(spec.BENCH_DIR, "metrics", m["name"] + ".py"))


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        c = spec.cell(w["name"], BENCH)
        names = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert c["per_layer"], w["name"]
        assert c["check"]["limits"], w["name"]
        kind = spec.kind(c["traffic"]["kind"])
        assert callable(kind.Driver) and callable(kind.check) and kind.FAULTS, w["name"]


def test_every_configuration_names_builders_both_sides_have():
    from benchmark.harness import drivers
    from benchmark.reference import scenes

    for c in BENCH["configs"]:
        cfg = spec.cell(next(w["name"] for w in BENCH["workloads"] if w["config"] == c["name"]), BENCH)["config_file"]
        b = cfg["builder"]
        assert callable(drivers.resolve("octree_pathtracing_tpu_torch", b["port"])), c["name"]
        assert callable(scenes.builder(b["reference"])), c["name"]
        assert b["kwargs"].get("depth", cfg["depth"]) == cfg["depth"], c["name"]


def test_the_harness_and_the_reference_import_no_jax_and_the_reference_no_port():
    """Every module the harness and the reference load, by top-level name
    compared whole: no ``jax``, ``jaxlib``, ``flax`` or JAX package; the
    reference alone loads nothing of the port either."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "import benchmark.reference.paths, benchmark.reference.scenes, benchmark.reference.training\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "import benchmark.harness.main, benchmark.harness.drivers, benchmark.harness.check, benchmark.harness.layers\n"
        "from benchmark.harness import spec\n"
        "for w in spec.benchmark()['workloads']: spec.kind(spec.cell(w['name'])['traffic']['kind'])\n"
        "import octree_pathtracing_tpu_torch.render.renderer\n"
        "import octree_pathtracing_tpu_torch.diff, octree_pathtracing_tpu_torch.cli\n"
        "print(json.dumps([ref, sorted({m.split('.')[0] for m in sys.modules})]))\n" % spec.ROOT
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    ref, every = json.loads(out.strip().splitlines()[-1])
    forbidden = {"jax", "jaxlib", "flax", "octree_pathtracing_tpu"}
    assert not forbidden & set(every), forbidden & set(every)
    assert "octree_pathtracing_tpu_torch" not in ref
    assert "octree_pathtracing_tpu_torch" in every  # the check sees the port's name, not a prefix of it


def test_the_reference_sources_name_no_port_module():
    root = os.path.join(spec.BENCH_DIR, "reference")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert not re.search(r"^\s*(from|import)\s+(octree_pathtracing_tpu|jax)", text, re.M), f
