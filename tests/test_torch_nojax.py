"""The port runs where jax and the JAX package are absent (the machine with
the card has neither): jax-blocked CLI render (with and without light
sampling) and train runs, and a source scan for imports of jax or of
``octree_pathtracing_tpu``.  Without ``--device`` the CLI asks for the card
and fails where there is none."""

import os
import re
import subprocess
import sys

import pytest
import torch

from octree_pathtracing_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "octree_pathtracing_tpu_torch")

_RENDER = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
from octree_pathtracing_tpu_torch.cli import main
main(["render", "--scene", "chunk", "--depth", "3", "--width", "8", "--height", "6",
      "--spp", "2", "--device", "cpu", "-o", sys.argv[1]])
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
"""


def test_cli_render_with_jax_blocked(tmp_path):
    out = tmp_path / "chunk.ppm"
    proc = subprocess.run(
        [sys.executable, "-c", _RENDER, str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "wrote" in proc.stdout and "render_pass" in proc.stderr
    data = out.read_bytes()
    assert data.startswith(b"P6\n8 6\n255\n") and len(data) == len(b"P6\n8 6\n255\n") + 8 * 6 * 3


_LIGHT = """
import sys
sys.modules["jax"] = None
sys.modules["octree_pathtracing_tpu"] = None
from octree_pathtracing_tpu_torch.cli import main
main(["render", "--scene", "room", "--depth", "3", "--width", "8", "--height", "6", "--spp", "2",
      "--sun", "high_quality", "--emitter-sampling", "one", "--device", "cpu", "-o", sys.argv[1]])
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
"""


def test_cli_light_sampling_render_with_jax_blocked(tmp_path):
    out = tmp_path / "room.ppm"
    proc = subprocess.run(
        [sys.executable, "-c", _LIGHT, str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "at 2 spp on cpu" in proc.stdout
    data = out.read_bytes()
    header = b"P6\n8 6\n255\n"
    assert data.startswith(header) and len(data) == len(header) + 8 * 6 * 3
    assert max(data[len(header):]) > 0  # the room is lit only by its emitters


@pytest.mark.parametrize("cmd", ["render", "train"])
def test_cli_without_device_fails_without_a_card(tmp_path, monkeypatch, cmd):
    """The entry points run on the card unless ``--device cpu`` asks for
    the CPU: without a card they raise, naming that option."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main([cmd, "--scene", "room", "--depth", "3", "-o", str(tmp_path / "out")])


_TRAIN = """
import sys
sys.modules["jax"] = None
sys.modules["octree_pathtracing_tpu"] = None  # the JAX package is not needed either
from octree_pathtracing_tpu_torch.cli import main
from octree_pathtracing_tpu_torch.io.checkpoint import load_arrays
main(["train", "--scene", "cutout", "--depth", "3", "--width", "6", "--height", "4", "--views", "2",
      "--steps", "2", "--device", "cpu", "-o", sys.argv[1]])
p = load_arrays(sys.argv[1])
assert p["atlas"].shape == (8, 16, 16, 4) and p["emittance"].shape == (8,)
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
"""


def test_cli_train_with_jax_blocked(tmp_path):
    out = tmp_path / "params.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN, str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "over 2 steps on cpu" in proc.stdout
    steps = [line for line in proc.stderr.splitlines() if '"train_step"' in line]
    assert len(steps) == 2


def test_no_port_source_imports_jax():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b"
        r"|import\s+octree_pathtracing_tpu(?!_torch)\b|from\s+octree_pathtracing_tpu(?!_torch)\b)",
        re.M,
    )
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(sources) > 10
    offenders = [p for p in sources if pattern.search(open(p).read())]
    assert not offenders, offenders
