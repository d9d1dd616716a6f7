"""The port runs where jax and the JAX package are absent (the machine with
the card has neither): jax-blocked CLI render (with and without light
sampling), preview, checkpoint and resume, and train runs (on the
terrain's cutout and on block models), a render of a region file
(``--world``), and a source scan for imports of jax or of
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


_TRAIN_PLANT = """
import sys
sys.modules["jax"] = None
sys.modules["octree_pathtracing_tpu"] = None
from octree_pathtracing_tpu_torch.cli import main
from octree_pathtracing_tpu_torch.io.checkpoint import load_arrays
main(["train", "--scene", "plant", "--depth", "3", "--width", "6", "--height", "4", "--views", "2",
      "--steps", "2", "--device", "cpu", "-o", sys.argv[1]])
p = load_arrays(sys.argv[1])
assert p["atlas"].shape == (3, 16, 16, 4) and p["emittance"].shape == (3,)
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
"""


def test_cli_train_on_block_models_with_jax_blocked(tmp_path):
    """Training on the plant field: the quad-model accept in all three walks
    (the render, the recording walk of the soft loss, the sun shadow walk)."""
    out = tmp_path / "params.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _TRAIN_PLANT, str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "over 2 steps on cpu" in proc.stdout
    assert len([line for line in proc.stderr.splitlines() if '"train_step"' in line]) == 2


_WORLD = """
import sys
import numpy as np
sys.modules["jax"] = None
sys.modules["octree_pathtracing_tpu"] = None
from octree_pathtracing_tpu_torch.cli import main
from octree_pathtracing_tpu_torch.models import make_region_fixture
from octree_pathtracing_tpu_torch.models import mca
blocks = ["minecraft:air", "minecraft:stone", "minecraft:grass_block", "minecraft:oak_leaves",
          "minecraft:glowstone", "minecraft:water"]
g = np.zeros((16, 16, 16), np.uint16)  # [y, z, x]
g[0], g[1], g[2, 5:9, 5:9], g[1, 10, 3], g[1, 2:5, 10:14] = 1, 2, 3, 4, 5
with open(sys.argv[1], "wb") as f:
    f.write(make_region_fixture({(0, 0): {-4: (blocks, g.ravel())}}))
main(["render", "--world", sys.argv[1], "--depth", "4", "--width", "8", "--height", "6", "--spp", "2",
      "--sun", "high_quality", "--emitter-sampling", "one", "--device", "cpu", "-o", sys.argv[2]])
main(["info", "--world", sys.argv[1], "--depth", "4"])
print("parser", mca.parse_sections(open(sys.argv[1], "rb").read())[1])
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
"""


def test_cli_world_render_with_jax_blocked(tmp_path):
    """``cli render --world`` and ``cli info --world`` on a region written in
    code, under the HIGH_QUALITY sun with one-emitter NEE."""
    out = tmp_path / "world.ppm"
    proc = subprocess.run(
        [sys.executable, "-c", _WORLD, str(tmp_path / "r.0.0.mca"), str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "at 2 spp on cpu" in proc.stdout and "octree: depth=4" in proc.stdout
    assert "parser native" in proc.stdout or "parser numpy" in proc.stdout
    data = out.read_bytes()
    header = b"P6\n8 6\n255\n"
    assert data.startswith(header) and len(data) == len(header) + 8 * 6 * 3 and max(data[len(header):]) > 0


_NEE = """
import sys
sys.modules["jax"] = None
sys.modules["octree_pathtracing_tpu"] = None
import numpy as np
import torch
from octree_pathtracing_tpu_torch.models import emissive_room_scene, pixel_grid_rays
from octree_pathtracing_tpu_torch.models.emitters import with_emitter_sampling
from octree_pathtracing_tpu_torch.ops import nee
from octree_pathtracing_tpu_torch.render import trace_paths
scene, cam = emissive_room_scene(depth=3)
scene = with_emitter_sampling(scene, "all")
o, d = pixel_grid_rays(cam, 4, 3)
u = torch.from_numpy(np.random.default_rng(0).random((12, 2, 21), dtype=np.float32))
rad = trace_paths(scene, o, d, u)
assert nee.nee_plan(scene).faces == 3 * scene.emitters.count and bool(torch.isfinite(rad).all())
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
print("faces", nee.nee_plan(scene).faces)
"""


def test_nee_module_runs_with_jax_blocked():
    """``ops/nee.py`` (K4's next-event half and K6) imports and runs
    (``EmitterSampling.ALL`` over the room's 64 emitters, on the CPU) with
    neither jax nor the JAX package importable."""
    proc = subprocess.run([sys.executable, "-c", _NEE], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "faces 192" in proc.stdout
    assert os.path.exists(os.path.join(PORT, "ops", "nee.py"))  # among the sources the scan below reads


_COMPACT = """
import sys
sys.modules["jax"] = None
sys.modules["octree_pathtracing_tpu"] = None
import torch
from octree_pathtracing_tpu_torch.ops import compact
g = torch.Generator().manual_seed(0)
st = dict(origin=torch.rand((9, 3), generator=g), dir=torch.rand((9, 3), generator=g),
          throughput=torch.rand((9, 3), generator=g), radiance=torch.rand((9, 3), generator=g),
          active=torch.rand(9, generator=g) < 0.5, specular=torch.zeros(9, dtype=torch.bool),
          cur_mat=torch.zeros(9, dtype=torch.int32))
counts = torch.zeros(3, dtype=torch.int32)
out, u = compact.compact(st, torch.rand((9, 3, 21), generator=g), 1, counts)
n = int(st["active"].sum())
assert int(counts[1]) == n and bool(out["active"][:n].all()) and not bool(out["active"][n:].any())
assert torch.equal(compact.unpermute(out["radiance"], out["idx"]), st["radiance"])
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
print("live", n)
"""


def test_compact_module_runs_with_jax_blocked():
    """``ops/compact.py`` (K5) imports and runs its plain versions on the
    CPU with neither jax nor the JAX package importable."""
    proc = subprocess.run([sys.executable, "-c", _COMPACT], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "live" in proc.stdout
    assert os.path.exists(os.path.join(PORT, "ops", "compact.py"))  # among the sources the scan below reads


_PREVIEW_RESUME = """
import sys
sys.modules["jax"] = None
sys.modules["octree_pathtracing_tpu"] = None
from octree_pathtracing_tpu_torch.cli import main
out, ck = sys.argv[1], sys.argv[2]
main(["preview", "--scene", "plant", "--depth", "3", "--width", "8", "--height", "6", "--device", "cpu",
      "-o", out + "/preview.ppm"])
common = ["--scene", "cutout", "--depth", "3", "--width", "8", "--height", "6", "--device", "cpu"]
main(["render", *common, "--spp", "2", "--checkpoint", ck, "-o", out + "/a.ppm"])
main(["render", *common, "--spp", "4", "--resume", ck, "-o", out + "/b.ppm"])
main(["render", *common, "--spp", "4", "-o", out + "/c.ppm"])
assert open(out + "/b.ppm", "rb").read() == open(out + "/c.ppm", "rb").read()
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
"""


def test_cli_preview_and_resume_with_jax_blocked(tmp_path):
    """``cli preview`` on the plant field (K2q's walk, K10's twin) and a
    render checkpointed at 2 spp and resumed to 4, equal to a 4-spp render
    byte for byte, with neither jax nor the JAX package importable."""
    proc = subprocess.run(
        [sys.executable, "-c", _PREVIEW_RESUME, str(tmp_path), str(tmp_path / "ck.npz")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("on cpu") == 4 and "at 4 spp" in proc.stdout
    header = b"P6\n8 6\n255\n"
    data = (tmp_path / "preview.ppm").read_bytes()
    assert data.startswith(header) and len(data) == len(header) + 8 * 6 * 3


def test_cli_preview_without_device_fails_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["preview", "--scene", "room", "--depth", "3", "-o", str(tmp_path / "out")])


# the driver surface's modules, which the scan below reads with every other
DRIVER_MODULES = ("config.py", "ops/preview.py", "render/preview.py", "render/testimages.py", "octree/edit.py",
                  "utils/mathx.py", "utils/bits.py", "utils/colors.py", "parallel/mesh.py", "parallel/distributed.py",
                  "parallel/shard.py", "io/checkpoint.py")


@pytest.mark.parametrize("module", DRIVER_MODULES)
def test_source_scan_covers_the_driver_modules(module):
    """Each driver module is a Python file under the port's package (the
    scan walks them all) and names neither jax nor the JAX package."""
    path = os.path.join(PORT, module)
    assert os.path.isfile(path)
    text = open(path).read()
    assert not re.search(r"^\s*(import|from)\s+(jax|octree_pathtracing_tpu)\b(?!_torch)", text, re.M)


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
