"""The reference against the port on the CPU, where the port runs its
plain twins: a progressive view's pixels and the first training steps, on
each configuration at depth 4.  The reference
builds its own scene, from the grid; the port builds its own.
"""

import dataclasses
import math

import pytest
import torch

from benchmark.harness import drivers, spec
from benchmark.reference import paths as ref_paths
from benchmark.reference import scenes as ref_scenes
from benchmark.reference import training as ref_training

CONFIGS = [c["name"] for c in spec.benchmark()["configs"]]
CPU = torch.device("cpu")
SEED = 2**31 + 99
ORBIT = {"views": 2, "radius": 0.9, "height": 0.75, "center": [0.5, 0.3, 0.5]}


def _config(name: str) -> dict:
    c = {x["name"]: x for x in spec.benchmark()["configs"]}[name]
    import json
    import os

    with open(os.path.join(spec.ROOT, c["file"])) as f:
        cfg = json.load(f)
    b = cfg["builder"]
    return dict(cfg, depth=4, builder=dict(b, kwargs=dict(b["kwargs"], depth=4)))


@pytest.mark.parametrize("name", CONFIGS)
def test_view_pixels_equal_the_renderer(name):
    from octree_pathtracing_tpu_torch.render.renderer import Renderer

    cfg = _config(name)
    eye, center = drivers.orbit_eye(ORBIT, 4, 0.7), drivers.orbit_center(ORBIT, 4)
    r = Renderer(scene=drivers.port_scene(cfg, CPU), camera=drivers.port_camera(eye, center, CPU), width=20,
                 height=12, target_spp=24, branch_count=10, seed=SEED, n_bounces=cfg["bounces"])
    fb = r.render().reshape(-1, 3)
    pix = torch.tensor([0, 7, 33, 100, 151, 239])
    ref = ref_paths.view_pixels(ref_scenes.build_scene(cfg, CPU, cache_dir=None), ref_scenes.camera(eye, center, CPU),
                                20, 12, pix, SEED, 24, 10, cfg["bounces"], block=50)
    assert torch.equal(fb[pix], ref)


def test_train_steps_follow_inverse_render():
    from octree_pathtracing_tpu_torch.diff import inverse_render, render_views

    cfg = _config(CONFIGS[0])
    center = drivers.orbit_center(ORBIT, 4)
    eyes = [drivers.orbit_eye(ORBIT, 4, 2 * math.pi * i / 3) for i in range(3)]
    scene = drivers.port_scene(cfg, CPU)
    cams = [drivers.port_camera(e, center, CPU) for e in eyes]
    tgt = render_views(scene, cams, 10, 10, seed=SEED)
    res = inverse_render(scene, cams, tgt, 10, 10, steps=2, lr=0.05, seed=SEED, soft_weight=0.25)
    ref = ref_training.train_steps(ref_scenes.build_scene(cfg, CPU, cache_dir=None),
                                   [ref_scenes.camera(e, center, CPU) for e in eyes], 10, 10, SEED, steps=2, lr=0.05,
                                   soft_weight=0.25, n_bounces=cfg["bounces"], views_per_block=2)
    assert res.losses == pytest.approx(ref["losses"], rel=1e-5)
    for mine, theirs in zip(res.params.values(), ref["after"]):
        assert torch.allclose(mine, theirs, rtol=1e-4, atol=1e-6)


def test_philox_at_equals_the_stream():
    from octree_pathtracing_tpu_torch.ops.random import philox_uniforms_reference

    full = philox_uniforms_reference(SEED, 5 << 32, 1001)
    idx = torch.tensor([0, 1, 2, 3, 4, 511, 998, 999, 1000])
    assert torch.equal(ref_paths.philox_at(SEED, 5 << 32, idx, CPU), full[idx])


def test_pass_plan_is_the_renderers_schedule():
    from octree_pathtracing_tpu_torch.render.renderer import branch_schedule

    spp, plan = 0, []
    while spp < 64:
        n = min(branch_schedule(spp, 10), 64 - spp)
        plan.append(n)
        spp += n
    assert [n for n, _ in ref_paths.pass_plan(64, 10)] == plan == [1, 1, 1, 1, 6, 10, 10, 10, 10, 10, 4]
    assert dataclasses.is_dataclass(drivers.Window)
