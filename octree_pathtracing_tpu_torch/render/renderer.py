"""Progressive renderer (port of ``render/renderer.py``).

The whole frame is one lane batch: ray generation with per-pass jitter,
the wavefront path trace, and the running-average update
``fb = (fb * spp + new) / (spp + n)`` on a framebuffer on the scene's
device, with the reference's branch-count warmup schedule.  Every random
draw (pixel jitter and uniform block) is ``philox_uniforms(seed, counter)``
on that device: the renderer keeps an integer seed and a draw counter and
no generator state, and each draw takes the next counter.  So the
progressive state is the framebuffer, the spp, the seed and the counter,
which ``io/checkpoint.save_render_checkpoint`` writes and
``load_render_checkpoint`` restores.  The controls are the reference's
renderer messages as methods: ``reset``, ``set_target_spp``,
``set_camera`` (which resets) and ``render`` (passes until the target).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.camera import Camera, pixel_grid_rays
from ..models.scene import Scene
from ..ops.random import philox_uniforms
from ..ops.texture import float_to_u8
from .pathtracer import MAX_BOUNCES, draw_uniforms, trace_paths, trace_paths_branched


def branch_schedule(current_spp: int, branch_count: int) -> int:
    """Branch-count warmup: single samples first, then a ramp so spp lands
    on a multiple of branch_count."""
    if current_spp < branch_count:
        if current_spp <= int(np.sqrt(branch_count)):
            return 1
        return branch_count - current_spp
    return branch_count


def _jittered_rays(camera: Camera, width: int, height: int, seed: int, counter: int):
    dim = float(max(width, height))
    u = philox_uniforms(seed, counter, width * height * 2, camera.eye.device).reshape(-1, 2)
    jitter = u * (2.0 / dim) - 1.0 / dim  # uniform in [-1/dim, 1/dim)
    return pixel_grid_rays(camera, width, height, jitter)


def _accumulate(framebuffer, current_spp: int, new_color, n: int):
    h, w = framebuffer.shape[:2]
    fb = (framebuffer * float(current_spp) + new_color.reshape(h, w, 3)) / float(current_spp + n)
    return fb, current_spp + n


def render_pass(
    scene: Scene,
    camera: Camera,
    framebuffer,
    current_spp: int,
    seed: int,
    counter: int,
    width: int,
    height: int,
    spp_this_pass: int,
    n_bounces: int = MAX_BOUNCES,
):
    """One progressive pass of ``spp_this_pass`` jittered samples per pixel,
    folded into the running average.  Sample ``k`` draws its jitter from
    stream ``counter + 2k`` and its uniforms from ``counter + 2k + 1``.
    Returns (framebuffer, new_spp)."""
    dev = framebuffer.device
    new_color = torch.zeros((width * height, 3), dtype=torch.float32, device=dev)
    for k in range(spp_this_pass):
        origins, dirs = _jittered_rays(camera, width, height, seed, counter + 2 * k)
        u = draw_uniforms(seed, counter + 2 * k + 1, width * height, n_bounces, dev)
        new_color += trace_paths(scene, origins, dirs, u)
    return _accumulate(framebuffer, current_spp, new_color, spp_this_pass)


def render_pass_branched(
    scene: Scene,
    camera: Camera,
    framebuffer,
    current_spp: int,
    seed: int,
    counter: int,
    width: int,
    height: int,
    branches: int,
    n_bounces: int = MAX_BOUNCES,
):
    """One pass with first-hit branch replication: one jittered primary ray
    per pixel (stream ``counter``) and ``branches`` continuations from its
    first hit (uniforms from stream ``counter + 1``), worth ``branches``
    samples in the running average."""
    n_px = width * height
    origins, dirs = _jittered_rays(camera, width, height, seed, counter)
    u = draw_uniforms(seed, counter + 1, n_px * branches, n_bounces, framebuffer.device)
    u = u.reshape(n_px, branches, n_bounces, -1)
    new_color = trace_paths_branched(scene, origins, dirs, u) * branches
    return _accumulate(framebuffer, current_spp, new_color, branches)


@dataclasses.dataclass
class Renderer:
    """Progressive path-traced renderer: ``step`` runs one pass, ``reset``
    starts over.  ``counter`` is the next Philox stream to draw from."""

    scene: Scene
    camera: Camera
    width: int
    height: int
    target_spp: int = 64
    branch_count: int = 10
    seed: int = 0
    n_bounces: int = MAX_BOUNCES

    def __post_init__(self):
        self.reset()

    def reset(self):
        dev = self.scene.device
        self.framebuffer = torch.zeros((self.height, self.width, 3), dtype=torch.float32, device=dev)
        self.current_spp = 0
        self.counter = 0

    def set_target_spp(self, spp: int):
        self.target_spp = spp

    def set_camera(self, camera: Camera):
        """Move the camera; the accumulated frame starts over."""
        self.camera = camera
        self.reset()

    @property
    def spp(self) -> int:
        return self.current_spp

    def step(self) -> bool:
        """Run one progressive pass; returns False once target_spp is reached.
        Work is queued on the device; the call does not wait for it."""
        spp_now = self.current_spp
        if spp_now >= self.target_spp:
            return False
        n = min(branch_schedule(spp_now, self.branch_count), self.target_spp - spp_now)
        args = (self.scene, self.camera, self.framebuffer, spp_now, self.seed, self.counter,
                self.width, self.height, n, self.n_bounces)
        if n > 1:
            self.framebuffer, self.current_spp = render_pass_branched(*args)
        else:
            self.framebuffer, self.current_spp = render_pass(*args)
        self.counter += 2 * n  # at most two draws per sample: jitter and uniforms
        return True

    def render(self, passes: int | None = None):
        """Run passes until ``target_spp`` (or ``passes`` of them); returns
        the linear float framebuffer."""
        count = 0
        while self.step():
            count += 1
            if passes is not None and count >= passes:
                break
        return self.framebuffer

    def get_image(self) -> np.ndarray:
        """Gamma-compressed u8 frame."""
        return float_to_u8(self.framebuffer)
