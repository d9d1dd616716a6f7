"""A progressive render: ``render.renderer.Renderer`` at the traffic's
window size and sample target, one user in a closed loop.  Each pass is
``step()`` and a ``synchronize``, as ``cli render`` runs it; a finished
view moves the camera (``set_camera``) to the next orbit camera, in turn.

The check: views drawn from the seed among those the window finished, at
pixels drawn from the seed; per pixel the error ``max_c |p - r| / (max_c
|r| + 1e-3)``.  ``pixels_off``: the share of pixels whose error is above
1e-4 (a path that took another turn moves its pixel by ~1/64);
``median_err``: the median error.
"""

from __future__ import annotations

import math
import time
from unittest import mock

import torch

from ..harness.check import bf16, choose, round_state
from ..harness.drivers import Window, orbit_center, orbit_eye, port_camera, port_scene, sample_pixels, sync
from ..harness.stats import percentile, rate
from ..reference import paths as ref_paths
from ..reference import scenes as ref_scenes

PIXEL_TOL = 1e-4


class Driver:
    def __init__(self, config: dict, traffic: dict, dev, seed: int):
        from octree_pathtracing_tpu_torch.render.renderer import Renderer

        self.config, self.traffic, self.dev, self.seed = config, traffic, dev, seed
        t = traffic
        orbit = t["orbit"]
        self.eyes = [orbit_eye(orbit, config["depth"], 2 * math.pi * i / orbit["views"])
                     for i in range(orbit["views"])]
        self.center = orbit_center(orbit, config["depth"])
        at = time.perf_counter()
        self.scene = port_scene(config, dev)
        self.cams = [port_camera(e, self.center, dev) for e in self.eyes]
        sync(dev)
        self.setup_phases = {"scene": time.perf_counter() - at}
        self.renderer = Renderer(scene=self.scene, camera=self.cams[0], width=t["width"], height=t["height"],
                                 target_spp=t["target_spp"], branch_count=t["branch_count"], seed=seed,
                                 n_bounces=config["bounces"])
        self.pixels = sample_pixels(seed, t["width"] * t["height"], t["check"]["pixels"])
        self._pix = torch.as_tensor(self.pixels, device=dev)
        at = time.perf_counter()
        for _ in range(t["warmup_views"]):  # every pass shape of a view
            self.renderer.set_camera(self.cams[0])
            self.renderer.render()
        sync(dev)
        self.setup_phases["warm-up"] = time.perf_counter() - at

    def _calls(self, n: int, calls: dict):
        t, nb = self.traffic, self.config["bounces"]
        px = t["width"] * t["height"]
        calls.setdefault("uniforms", []).extend([2 * px, px * n * nb * 21] if n > 1 else [2 * px, px * nb * 21])
        calls.setdefault("compact", []).extend([px * n] * (nb - 1))

    def window(self, seconds: float) -> Window:
        r, dev, t = self.renderer, self.dev, self.traffic
        px = t["width"] * t["height"]
        times, answers, calls = [], [], {}
        samples, cam = 0, 0
        r.set_camera(self.cams[cam])
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            before = r.spp
            with torch.profiler.record_function("pass.step"):
                r.step()
            with torch.profiler.record_function("pass.synchronize"):
                sync(dev)
            now = time.perf_counter()
            times.append(now - a)
            n = r.spp - before
            samples += px * n
            self._calls(n, calls)
            if r.spp >= t["target_spp"]:
                answers.append((cam, r.framebuffer.reshape(-1, 3)[self._pix].clone()))
                cam = (cam + 1) % len(self.cams)
                with torch.profiler.record_function("view.set_camera"):
                    r.set_camera(self.cams[cam])
            if now - t0 >= seconds:
                break
        secs = time.perf_counter() - t0
        if r.spp > 0:  # the view the window's close cut: finished untimed, so every view begun is checked
            r.render()
            answers.append((cam, r.framebuffer.reshape(-1, 3)[self._pix].clone()))
        return Window(
            seconds=secs,
            end_to_end={"samples_per_s": rate(samples, secs), "pass_p95_ms": 1e3 * percentile(times, 95.0)},
            attempted=len(times),
            units={"view": samples / (px * t["target_spp"])},
            calls=calls,
            answers=answers,
        )

    def release(self):
        self.renderer = self.scene = self.cams = None


def _pixel_errors(prog, ref):
    err = (prog - ref).abs().amax(dim=1) / (ref.abs().amax(dim=1) + 1e-3)
    return err.double().cpu()


def check(run, answers, control: bool = False) -> dict:
    cfg, t = run.config_file, run.traffic
    latest = {}
    for cam, vals in answers:  # a camera's views are the same image: keep its last
        latest[cam] = vals
    chosen = choose(run.seed, sorted(latest.items()), t["check"]["views"])
    if not chosen:
        return {"views_checked": 0.0}
    scene = ref_scenes.build_scene(cfg, run.device)
    pix = torch.as_tensor(run.driver.pixels, device=run.device)
    errs = []
    for cam, vals in chosen:
        c = ref_scenes.camera(run.driver.eyes[cam], run.driver.center, run.device)
        args = (scene, c, t["width"], t["height"], pix, run.seed, t["target_spp"], t["branch_count"], cfg["bounces"])
        ref = ref_paths.view_pixels(*args, block=t["check"]["block"])
        prog = ref_paths.view_pixels(*args, block=t["check"]["block"], round_state=round_state,
                                     round_frame=bf16) if control else vals.to(run.device)
        errs.append(_pixel_errors(prog, ref))
    e = torch.cat(errs)
    return {"pixels_off": float((e > PIXEL_TOL).double().mean()), "median_err": float(e.median())}


FAULTS = ("unchanged", "half", "altered")


def fault_patches(fault: str) -> list:
    """The ``mock.patch`` objects that plant ``fault`` under the renderer:
    ``unchanged``, a pass that counts its samples and adds none; ``half``,
    half of a branched pass's branches left out, the mean over the rest;
    ``altered``, the radiance altered where it is produced.  Start them
    before the driver is built."""
    from octree_pathtracing_tpu_torch.render import renderer

    branched, trace, trace_branched = renderer.render_pass_branched, renderer.trace_paths, renderer.trace_paths_branched

    def unchanged(*args):
        return args[2], branched(*args)[1]

    def half(scene, origins, dirs, u):
        return trace_branched(scene, origins, dirs, u[:, : max(1, u.shape[1] // 2)])

    return {
        "unchanged": [mock.patch.object(renderer, "render_pass_branched", unchanged)],
        "half": [mock.patch.object(renderer, "trace_paths_branched", half)],
        "altered": [mock.patch.object(renderer, "trace_paths", lambda *a: trace(*a) + 1e-2)],
    }[fault]
