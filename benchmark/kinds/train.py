"""Inverse rendering: ``diff.inverse.inverse_render`` over the orbit views,
as ``cli train`` runs it.  The targets are rendered in set-up by
``render_views``; the window is one call, its step count sized from the
warm-up to fill the window, and each step ends in its loss's read-back.

The check follows the window call's first steps, read through the
optimiser's step hooks.  ``loss_gap``: the largest relative gap of a
step's loss; ``grad_gap``: the worst leaf's gap between the norms of the
first gradient (Adam's first moment after one step); ``change_gap``: the
worst leaf's gap between the norms of the parameters' change after the
checked steps.  Each leaf's gap is over the larger of its reference norm
and the median leaf's; a leaf whose reference gradient is under a
thousandth of the median leaf's takes no part in ``change_gap``.
"""

from __future__ import annotations

import math
import statistics
import sys
import time
from unittest import mock

import torch

from ..harness.check import round_state
from ..harness.drivers import Window, orbit_center, orbit_eye, port_camera, port_scene, sync
from ..reference import scenes as ref_scenes


class Driver:
    def __init__(self, config: dict, traffic: dict, dev, seed: int):
        from octree_pathtracing_tpu_torch.diff import inverse_render, render_views

        self.config, self.traffic, self.dev, self.seed = config, traffic, dev, seed
        t = traffic
        orbit = t["orbit"]
        self.eyes = [orbit_eye(orbit, config["depth"], 2 * math.pi * i / t["views"]) for i in range(t["views"])]
        self.center = orbit_center(orbit, config["depth"])
        at = time.perf_counter()
        self.scene = port_scene(config, dev)
        self.cams = [port_camera(e, self.center, dev) for e in self.eyes]
        sync(dev)
        self.setup_phases = {"scene": time.perf_counter() - at}
        at = time.perf_counter()
        self.targets = render_views(self.scene, self.cams, t["width"], t["height"], seed=seed)
        sync(dev)
        self.setup_phases["targets"] = time.perf_counter() - at
        self._inverse = inverse_render
        at = time.perf_counter()
        warm = self._call(t["warmup_steps"])
        sync(dev)
        self.setup_phases["warm-up"] = time.perf_counter() - at
        self.setup_phases.update({f"its step {i + 1}": x for i, x in enumerate(warm.step_seconds)})
        self.step_s = warm.step_seconds[-1]

    def _call(self, steps: int):
        t = self.traffic
        return self._inverse(self.scene, self.cams, self.targets, t["width"], t["height"], steps=steps, lr=t["lr"],
                             seed=self.seed, soft_weight=t["soft_weight"])

    def window(self, seconds: float) -> Window:
        from torch.optim.optimizer import register_optimizer_step_post_hook, register_optimizer_step_pre_hook

        checked = self.traffic["check"]["steps"]
        steps = max(checked + 1, math.ceil(seconds / self.step_s))
        seen = {"steps": 0}

        def pre(opt, args, kwargs):
            if seen["steps"] == 0:
                seen["start"] = [p.detach().clone() for p in opt.param_groups[0]["params"]]
            if seen["steps"] == checked:  # the parameters as the checked steps left them
                seen["after"] = [p.detach().clone() for p in opt.param_groups[0]["params"]]

        def post(opt, args, kwargs):
            seen["steps"] += 1
            if seen["steps"] == 1:  # Adam's first moment after one step: (1 - beta1) * gradient
                beta1 = opt.param_groups[0]["betas"][0]
                seen["grad"] = [opt.state[p]["exp_avg"].detach() / (1.0 - beta1) if "exp_avg" in opt.state[p]
                                else torch.zeros_like(p) for p in opt.param_groups[0]["params"]]

        hooks = [register_optimizer_step_pre_hook(pre), register_optimizer_step_post_hook(post)]
        try:
            t0 = time.perf_counter()
            with torch.profiler.record_function("train.inverse_render"):
                res = self._call(steps)
            sync(self.dev)
            secs = time.perf_counter() - t0
        finally:
            for h in hooks:
                h.remove()
        print("benchmark: step seconds " + " ".join(f"{s:.4f}" for s in res.step_seconds), file=sys.stderr)
        answers = {"losses": res.losses[:checked], "grad": seen["grad"], "start": seen["start"],
                   "after": seen["after"]}
        return Window(seconds=secs, end_to_end={"train_step_ms": 1e3 * secs / steps}, attempted=steps,
                      units={"step": steps}, calls={}, answers=answers)

    def release(self):
        self.scene = self.cams = self.targets = None


def _norms(leaves) -> list:
    return [float(torch.linalg.vector_norm(x.double())) for x in leaves]


def _worst_gap(prog: list, ref: list, keep=None) -> float:
    floor = statistics.median(ref)
    gaps = [abs(p - r) / max(r, floor) for i, (p, r) in enumerate(zip(prog, ref)) if keep is None or keep[i]]
    return max(gaps) if gaps else 0.0


def check(run, answers, control: bool = False) -> dict:
    from ..reference import training as ref_training

    cfg, t = run.config_file, run.traffic
    scene = ref_scenes.build_scene(cfg, run.device)
    cams = [ref_scenes.camera(e, run.driver.center, run.device) for e in run.driver.eyes]
    steps = t["check"]["steps"]
    kw = dict(steps=steps, lr=t["lr"], soft_weight=t["soft_weight"], n_bounces=cfg["bounces"],
              views_per_block=t["check"]["views_per_block"])
    ref = ref_training.train_steps(scene, cams, t["width"], t["height"], run.seed, **kw)
    if control:
        answers = ref_training.train_steps(scene, cams, t["width"], t["height"], run.seed, round_state=round_state,
                                           **kw)
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(answers["losses"], ref["losses"]))
    g_ref = _norms(ref["grad"])
    floor = statistics.median(g_ref)
    keep = [g >= 1e-3 * floor for g in g_ref]

    def change(d):
        return _norms([a.to(run.device) - s.to(run.device) for a, s in zip(d["after"], d["start"])])

    return {
        "loss_gap": loss_gap,
        "grad_gap": _worst_gap(_norms(answers["grad"]), g_ref),
        "change_gap": _worst_gap(change(answers), change(ref), keep),
    }


FAULTS = ("unchanged", "half", "altered")


def fault_patches(fault: str) -> list:
    """The ``mock.patch`` objects that plant ``fault`` under the training
    step: ``unchanged``, an optimiser step that moves nothing; ``half``,
    half of each view's lanes left out of the loss, the mean over the
    rest; ``altered``, the radiance altered where it is produced.  Start
    them before the driver is built."""
    from octree_pathtracing_tpu_torch.diff import inverse

    trace, loss_fn = inverse.trace_paths, inverse.make_inverse_loss

    def half_loss(soft_weight=0.25):
        full = loss_fn(soft_weight)

        def loss(scene, params, o, d, u, targets):
            b = o.shape[1] // 2
            return full(scene, params, o[:, :b], d[:, :b], u[:, :b], targets[:, :b])

        return loss

    return {
        "unchanged": [mock.patch.object(torch.optim.Adam, "step", lambda self, closure=None: None)],
        "half": [mock.patch.object(inverse, "make_inverse_loss", half_loss)],
        "altered": [mock.patch.object(inverse, "trace_paths", lambda *a: trace(*a) * 1.01)],
    }[fault]
