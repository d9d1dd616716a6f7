"""What every traffic kind's driver shares (``kinds/<kind>.py``): the
window's record, the orbit cameras, the configuration's scene built by the
port, the pixels drawn from the seed.

The seed drives the Philox streams alone: the scene, the cameras and the
shapes are the same for every seed.  A driver's constructor builds and
warms up everything the window uses; ``window`` measures; its ``answers``
are what the kind's check compares.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import math

import numpy as np
import torch


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def orbit_eye(orbit: dict, depth: int, angle: float) -> tuple:
    """The eye on the orbit at ``angle`` radians: ``cli.orbit_cameras``'
    circle (radius ``orbit["radius"]`` of the scene's side around its
    centre, at height ``orbit["height"]``)."""
    s = 1 << depth
    return (s * (0.5 + orbit["radius"] * math.cos(angle)), s * orbit["height"],
            s * (0.5 + orbit["radius"] * math.sin(angle)))


def orbit_center(orbit: dict, depth: int) -> tuple:
    s = 1 << depth
    return tuple(s * c for c in orbit["center"])


@dataclasses.dataclass
class Window:
    seconds: float  # the window's length, host clock
    end_to_end: dict  # {metric: value}
    attempted: int  # work items started in the window
    units: dict  # {"view" | "step" | "frame": work done, for per-layer metrics}
    calls: dict  # {kernel family: [size of each call]}
    answers: object  # what the check compares


def build(fn, kwargs: dict, cache_dir: str):
    """The scene of a scene builder's (scene, camera): ``fn(**kwargs)``,
    with ``cache_dir`` where the builder takes one."""
    if "cache_dir" in inspect.signature(fn).parameters:
        kwargs = dict(kwargs, cache_dir=cache_dir)
    return fn(**kwargs)[0]


def resolve(package: str, dotted: str):
    """The object ``dotted`` (``module.path.name``) under ``package``."""
    module, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(f"{package}.{module}" if module else package), name)


def port_scene(config: dict, dev):
    """The configuration's scene built by the port, on ``dev``:
    ``config["builder"]["port"]`` names the builder under the port's
    package, called with ``config["builder"]["kwargs"]`` (and the port's
    scene cache, where it takes one); ``sun`` and ``emitter_sampling``
    name the lighting strategies."""
    from octree_pathtracing_tpu_torch.cli import SCENE_CACHE
    from octree_pathtracing_tpu_torch.config import sun_sampling_from_name
    from octree_pathtracing_tpu_torch.models.emitters import with_emitter_sampling

    b = config["builder"]
    scene = build(resolve("octree_pathtracing_tpu_torch", b["port"]), b["kwargs"], SCENE_CACHE)
    scene = dataclasses.replace(scene, sun_sampling=sun_sampling_from_name(config["sun"]))
    scene = with_emitter_sampling(scene, config["emitter_sampling"])
    return scene.to(dev)


def port_camera(eye, center, dev):
    from octree_pathtracing_tpu_torch.models import Camera

    return Camera.look_at(eye=eye, center=center).to(dev)


def sample_pixels(seed: int, n_pixels: int, count: int) -> np.ndarray:
    """``count`` distinct pixel indices drawn from the seed, sorted."""
    rng = np.random.default_rng([seed, 1])
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels), replace=False))
