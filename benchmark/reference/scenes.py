"""A configuration's scene and cameras, built by the reference itself.

The scene comes from the builder that the configuration's
``builder["reference"]`` names under this package (a frozen terrain
generator and octree builder in ``plain/``), with ``builder["kwargs"]``:
the grid is generated and the octree built here, never taken from the
port.  The node table is cached under ``benchmark/cache/`` (the
reference's own files, a fixed directory of the checkout), so only a
checkout's first check builds it.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import os

from .plain.models.camera import Camera
from .plain.models.emitters import with_emitter_sampling
from .plain.models.sun import SunSampling

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cache", "reference")
SUN_STRATEGIES = {"off": SunSampling.off, "non_luminous": SunSampling.non_luminous, "fast": SunSampling.fast,
                  "importance": SunSampling.importance, "high_quality": SunSampling.high_quality}


def builder(dotted: str):
    """The reference's scene builder ``dotted`` (``module.path.name``
    under this package)."""
    module, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(f".{module}", __package__), name)


def build_scene(config: dict, device, cache_dir: str | None = CACHE_DIR):
    """The configuration's scene on ``device``: its builder's (scene,
    camera) from its keyword arguments (and ``cache_dir``, where the
    builder takes one); ``sun`` and ``emitter_sampling`` name the lighting
    strategies."""
    b = config["builder"]
    fn = builder(b["reference"])
    kwargs = dict(b["kwargs"], cache_dir=cache_dir) if "cache_dir" in inspect.signature(fn).parameters else b["kwargs"]
    scene, _ = fn(**kwargs)
    scene = dataclasses.replace(scene, sun_sampling=SUN_STRATEGIES[config["sun"]]())
    scene = with_emitter_sampling(scene, config["emitter_sampling"])
    return scene.to(device)


def camera(eye, center, device) -> Camera:
    """A look-at camera from the harness's numbers (the same the port is
    given)."""
    return Camera.look_at(eye=tuple(eye), center=tuple(center)).to(device)
