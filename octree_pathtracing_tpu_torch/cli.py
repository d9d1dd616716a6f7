"""Command line: render, train and info.

Usage:
  python -m octree_pathtracing_tpu_torch.cli render --scene chunk --depth 9 \\
      --width 256 --height 256 --spp 20 -o build/chunk.ppm
  python -m octree_pathtracing_tpu_torch.cli render --scene cutout --depth 9 \\
      --sun high_quality --emitter-sampling one -o build/cutout.ppm
  python -m octree_pathtracing_tpu_torch.cli train --scene chunk --depth 9 \\
      --views 8 --steps 3 -o build/params.npz
  python -m octree_pathtracing_tpu_torch.cli info --scene chunk --depth 9

Frames go to image files (PPM where PIL is missing), trained parameters to
an ``.npz``; one JSON metrics line per render pass or training step goes to
stderr.  ``--device`` defaults to the first CUDA card; without a card the
command fails unless ``--device cpu`` asks for the CPU, where every kernel's
plain-torch twin runs.  Every line says which device ran.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from . import BUILD_DIR

SCENES = ("sphere", "cornell", "room", "chunk", "cutout", "scattered")
EMITTER_SAMPLING = ("scene", "none", "one", "one_block", "all")
SCENE_CACHE = os.path.join(BUILD_DIR, "scenes")


def _build_scene(args):
    from .models import (
        cornell_scene,
        cutout_chunk_scene,
        emissive_room_scene,
        minecraft_chunk_scene,
        scattered_lights_scene,
        sphere_scene,
    )

    if args.world:
        raise NotImplementedError("--world (region ingestion): ROADMAP queue 1, item 8")
    depth = args.depth if args.depth else 6
    if args.scene == "chunk":
        return minecraft_chunk_scene(depth=depth, cache_dir=SCENE_CACHE)
    if args.scene == "cutout":
        return cutout_chunk_scene(depth=depth, cache_dir=SCENE_CACHE)
    builders = {"sphere": sphere_scene, "cornell": cornell_scene, "room": emissive_room_scene,
                "scattered": scattered_lights_scene}
    return builders[args.scene](depth=depth)


def _device(name: str):
    """The device ``--device`` names, the first CUDA card by default.  A CUDA
    device without a card is an error: the command never moves to the CPU
    unless it is asked to."""
    import torch

    dev = torch.device(name or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: the port's kernels run only on the card; pass --device cpu to run "
            "their plain-torch twins on the CPU"
        )
    return dev


def cmd_render(args):
    """Render ``--spp`` samples per pixel progressively and write the frame.
    Returns the ``Renderer``."""
    import torch

    from .config import sun_sampling_from_name
    from .io.image import save_image
    from .models.emitters import with_emitter_sampling
    from .render.renderer import Renderer
    from .utils.metrics import METRICS

    dev = _device(args.device)
    with METRICS.phase("scene_build", scene=args.scene, depth=args.depth):
        scene, camera = _build_scene(args)
    scene = dataclasses.replace(scene, sun_sampling=sun_sampling_from_name(args.sun))
    scene = with_emitter_sampling(scene, args.emitter_sampling)
    r = Renderer(
        scene=scene.to(dev),
        camera=camera.to(dev),
        width=args.width,
        height=args.height,
        target_spp=args.spp,
        branch_count=args.branch_count,
        seed=args.seed,
        n_bounces=args.bounces,
    )
    dev_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    while True:
        t0 = time.perf_counter()
        spp_before = r.spp
        if not r.step():
            break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        METRICS.render_pass(
            spp_added=r.spp - spp_before,
            total_spp=r.spp,
            lanes=args.width * args.height,
            wall_s=time.perf_counter() - t0,
            device=dev_name,
        )
    path = save_image(args.output, r.framebuffer)
    print(f"wrote {path} at {r.spp} spp on {dev_name}")
    return r


def orbit_cameras(depth: int, n_views: int):
    """``n_views`` cameras on a circle around the scene, looking at a point
    above its centre (the JAX CLI's training views)."""
    import numpy as np

    from .models import Camera

    s = 1 << depth
    cams = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        eye = (s * (0.5 + 0.9 * np.cos(ang)), s * 0.75, s * (0.5 + 0.9 * np.sin(ang)))
        cams.append(Camera.look_at(eye=eye, center=(s * 0.5, s * 0.3, s * 0.5)))
    return cams


def cmd_train(args):
    """Render targets from ``--views`` orbit cameras, then fit (atlas,
    emittance) from a grey start with ``inverse_render`` (soft weight 0.25)
    for ``--steps`` Adam steps.  Returns the ``InverseResult``."""
    import torch

    from .diff import inverse_render, render_views
    from .io.checkpoint import save_arrays
    from .utils.metrics import METRICS

    dev = _device(args.device)
    dev_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    with METRICS.phase("scene_build", scene=args.scene, depth=args.depth):
        scene, _ = _build_scene(args)
    scene = scene.to(dev)
    cams = [c.to(dev) for c in orbit_cameras(scene.depth, args.views)]
    targets = render_views(scene, cams, args.width, args.height, seed=args.seed)
    res = inverse_render(scene, cams, targets, args.width, args.height, steps=args.steps,
                         lr=args.lr, seed=args.seed)
    for i, (loss, wall_s) in enumerate(zip(res.losses, res.step_seconds)):
        METRICS.emit("train_step", step=i, loss=loss, wall_s=round(wall_s, 4),
                     lanes=args.views * args.width * args.height, device=dev_name)
    save_arrays(args.output, res.params)
    print(f"loss {res.losses[0]:.5f} -> {res.losses[-1]:.5f} over {args.steps} steps "
          f"on {dev_name}; wrote {args.output}")
    return res


def cmd_info(args):
    scene, _ = _build_scene(args)
    print(f"octree: depth={scene.depth} nodes={scene.n_nodes} scale={scene.octree_scale}")
    print(f"materials: {scene.materials.count}; atlas: {tuple(scene.atlas.shape)}")
    print(f"opaque_only={scene.opaque_only} shadow_binary={scene.shadow_binary}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="octree_pathtracing_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", default="cornell", choices=SCENES)
        sp.add_argument("--world", default="", help="Minecraft region file (not ported yet)")
        sp.add_argument("--depth", type=int, default=0, help="octree depth (default 6)")
        sp.add_argument("--width", type=int, default=512)
        sp.add_argument("--height", type=int, default=512)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("-o", "--output", default="out.png")

    r = sub.add_parser("render")
    common(r)
    r.add_argument("--spp", type=int, default=64)
    r.add_argument("--branch-count", type=int, default=10)
    r.add_argument("--bounces", type=int, default=5, help="path depth cap")
    r.add_argument("--sun", default="importance",
                   choices=["off", "non_luminous", "fast", "importance", "high_quality"])
    r.add_argument("--emitter-sampling", default="scene", choices=EMITTER_SAMPLING,
                   help="block-light NEE: 'one' samples one face of one emissive leaf per diffuse "
                        "bounce, 'one_block' all faces of one leaf, 'all' all faces of every leaf "
                        "(models/emitters.py); 'none' turns it off; 'scene' keeps the scene's own")
    r.add_argument("--device", default="", help="torch device (default: cuda; cpu runs the kernels' twins)")
    r.set_defaults(fn=cmd_render)

    t = sub.add_parser("train")
    common(t)
    t.add_argument("--steps", type=int, default=50)
    t.add_argument("--views", type=int, default=8)
    t.add_argument("--lr", type=float, default=5e-2)
    t.add_argument("--device", default="", help="torch device (default: cuda; cpu runs the kernels' twins)")
    t.set_defaults(fn=cmd_train)

    i = sub.add_parser("info")
    common(i)
    i.set_defaults(fn=cmd_info)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
