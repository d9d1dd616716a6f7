"""Render and array checkpoints (port of ``io/checkpoint.py``), each one
``.npz`` whose keys are dotted paths.

A render checkpoint holds a ``render.Renderer``'s progressive state: the
framebuffer, ``current_spp``, the seed and the Philox draw ``counter``
(which takes the place of the JAX renderer's pass index), ``meta_json``
(the resolution and target spp, for inspection) and any ``extra.*``
payload.  Loading it into a Renderer of the same resolution and continuing
gives the frame an uninterrupted render gives, bit for bit.  Array
checkpoints hold a nested dict of tensors or arrays (e.g. trained
parameters).
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _flatten(prefix: str, tree, out: dict):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}.{i}", v, out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)


def _unflatten(flat: dict) -> dict:
    root: dict = {}
    for key, v in flat.items():
        parts = key.split(".")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def save_render_checkpoint(path: str, renderer, extra: dict | None = None):
    """Write ``renderer``'s progressive state (and ``extra``) to ``path``."""
    payload = {
        "framebuffer": renderer.framebuffer.detach().cpu().numpy(),
        "current_spp": np.asarray(renderer.current_spp),
        "counter": np.asarray(renderer.counter),
        "seed": np.asarray(renderer.seed),
    }
    if extra:
        _flatten("extra", extra, payload)
    meta = dict(width=renderer.width, height=renderer.height, target_spp=renderer.target_spp)
    payload["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **payload)


def load_render_checkpoint(path: str, renderer) -> dict:
    """Restore a checkpoint into ``renderer`` (its framebuffer onto the
    renderer's device); returns the extra payload.  The renderer's own
    ``target_spp`` stays: it is configuration, not progressive state, so
    resuming a 4-spp checkpoint with a target of 8 renders 4 more."""
    with np.load(path, allow_pickle=False) as z:
        fb = z["framebuffer"]
        if fb.shape[:2] != (renderer.height, renderer.width):
            raise ValueError(f"checkpoint resolution {fb.shape[1]}x{fb.shape[0]} is not the renderer's "
                             f"{renderer.width}x{renderer.height}")
        renderer.framebuffer = torch.from_numpy(fb).to(renderer.framebuffer.device)
        renderer.current_spp = int(z["current_spp"])
        renderer.counter = int(z["counter"])
        renderer.seed = int(z["seed"])
        extra_flat = {k[len("extra."):]: z[k] for k in z.files if k.startswith("extra.")}
    return _unflatten(extra_flat)


def save_arrays(path: str, tree: dict):
    """Save a nested dict of tensors / arrays (e.g. inverse-rendering
    params) to ``path`` (numpy appends ``.npz`` when it is missing)."""
    flat: dict = {}
    _flatten("", tree, flat)
    np.savez_compressed(path, **flat)


def load_arrays(path: str) -> dict:
    """The nested dict of numpy arrays :func:`save_arrays` wrote."""
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})
