"""Array checkpoints (port of ``save_arrays`` / ``load_arrays`` of
``io/checkpoint.py``): a nested dict of tensors or arrays as one ``.npz``
whose keys are the dotted paths.  The render checkpoints are not ported
yet (ROADMAP queue 1, item 8)."""

from __future__ import annotations

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
