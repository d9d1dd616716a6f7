"""The general readers of per-layer metrics, each bound to the parameters
of a ``metrics/<name>.json``.

A reader takes the traced run's context: ``timeline`` (``trace.Timeline``),
``units`` ({"view" | "step": how many the traced window completed}) and
``calls`` ({kernel family: [size of each call]}, counted by the harness
from the shapes it drove).  It returns the metric's value, or None where
the run has nothing to read: the harness then leaves the metric out.
"""

from __future__ import annotations

from ..rooflines.bounds import BOUNDS
from . import spec


def _pattern(names) -> str:
    return "|".join(rf"\b{n}\b" for n in names)


def layer_pattern(layer: str) -> str:
    return _pattern(spec.kernel_layers()[layer])


def port_pattern() -> str:
    return _pattern([k for ks in spec.kernel_layers().values() for k in ks])


def idle_share(ctx, params):
    """Percent of the traced window with no device operation running."""
    return 100.0 * ctx.timeline.idle_share()


def kernel_ms(ctx, params):
    """Device ms of the layer's kernels per unit of work (``per``)."""
    n = ctx.units.get(params["per"], 0)
    secs = ctx.timeline.device_seconds(layer_pattern(params["layer"]))
    if n <= 0 or secs <= 0.0:
        return None
    return 1e3 * secs / n


def other_kernel_ms(ctx, params):
    """Device ms per unit of every device operation that is none of the
    port's kernels (PyTorch's own kernels, copies and fills)."""
    n = ctx.units.get(params["per"], 0)
    secs = ctx.timeline.device_seconds(None, exclude=port_pattern())
    if n <= 0 or secs <= 0.0:
        return None
    return 1e3 * secs / n


def roofline(ctx, params):
    """Percent of the device time of ``params["kernels"]`` that their
    calls' bound takes: ``sum(bound(call)) / device time``, the bound from
    each call's size (``rooflines/bounds.py``, the function
    ``params["bound"]`` names)."""
    sizes = ctx.calls.get(params["bound"], [])
    secs = ctx.timeline.device_seconds(_pattern(params["kernels"]))
    if not sizes or secs <= 0.0:
        return None
    fn = BOUNDS[params["bound"]]
    return 100.0 * sum(fn(n)[0] for n in sizes) / secs

