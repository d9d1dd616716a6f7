"""Differentiable rendering: relaxed visibility and inverse rendering."""

from .inverse import InverseResult, inverse_render, make_inverse_loss, render_views
from .soft import record_surfaces, soft_loss, soft_radiance

__all__ = [
    "InverseResult",
    "inverse_render",
    "make_inverse_loss",
    "render_views",
    "record_surfaces",
    "soft_loss",
    "soft_radiance",
]
