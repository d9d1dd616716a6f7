from .pathtracer import (
    MAX_BOUNCES,
    draw_uniforms,
    trace_paths,
    trace_paths_branched,
    trace_paths_census,
)
from .preview import preview_image, preview_render_rays
from .renderer import Renderer, branch_schedule, render_pass, render_pass_branched

__all__ = [
    "MAX_BOUNCES",
    "draw_uniforms",
    "trace_paths",
    "trace_paths_branched",
    "trace_paths_census",
    "preview_image",
    "preview_render_rays",
    "Renderer",
    "branch_schedule",
    "render_pass",
    "render_pass_branched",
]
