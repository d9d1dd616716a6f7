"""Display-path sanity images (port of ``render/testimages.py``): a
Mandelbrot orbit trap and a Kleinian sphere-inversion fractal, in plain
torch over the pixel grid.  Unrelated to the octree renderer, they exercise
the framebuffer, gamma and image path with procedural content."""

from __future__ import annotations

import torch


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """float32 ``jnp.linspace(start, stop, num)`` rounded as the JAX
    package's compiled linspace rounds it: with ``r = 1 / (num - 1)`` and
    ``i`` the index, ``i * (stop * r) + start * (1 - i * r)`` in one fused
    multiply-add (the product exact in float64, one rounding of the sum),
    the end point exact.  The Mandelbrot iteration is chaotic near the set's
    edge, so a grid one ulp off moves pixels there."""
    if num == 1:
        return torch.tensor([start], dtype=torch.float32)
    div = num - 1
    i = torch.arange(div, dtype=torch.float32)
    r = torch.tensor(1.0, dtype=torch.float32) / div
    lo, hi = torch.tensor(start, dtype=torch.float32), torch.tensor(stop, dtype=torch.float32)
    head = (i.double() * (hi * r).double() + (lo * (1 - i * r)).double()).float()
    return torch.cat([head, hi[None]])


def mandelbrot_image(width: int, height: int, max_iter: int = 96):
    """Smooth-coloured orbit-trap Mandelbrot, (height, width, 3) float32."""
    cr, ci = torch.meshgrid(_linspace(-2.2, 0.8, width), _linspace(-1.3, 1.3, height), indexing="xy")
    zr = torch.zeros_like(cr)
    zi = torch.zeros_like(ci)
    trap = torch.full(cr.shape, 1e9)
    esc = torch.zeros(cr.shape)
    for i in range(max_iter):
        live = esc == 0
        nzr = zr * zr - zi * zi + cr
        nzi = 2 * zr * zi + ci
        zr = torch.where(live, nzr, zr)
        zi = torch.where(live, nzi, zi)
        r2 = zr * zr + zi * zi
        # orbit trap: distance to the unit circle
        trap = torch.where(live, torch.minimum(trap, torch.abs(torch.sqrt(r2) - 1.0)), trap)
        esc = torch.where(live & (r2 > 4.0), torch.tensor(i + 1.0), esc)
    t = torch.where(esc == 0, 0.0, esc / max_iter)
    g = torch.exp(-3.0 * trap)
    rgb = torch.stack(
        [
            0.5 + 0.5 * torch.cos(6.2831 * (t + 0.0)) * (1 - g) + g * 0.9,
            0.5 + 0.5 * torch.cos(6.2831 * (t + 0.33)) * (1 - g) + g * 0.6,
            0.5 + 0.5 * torch.cos(6.2831 * (t + 0.67)) * (1 - g) + g * 0.9,
        ],
        dim=-1,
    )
    return torch.where((esc == 0)[..., None], torch.tensor([0.05, 0.02, 0.08]), rgb)


def kleinian_image(width: int, height: int, iters: int = 12):
    """Kleinian-style sphere-inversion fractal in a purple palette,
    (height, width, 3) float32."""
    px, py = torch.meshgrid(_linspace(-1.6, 1.6, width), _linspace(-1.2, 1.2, height), indexing="xy")
    p = torch.stack([px, py, torch.full(px.shape, 0.35)], -1)
    scale = torch.ones(px.shape)
    for _ in range(iters):
        p = torch.clamp(p, -1.0, 1.0) * 2.0 - p  # box fold
        r2 = torch.sum(p * p, dim=-1, keepdim=True)  # sphere inversion
        k = torch.clamp(1.1 / torch.clamp_min(r2, 1e-6), 1.0, 4.0)
        p = p * k
        scale = scale * k[..., 0]
    d = torch.sqrt(torch.sum(p * p, -1)) / torch.clamp_min(scale, 1e-6)
    # log-normalized distance field -> purple palette
    ld = torch.log10(torch.clamp_min(d, 1e-12))
    v = torch.clamp((ld.max() - ld) / (ld.max() - ld.min() + 1e-6), 0.0, 1.0)
    v = v**3
    return torch.stack([0.45 * v + 0.1 * v * v, 0.12 * v, 0.55 * v + 0.2 * v * v], -1)
