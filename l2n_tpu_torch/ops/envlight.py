"""Environment light: the Mandelbrot escape-time sky and the sun lobe
(counterpart of l2n_tpu.ops.envlight for env_mode "mandelbrot", "sun" and
"none").

Direction -> plane: theta = atan2(|d.xy|, d.z), phi = atan2(d.y, d.x),
u = phi/pi, v = -1 + 2*theta/pi, p = (8u, 4v); iterate z <- z^2 + p and
return i/64 at the first |z|^2 > 4, 0 if z stays bounded for 64 steps.

Exact direction-space cull (as in the JAX package): |p| <= 2 requires
d.x >= |d.y| and d.z^2 <= d.x^2 + d.y^2; outside that box z1 = p already
escapes, so the radiance is exactly 0 there. The CUDA kernel uses the same
test as an early exit and runs the escape loop only inside it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from l2n_tpu_torch.maths.fastmath import atan2
from l2n_tpu_torch.maths.sampling import PI, sqrt

MANDELBROT_ITERS = 64
# The sun's direction normalize(1, 1, -1): each component float32(1/sqrt 3).
SUN_S = float(np.float32(1.0 / math.sqrt(3.0)))


def mandelbrot_le(dx, dy, dz):
    """Greyscale radiance of the Mandelbrot sky for direction d."""
    in_box = (dx >= torch.abs(dy)) & (dz * dz <= dx * dx + dy * dy)
    sin_theta = sqrt(dx * dx + dy * dy)
    theta = atan2(sin_theta, dz)
    phi = atan2(dy, dx)
    u = phi * (1.0 / PI)
    v = -1.0 + (2.0 / PI) * theta
    px = 8.0 * u
    py = 4.0 * v
    zx = torch.zeros_like(px)
    zy = torch.zeros_like(px)
    zx2 = torch.zeros_like(px)
    zy2 = torch.zeros_like(px)
    still = torch.ones_like(px)
    cnt = torch.zeros_like(px)
    # Branch-free count: `still` latches at 0 on the first escape, so `cnt`
    # is the index of the escaping iteration (the reference's `break`).
    for _ in range(MANDELBROT_ITERS):
        zy = 2.0 * zx * zy + py
        zx = zx2 - zy2 + px
        zx2 = zx * zx
        zy2 = zy * zy
        still = still * (zx2 + zy2 <= 4.0).to(px.dtype)
        cnt = cnt + still
    le = torch.where(cnt < MANDELBROT_ITERS, cnt * (1.0 / MANDELBROT_ITERS),
                     torch.zeros_like(cnt))
    return torch.where(in_box, le, torch.zeros_like(le))


def sun_le(dx, dy, dz):
    """Radiance of the sun lobe, pow(max(0, dot(sun, d)), 128) with sun =
    normalize(1, 1, -1), the power as 7 squarings."""
    d = torch.clamp(SUN_S * dx + SUN_S * dy - SUN_S * dz, min=0.0)
    for _ in range(7):
        d = d * d
    return d


def env_radiance(mode: str, dx, dy, dz):
    """Dispatch on RenderConfig.env_mode."""
    if mode == "mandelbrot":
        return mandelbrot_le(dx, dy, dz)
    if mode == "sun":
        return sun_le(dx, dy, dz)
    if mode == "none":
        return torch.zeros_like(dx)
    raise ValueError(f"unknown env_mode {mode!r}")
