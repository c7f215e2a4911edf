"""The minimax arctangent of l2n_tpu.maths.fastmath, in torch.

The Mandelbrot sky maps directions to its plane through atan2; its escape
counts are quantized to 1/64, so a different arctangent (torch.atan2,
atan2f) flips counts at band edges. The JAX package, its native twin and
this port all use this one polynomial (~1e-5 rad absolute error); the CUDA
kernel's copy is `poly_atan2` in csrc/sphere_pt.cuh.
"""

from __future__ import annotations

import torch

_HALF_PI = 1.5707963267948966
_PI = 3.141592653589793

# Odd minimax polynomial for atan(t), t in [-1, 1] (f32, ~1e-5 max error).
_C = (0.99997726, -0.33262347, 0.19354346, -0.11643287, 0.05265332,
      -0.01172120)


def _atan_poly(t: torch.Tensor) -> torch.Tensor:
    s = t * t
    p = torch.full_like(t, _C[5])
    for c in _C[4::-1]:
        p = p * s + c
    return t * p


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Four-quadrant arctangent, elementwise on float32 tensors (np.arctan2
    conventions to ~1e-5 rad)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    t = lo / torch.clamp(hi, min=1e-37)
    a = _atan_poly(t)
    a = torch.where(ay > ax, _HALF_PI - a, a)
    a = torch.where(x < 0.0, _PI - a, a)
    return torch.where(y < 0.0, -a, a)
