"""Sampling and frame math in structure-of-arrays form (torch).

Counterpart of l2n_tpu.maths.sampling for the slice: every function takes
and returns components (tensors of one shape) and performs the JAX
package's float32 operations in the same order, so the plain path agrees
with the XLA oracle up to the last-ulp differences of sin/cos.
Python float constants are cast to float32 by torch before the operation,
which is the JAX package's `jnp.float32(c)`.
"""

from __future__ import annotations

import torch

PI = 3.14159265358979323846

Vec3 = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (NaN for x < 0). torch's vectorized
    CPU sqrt is not correctly rounded (it differs on ~1% of float32 inputs)
    while XLA's and the CUDA kernel's sqrtf are; a float64 sqrt rounded to
    float32 is exact, so the plain path uses this everywhere."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x) in the fast-math form (cfg.fast_math): torch.rsqrt on a
    CUDA tensor, which is the card's rsqrtf that the kernels call; on the
    CPU the correctly rounded 1/sqrt(x), which is what the headers' host
    build takes for rsqrtf (csrc/pathtrace.cuh rsqrt_fast): the CPU twin's
    fast path, not the card's. Both are within an ulp or two of 1/sqrt;
    x = 0 gives inf, x < 0 NaN."""
    if x.device.type == "cuda":
        return torch.rsqrt(x)
    return 1.0 / sqrt(x)


def fast_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x) as x * rsqrt(x), the fast-math form: NaN at x = 0 (0 * inf)
    where sqrt gives 0, and for x < 0 (the nearest-sphere sweeps rely on
    both poisoning their candidate)."""
    return x * rsqrt(x)


def _rcp_len(nn: torch.Tensor, fast: bool) -> torch.Tensor:
    return rsqrt(nn) if fast else 1.0 / sqrt(nn)


def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def cross3(ax, ay, az, bx, by, bz) -> Vec3:
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def normalize3(x, y, z, fast: bool = False) -> Vec3:
    rcp = _rcp_len(x * x + y * y + z * z, fast)
    return (x * rcp, y * rcp, z * rcp)


def luminance(r, g, b):
    """Rec.709 luminance."""
    return 0.212671 * r + 0.715160 * g + 0.072169 * b


def frame_z(zx, zy, zz, fast: bool = False) -> tuple[Vec3, Vec3]:
    """Tangent frame around a normalized z axis: the tangent is built from
    the smaller of |z.x|, |z.y| (a lane-wise select); returns (tangent,
    bitangent = cross(z, tangent)). `fast` takes rsqrt for the tangent's
    length."""
    use_y = torch.abs(zy) > torch.abs(zx)
    zero = torch.zeros_like(zx)
    # Branch A (|z.y| > |z.x|): t = (z.y, -z.x, 0) / len(z.xy)
    rcp_a = _rcp_len(zx * zx + zy * zy, fast)
    ax, ay, az = zy * rcp_a, -zx * rcp_a, zero
    # Branch B: t = (z.z, 0, -z.x) / len(z.xz)
    rcp_b = _rcp_len(zx * zx + zz * zz, fast)
    bx, by, bz = zz * rcp_b, zero, -zx * rcp_b
    tx = torch.where(use_y, ax, bx)
    ty = torch.where(use_y, ay, by)
    tz = torch.where(use_y, az, bz)
    return (tx, ty, tz), cross3(zx, zy, zz, tx, ty, tz)


def local_to_world(localx, localy, localz, tangent: Vec3, bitangent: Vec3,
                   zaxis: Vec3) -> Vec3:
    """world = T*l.x + B*l.y + Z*l.z."""
    tx, ty, tz = tangent
    bx, by, bz = bitangent
    zx, zy, zz = zaxis
    return (tx * localx + bx * localy + zx * localz,
            ty * localx + by * localy + zy * localz,
            tz * localx + bz * localy + zz * localz)


def cosine_sample_hemisphere(u1, u2) -> tuple[Vec3, torch.Tensor]:
    """Cosine-weighted hemisphere sample; returns ((x, y, z), jacobian) with
    jacobian = pi / cosTheta (0 where cosTheta == 0)."""
    r = sqrt(u1)
    phi = (2.0 * PI) * u2
    cos_theta = sqrt(torch.clamp(1.0 - u1, min=0.0))
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    jac = torch.where(cos_theta > 0.0, torch.full_like(cos_theta, PI) / cos_theta,
                      torch.zeros_like(cos_theta))
    return (x, y, cos_theta), jac


def procedural_color(n: torch.Tensor) -> Vec3:
    """Per-object pseudo-random albedo fract(sin((n+1)*k)*43758.5453) for an
    integer tensor `n`.

    The hash magnifies one-ulp differences of sin (torch's and XLA's CPU
    sin disagree on a few percent of indices, by up to 4e-3 below 128), so
    the renderer evaluates it ONCE per scene on the host into a table
    (scene.spheres.SphereScene.albedo) that the kernel and the plain path
    both read.
    """
    f = (n + 1).to(torch.float32)

    def chan(k):
        v = torch.sin(f * k) * 43758.5453
        return v - torch.floor(v)

    return chan(12.9898), chan(78.233), chan(56.128)
