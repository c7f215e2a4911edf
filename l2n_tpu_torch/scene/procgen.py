"""Procedural non-sphere OBJ scene generation (counterpart of
l2n_tpu.scene.procgen; pure numpy text generators, byte-equal output).

Deterministic demo and test scenes: a field of randomly oriented tori in
the same ±worldSize/2 volume the procedural sphere scene uses, and one
high-poly trefoil-knot tube. Tori are curved, non-convex and have a hole,
and each torus has several 128-triangle slabs: the multi-slab case of the
triangle kernel's bound traversal. Emitted as OBJ text, so every use goes
through load_obj.
"""

from __future__ import annotations

import io

import numpy as np


def _rotation(rng: np.random.Generator) -> np.ndarray:
    """Uniform random rotation (QR of a Gaussian, sign-fixed)."""
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 2] *= -1
    return q


def trefoil_obj(seg_u: int = 256, seg_v: int = 137,
                world_size: float = 1024.0) -> str:
    """OBJ text: ONE closed high-poly mesh — a tube swept along a trefoil
    knot — with 2 x seg_u x seg_v triangles (defaults: 70,144).

    The big-mesh asset: ~550 slabs in ONE mesh, whose winding tube spreads
    the slab bounds through the volume (unlike a compact ball).

    Construction: centerline C(t) = (sin t + 2 sin 2t, cos t - 2 cos 2t,
    -sin 3t) sampled at seg_u points; the tube frame is parallel-
    transported along the curve with the closure twist distributed evenly
    (a rotation-minimizing CLOSED frame), and both parameter directions
    wrap by INDEX, so the topology is exactly watertight — no seam
    duplicates."""
    t = 2.0 * np.pi * np.arange(seg_u) / seg_u
    c = np.stack([np.sin(t) + 2.0 * np.sin(2.0 * t),
                  np.cos(t) - 2.0 * np.cos(2.0 * t),
                  -np.sin(3.0 * t)], axis=1)
    # Fit the knot (centerline extent ~3) in the procedural scene volume.
    scale = 0.30 * world_size / 3.0
    c *= scale
    r_tube = 0.055 * world_size

    # Unit tangents (periodic central differences).
    tan = np.roll(c, -1, 0) - np.roll(c, 1, 0)
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    # Parallel transport an initial normal along the closed curve.
    n0 = np.array([tan[0, 1], -tan[0, 0], 0.0])
    if np.linalg.norm(n0) < 1e-9:
        n0 = np.array([1.0, 0.0, 0.0])
    n0 -= tan[0] * (n0 @ tan[0])
    n0 /= np.linalg.norm(n0)
    normals = np.zeros_like(c)
    normals[0] = n0
    for i in range(1, seg_u):
        v = normals[i - 1] - tan[i] * (normals[i - 1] @ tan[i])
        normals[i] = v / np.linalg.norm(v)
    # Distribute the closure twist so frame(seg_u) == frame(0) exactly in
    # formula (the index wrap already guarantees topological closure).
    v = normals[-1] - tan[0] * (normals[-1] @ tan[0])
    v /= np.linalg.norm(v)
    b0 = np.cross(tan[0], normals[0])
    phi = np.arctan2(v @ b0, v @ normals[0])
    binormals = np.cross(tan, normals)
    theta = -phi * np.arange(seg_u) / seg_u
    normals = (np.cos(theta)[:, None] * normals
               + np.sin(theta)[:, None] * binormals)
    binormals = np.cross(tan, normals)

    psi = 2.0 * np.pi * np.arange(seg_v) / seg_v
    cpsi, spsi = np.cos(psi), np.sin(psi)
    ring_n = (cpsi[None, :, None] * normals[:, None, :]
              + spsi[None, :, None] * binormals[:, None, :])  # (u, v, 3)
    pos = c[:, None, :] + r_tube * ring_n

    out = io.StringIO()
    out.write("# trefoil knot tube (deterministic, l2n_tpu.scene.procgen)\n")
    out.write("o trefoil\n")
    for p in pos.reshape(-1, 3):
        out.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
    for n in ring_n.reshape(-1, 3):
        out.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
    for u in range(seg_u):
        for v_ in range(seg_v):
            a = 1 + u * seg_v + v_
            b = 1 + ((u + 1) % seg_u) * seg_v + v_
            cc = 1 + ((u + 1) % seg_u) * seg_v + (v_ + 1) % seg_v
            d = 1 + u * seg_v + (v_ + 1) % seg_v
            out.write(f"f {a}//{a} {b}//{b} {cc}//{cc}\n")
            out.write(f"f {a}//{a} {cc}//{cc} {d}//{d}\n")
    return out.getvalue()


def torus_field_obj(n_tori: int = 24, seg_u: int = 24, seg_v: int = 16,
                    world_size: float = 1024.0, seed: int = 5) -> str:
    """OBJ text: `n_tori` randomly placed/oriented tori.

    Each torus is its own `o` group -> its own mesh, so the emissive-every-
    16th material rule lights the scene the same way the sphere scenes
    are lit. seg_u x seg_v quads -> 2 x
    seg_u x seg_v triangles per torus (default 768).
    """
    rng = np.random.default_rng(seed)
    out = io.StringIO()
    out.write("# torus field (deterministic, l2n_tpu.scene.procgen)\n")
    base = 1  # OBJ indices are 1-based and file-global

    iu = np.arange(seg_u, dtype=np.float64)
    iv = np.arange(seg_v, dtype=np.float64)
    phi = (2.0 * np.pi / seg_u) * iu          # around the main axis
    psi = (2.0 * np.pi / seg_v) * iv          # around the tube
    cphi, sphi = np.cos(phi), np.sin(phi)
    cpsi, spsi = np.cos(psi), np.sin(psi)

    for m in range(n_tori):
        half = 0.5 * world_size
        center = rng.uniform(-half, half, size=3)
        major = rng.uniform(0.02, 0.05) * world_size
        minor = major * rng.uniform(0.25, 0.45)
        rot = _rotation(rng)

        # Ring frame: ring point R*(cphi, sphi, 0); tube offset
        # r*(cpsi*cphi, cpsi*sphi, spsi); normal (cpsi*cphi, cpsi*sphi, spsi).
        ring = np.stack([cphi[:, None] * (major + minor * cpsi[None, :]),
                         sphi[:, None] * (major + minor * cpsi[None, :]),
                         np.broadcast_to(minor * spsi[None, :],
                                         (seg_u, seg_v))], axis=-1)
        nrm = np.stack([cphi[:, None] * cpsi[None, :],
                        sphi[:, None] * cpsi[None, :],
                        np.broadcast_to(spsi[None, :], (seg_u, seg_v))],
                       axis=-1)
        pos = ring.reshape(-1, 3) @ rot.T + center
        nrm = nrm.reshape(-1, 3) @ rot.T

        out.write(f"o torus{m}\n")
        for p in pos:
            out.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        for n in nrm:
            out.write(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}\n")
        for u in range(seg_u):
            for v in range(seg_v):
                a = base + u * seg_v + v
                b = base + ((u + 1) % seg_u) * seg_v + v
                c = base + ((u + 1) % seg_u) * seg_v + (v + 1) % seg_v
                d = base + u * seg_v + (v + 1) % seg_v
                out.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
                out.write(f"f {a}//{a} {c}//{c} {d}//{d}\n")
        base += seg_u * seg_v
    return out.getvalue()
