"""The camera block, regenerated from a view matrix and a configuration
(frozen copy; PROVENANCE.md).

Rows of the packed (10, 4) float32 block: 0-3 the inverse view matrix,
4-7 the inverse view-projection matrix, 8 the camera position, 9
(aspect ratio, tan(fovy / 2), 0, 0). Inverses are taken in float64 and
rounded to float32.
"""

from __future__ import annotations

import numpy as np

# The reference's default pose: the rows of its view matrix
# (src/main.cpp:805-809).
DEFAULT_VIEW = np.array([[0.996, 0.015, 0.084, 12.503],
                         [0.005, 0.974, -0.228, 1.748],
                         [-0.085, 0.227, 0.970, -325.982],
                         [0.0, 0.0, 0.0, 1.0]], dtype=np.float32)


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def perspective(fovy_rad: float, aspect: float, near: float, far: float):
    t = np.tan(0.5 * fovy_rad)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2.0 * far * near / (far - near)
    m[3, 2] = -1.0
    return m


def packed_camera(cfg: dict, view: np.ndarray) -> np.ndarray:
    """The (10, 4) float32 block of `view` (world -> view, (4, 4))."""
    view = np.asarray(view, np.float32)
    aspect = cfg["width"] / cfg["height"]
    rcp_view = inverse(view)
    proj = perspective(np.radians(cfg["fovy_deg"]), aspect, cfg["near"],
                       cfg["far"])
    out = np.zeros((10, 4), np.float32)
    out[0:4] = rcp_view
    out[4:8] = inverse(proj @ view)
    out[8, :3] = rcp_view[:3, 3]
    out[9, 0] = aspect
    out[9, 1] = float(np.tan(0.5 * np.radians(cfg["fovy_deg"])))
    return out
