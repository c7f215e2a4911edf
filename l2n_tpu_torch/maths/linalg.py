"""Host-side matrix/vector math (numpy, float32).

Replaces the reference's use of `c2ba::float4x4` + glm-style `lookAt` /
`perspective` / `rotate` / `inverse` (c2ba-maths submodule; call sites at
src/main.cpp:805-828,915-918 and src/ViewController.cpp:70-95).

Conventions: matrices are row-major numpy (4, 4) float32 acting on column
vectors (`world = M @ p`). glm stores column-major but computes `M * v`
with the same math, so `glm_mat[i]` (the i-th *column*, e.g. the camera
translation `rcpViewMatrix[3]` at src/main.cpp:918) is `M[:, i]` here.
"""

from __future__ import annotations

import numpy as np

Mat4 = np.ndarray
Vec3 = np.ndarray

# Camera fallback pose when no cache exists: the reference hard-codes
# transpose(float4x4(...)) i.e. these values are the ROWS of the view matrix
# (src/main.cpp:805-809).
DEFAULT_VIEW_MATRIX = np.array(
    [
        [0.996, 0.015, 0.084, 12.503],
        [0.005, 0.974, -0.228, 1.748],
        [-0.085, 0.227, 0.970, -325.982],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)


def normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    return v / np.float32(np.linalg.norm(v))


def look_at(eye: Vec3, center: Vec3, up: Vec3) -> Mat4:
    """Right-handed glm::lookAt (used by ViewController, src/ViewController.cpp:95)."""
    eye = np.asarray(eye, np.float32)
    f = normalize(np.asarray(center, np.float32) - eye)
    s = normalize(np.cross(f, np.asarray(up, np.float32)))
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -s @ eye
    m[1, 3] = -u @ eye
    m[2, 3] = f @ eye
    return m


def perspective(fovy_rad: float, aspect: float, near: float, far: float) -> Mat4:
    """Right-handed glm::perspective, NDC z in [-1, 1] (src/main.cpp:828)."""
    t = np.tan(0.5 * fovy_rad)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -2.0 * far * near / (far - near)
    m[3, 2] = -1.0
    return m


def rotate(m: Mat4, angle_rad: float, axis: Vec3) -> Mat4:
    """glm::rotate: post-multiply `m` by a rotation about `axis`.

    Used for camera roll / yaw / pitch deltas (src/ViewController.cpp:70,83-84).
    """
    a = normalize(axis)
    c = np.float32(np.cos(angle_rad))
    s = np.float32(np.sin(angle_rad))
    x, y, z = a
    # Rodrigues rotation matrix.
    r = np.array(
        [
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ],
        dtype=np.float32,
    )
    r4 = np.eye(4, dtype=np.float32)
    r4[:3, :3] = r
    return (m @ r4).astype(np.float32)


def inverse(m: Mat4) -> Mat4:
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def camera_position(rcp_view: Mat4) -> Vec3:
    """Camera world position = translation column of the inverse view matrix
    (`getRcpViewMatrix()[3]`, src/main.cpp:918)."""
    return rcp_view[:3, 3].astype(np.float32)


def camera_axes(rcp_view: Mat4) -> tuple[Vec3, Vec3, Vec3]:
    """(front, left, up) as derived by ViewController (src/ViewController.cpp:11-13):
    front = -col2, left = -col0, up = col1 of the inverse view matrix."""
    front = -rcp_view[:3, 2]
    left = -rcp_view[:3, 0]
    up = rcp_view[:3, 1]
    return front.astype(np.float32), left.astype(np.float32), up.astype(np.float32)
