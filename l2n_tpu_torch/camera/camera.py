"""Per-frame camera uniforms.

The reference re-uploads ~10 uniforms per frame (`gpuRender`,
src/main.cpp:904-922): the inverse view matrix, the inverse
view-projection matrix, the camera position and the projection constants.
Here they are packed into ONE small (10, 4) float32 array — the same layout
as l2n_tpu.camera.camera — which the CUDA kernels read from a device buffer
(a built step's own, written when the camera changes, so that one CUDA
graph of the step serves every pose: ops/kernels/common.DeviceCamera) and
the plain torch path reads as a (10, 4) tensor.

Packed layout (rows):
  0..3  inverse view matrix (row-major)          — uRcpViewMatrix
  4..7  inverse (proj @ view) matrix (row-major) — uRcpViewProjMatrix
  8     camera world position, pad               — uCameraPosition
  9     (aspect_ratio, tan_half_fovy,            — uProjRatio, uProjTanHalfFovy
         row_offset, rng_stream)                 — the slab extras

The slab extras serve a render sharded over several ranks
(l2n_tpu_torch.parallel): a rank renders a slab of rows of the frame, whose
first global row is `row_offset`, under the random stream `rng_stream`
(`slab_camera`). The kernels and the plain step take the pixel index and
the camera ray from the global row and key their counter-based samplers on
the stream. A render on one card keeps both at 0, as `Camera.packed`
leaves them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from l2n_tpu_torch.maths import linalg
from l2n_tpu_torch.utils.profiling import Site

# The spans this module records (utils/profiling.py).
_CAMERA_BUILD = Site("camera.build")
_CAMERA_PACK = Site("camera.pack")

# Static row/col indices into the packed camera array.
ROW_RCP_VIEW = 0
ROW_RCP_VIEW_PROJ = 4
ROW_POSITION = 8
ROW_PROJ = 9
PACKED_SHAPE = (10, 4)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Host-side camera: view matrix + projection parameters."""

    view_matrix: np.ndarray  # (4, 4) float32, world -> view
    fovy_deg: float = 45.0   # src/main.cpp:827
    aspect_ratio: float = 16.0 / 9.0
    near: float = 0.01
    far: float = 100.0

    @classmethod
    def from_config(cls, cfg, view_matrix: np.ndarray | None = None) -> "Camera":
        with _CAMERA_BUILD:
            vm = (linalg.DEFAULT_VIEW_MATRIX if view_matrix is None
                  else np.asarray(view_matrix, np.float32))
            return cls(view_matrix=vm, fovy_deg=cfg.fovy_deg,
                       aspect_ratio=cfg.aspect_ratio, near=cfg.near,
                       far=cfg.far)

    @property
    def rcp_view(self) -> np.ndarray:
        return linalg.inverse(self.view_matrix)

    @property
    def proj(self) -> np.ndarray:
        return linalg.perspective(np.radians(self.fovy_deg), self.aspect_ratio,
                                  self.near, self.far)

    @property
    def position(self) -> np.ndarray:
        return linalg.camera_position(self.rcp_view)

    @property
    def tan_half_fovy(self) -> float:
        return float(np.tan(0.5 * np.radians(self.fovy_deg)))

    def packed(self) -> np.ndarray:
        """(10, 4) float32 uniform block (see module docstring)."""
        with _CAMERA_PACK:
            rcp_view = self.rcp_view
            out = np.zeros(PACKED_SHAPE, np.float32)
            out[ROW_RCP_VIEW:ROW_RCP_VIEW + 4] = rcp_view
            out[ROW_RCP_VIEW_PROJ:ROW_RCP_VIEW_PROJ + 4] = linalg.inverse(
                self.proj @ self.view_matrix)
            out[ROW_POSITION, :3] = linalg.camera_position(rcp_view)
            out[ROW_PROJ, 0] = self.aspect_ratio
            out[ROW_PROJ, 1] = self.tan_half_fovy
            return out


def slab_camera(packed: np.ndarray, row_offset: int, stream: int
                ) -> np.ndarray:
    """A copy of the packed camera carrying the slab extras (module doc):
    the slab's first global row and its random stream, as float32 (exact
    below 2^24)."""
    out = np.array(packed, np.float32, copy=True)
    out[ROW_PROJ, 2] = row_offset
    out[ROW_PROJ, 3] = stream
    return out


def slab_extras(packed) -> tuple[int, int]:
    """(row_offset, stream) of a packed camera; raises ValueError unless
    both are whole numbers in [0, 2^24). (Read as Python floats: every
    render step calls it.)"""
    extras = np.asarray(packed, np.float32)[ROW_PROJ, 2:4].tolist()
    if not all(0 <= x < 2 ** 24 and x == int(x) for x in extras):
        raise ValueError(f"camera row {ROW_PROJ}: slab extras {extras} must "
                         "be whole numbers in [0, 2^24)")
    return int(extras[0]), int(extras[1])
