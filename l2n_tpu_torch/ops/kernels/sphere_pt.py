"""The sphere path-tracing step: the CUDA kernel's wrapper and its plain
torch version (counterpart of l2n_tpu/ops/kernels/sphere_pt.py).

`sphere_pt(cfg, sched, camera, spheres, accum, output, rng_state)` renders
the scheduled tiles and updates `accum`, `output` and, for the stateful
rng modes, the per-pixel `rng_state` planes IN PLACE — the port's
counterpart of the JAX step's donated and aliased buffers:
  * on CUDA tensors it launches `csrc/sphere_pt.cu` (one thread per pixel
    of the K scheduled tiles) or raises; nothing falls back;
  * on CPU tensors it runs `sphere_pt_plain`, the same update in lockstep
    torch (ops/pathtrace.shade), which is also `backend="torch"`.

Both read the scene's per-object table (albedo and the material
channels, rows 4-12 of SphereScene.packed()), evaluated once on the host
(the hash magnifies one-ulp sin differences), and both use the
kernel-form tonemap. Explicit lights (ops/lights.ExplicitLights) ride
beside the scene; their shadow rays sweep every sphere, as NEE's do
(cfg.nee: area sampling over the emissive spheres, ops/nee.py, whose
centres and radii are the buffer's own rows); homogeneous fog
(cfg.fog_density > 0) takes the kernel's fog body. The kernel sweeps only the tile's cone-visible
spheres for primary rays (csrc/cull.cuh, built per block in its
prologue); `visibility_table` is the same table in plain torch, the
counterpart of the JAX package's, against which the tests hold it. The
plain step sweeps every sphere: culling changes the work, not the image.
The JAX package's t1-only `assume_outside` sweep of disjoint scenes is
not ported: its bounce casts differ from the full sweep wherever an origin
rounds inside a sphere (probes/assume_outside.py counts them; ROADMAP
Queue 2 #6), and the kernels are held to the full sweep bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from l2n_tpu_torch.camera.camera import ROW_POSITION
from l2n_tpu_torch.maths.sampling import sqrt
from l2n_tpu_torch.ops.kernels.common import (
    MAX_SMEM,
    check_rng_state,
    check_schedule,
    check_step_camera,
    check_supported,
    check_tensor,
    kernel_camera,
    launch,
    render_tiles_plain,
    step_params,
    table_rows,
)
from l2n_tpu_torch.ops.lights import ExplicitLights
from l2n_tpu_torch.ops.nee import sphere_light_sampler
from l2n_tpu_torch.ops.pathtrace import generate_rays
from l2n_tpu_torch.ops.scenes import (
    SPHERE_MISS_COLOR,
    sphere_anyhit,
    sphere_intersector,
)
from l2n_tpu_torch.utils.profiling import Site

# The spans this module records (utils/profiling.py).
_KERNEL_CHECK = Site("kernel.check")
_KERNEL_SPHERE_PT = Site("kernel.sphere_pt")

# Rows of the packed sphere buffer (SphereScene.packed()): centre, r^2,
# then the per-object table.
SPHERE_ROWS = 13


def max_spheres(cfg, lights=None) -> int:
    """The spheres a block's shared memory holds (csrc/sphere_pt.cuh
    culled_scene_floats): the centres, r^2 and the table rows it stages,
    the visible list and its 4 origin terms per sphere, plus 33 words; at
    most the 227 KiB a Hopper block can opt in to."""
    return (MAX_SMEM - 33 * 4) // ((4 + table_rows(cfg, lights) + 5) * 4)


def check_spheres(spheres, device) -> int:
    """The (13, n) float32 packed spheres on `device`; returns n."""
    n = spheres.shape[1] if isinstance(spheres, torch.Tensor) else -1
    check_tensor("spheres", spheres, torch.float32, (SPHERE_ROWS, n), device)
    return n


def check_lights(lights) -> None:
    if lights is not None and not isinstance(lights, ExplicitLights):
        raise TypeError(f"lights: expected ExplicitLights, got {type(lights)}")


def _check(cfg, sched, camera, spheres, accum, output, rng_state, lights):
    with _KERNEL_CHECK:
        check_supported(cfg)
        if cfg.scene_kind != "sphere":
            raise ValueError(f"sphere_pt: scene_kind={cfg.scene_kind!r}")
        check_schedule(cfg, sched, accum, output)
        check_rng_state(cfg, rng_state, accum.device)
        check_spheres(spheres, accum.device)
        check_lights(lights)
        return check_step_camera(camera, accum.device)


def sphere_pt(cfg, sched: torch.Tensor, camera, spheres: torch.Tensor,
              accum: torch.Tensor, output: torch.Tensor,
              rng_state: torch.Tensor | None = None, lights=None) -> None:
    """One render step over the scheduled tiles, in place (see module doc).

    sched (K, 2) int32 (tile_x, tile_y); camera the packed (10, 4) float32
    host array, or a common.DeviceCamera on the frame's device, which the
    kernel reads when it runs (a CUDA graph of the call then serves any
    camera written into it); spheres (13, n) float32 (SphereScene.packed()); accum
    (4, Hp, Wp) and output (3, Hp, Wp) float32; rng_state the (8 or 4, Hp,
    Wp) int32 state planes of rng="tinymt"/"tauslcg", else None; all on one
    device. `lights`: ops/lights.ExplicitLights, or None (its albedo
    override is the caller's, written into `spheres`).
    """
    with _KERNEL_SPHERE_PT:
        camera = _check(cfg, sched, camera, spheres, accum, output,
                        rng_state, lights)
        if accum.device.type == "cpu":
            sphere_pt_plain(cfg, sched, camera, spheres, accum, output,
                            rng_state, lights)
            return
        if accum.device.type != "cuda":
            raise ValueError(f"sphere_pt: no kernel for device "
                             f"{accum.device}")
        n = spheres.shape[1]
        if n > max_spheres(cfg, lights):
            raise ValueError(f"sphere_pt: {n} spheres exceed the kernel's "
                             f"shared memory ({max_spheres(cfg, lights)} "
                             "max)")
        camera = kernel_camera(camera, accum.device)
        ip, fp = step_params(cfg, sched.shape[0], n, camera, lights)
        light_rows = None if lights is None else lights.buffer(accum.device)
        launch("sphere_pt", cfg, accum.device, ip, fp, camera.buffer, sched,
               spheres, light_rows, accum, output, rng_state)


def sphere_pt_plain(cfg, sched: torch.Tensor, camera, spheres: torch.Tensor,
                    accum: torch.Tensor, output: torch.Tensor,
                    rng_state: torch.Tensor | None = None,
                    lights=None) -> None:
    """The plain torch version of `sphere_pt`: the same in-place update,
    computed in lockstep over the pixels of the scheduled tiles on
    whatever device the tensors are on."""
    check_supported(cfg)
    cx, cy, cz, r2 = spheres[0], spheres[1], spheres[2], spheres[3]
    nee = sphere_light_sampler(cfg, spheres) if cfg.nee else None
    render_tiles_plain(cfg, sched, camera,
                       sphere_intersector(cx, cy, cz, r2, cfg.fast_math),
                       sphere_anyhit(cx, cy, cz, r2), spheres[4:].T, accum,
                       output, rng_state, SPHERE_MISS_COLOR, lights, nee)


def visibility_table(cfg, bounds: torch.Tensor, camera,
                     sched: torch.Tensor, row_offset=0) -> torch.Tensor:
    """(K, 1 + n) int32 -- per scheduled tile: [n_visible, kept indices in
    ascending order..., culled indices...], for the spheres `bounds` (4, n)
    float32 rows cx, cy, cz, r^2 (the sphere SoA, or the mesh bounds
    transposed) seen from the packed (10, 4) `camera`.

    The plain version of the kernels' in-block table (csrc/cull.cuh) and
    the counterpart of the JAX package's visibility_table, operation for
    operation in float32: every jittered primary ray of a tile lies in the
    cone of its corner rays (through generate_rays with zero jitter, so in
    the configured camera form and normalization); a
    sphere is kept if it meets that cone, relaxed by 5% of 1 - cos plus
    1e-4, or holds the camera (d2 <= r2). Unlike the JAX table, whose
    scalar-memory padding caps a row at 127 entries, no row is capped.
    Square roots are taken in float64 and rounded (maths/sampling.sqrt).
    `row_offset`: the global row of the frame's row 0 when `cfg` is a slab
    of a larger frame (the kernels read it from the camera's slab extras,
    csrc/cull.cuh tile_cone; the JAX table takes it as an argument too).
    """
    dev = bounds.device
    cam = torch.as_tensor(np.asarray(camera, np.float32)).to(dev)
    x0 = sched[:, 0].to(torch.float32) * float(cfg.tile_width)
    y0 = (sched[:, 1].to(torch.float32) * float(cfg.tile_height)
          + float(row_offset))
    x1 = x0 + float(cfg.tile_width)
    y1 = y0 + float(cfg.tile_height)
    zero = torch.zeros_like(x0)

    def dir_at(px, py):
        return generate_rays(cfg, cam, px, py, zero, zero)[3:]

    ax, ay, az = dir_at(0.5 * (x0 + x1), 0.5 * (y0 + y1))
    cos_min = torch.ones_like(ax)
    for px, py in ((x0, y0), (x1, y0), (x0, y1), (x1, y1)):
        dx, dy, dz = dir_at(px, py)
        cos_min = torch.minimum(cos_min, dx * ax + dy * ay + dz * az)
    cos_safe = cos_min - 0.05 * (1.0 - cos_min) - 1e-4
    sin_safe = sqrt(torch.clamp(1.0 - cos_safe * cos_safe, min=0.0))

    pos = cam[ROW_POSITION]
    vx = bounds[0][None, :] - pos[0]
    vy = bounds[1][None, :] - pos[1]
    vz = bounds[2][None, :] - pos[2]
    r2 = bounds[3][None, :]
    d2 = vx * vx + vy * vy + vz * vz
    dlen = sqrt(torch.clamp(d2, min=1e-20))
    cos_phi = (vx * ax[:, None] + vy * ay[:, None] + vz * az[:, None]) / dlen
    sin_a = torch.clamp(sqrt(r2) / dlen, max=1.0)
    cos_a = sqrt(torch.clamp(1.0 - sin_a * sin_a, min=0.0))
    keep = (d2 <= r2) | (
        cos_phi >= cos_safe[:, None] * cos_a - sin_safe[:, None] * sin_a)
    n_vis = keep.sum(dim=1, dtype=torch.int32)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    return torch.cat([n_vis[:, None], order.to(torch.int32)], dim=1)


def full_visibility_table(cfg, bounds: torch.Tensor, camera,
                          row_offset=0) -> torch.Tensor:
    """`visibility_table` for every tile of the frame, rows in tile-id order
    (tid = tile_y * tile_count_x + tile_x)."""
    tid = torch.arange(cfg.tile_count, dtype=torch.int32, device=bounds.device)
    sched = torch.stack([tid % cfg.tile_count_x, tid // cfg.tile_count_x], 1)
    return visibility_table(cfg, bounds, camera, sched, row_offset)
