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

Both read the scene's albedo table, evaluated once on the host (the
albedo hash magnifies one-ulp sin differences), and both use the
kernel-form tonemap. Not in this slice: the cone-cull visibility table
(the kernel sweeps all spheres for primary rays) and the t1-only
`assume_outside` sweep of disjoint scenes.
"""

from __future__ import annotations

import torch

from l2n_tpu_torch.ops.kernels.common import (
    check_camera,
    check_rng_state,
    check_schedule,
    check_supported,
    check_tensor,
    launch,
    render_tiles_plain,
    step_params,
)
from l2n_tpu_torch.ops.scenes import sphere_anyhit, sphere_intersector

# The kernel stages the (7, n) scene into shared memory without opting in
# to more than the default 48 KiB of dynamic shared memory per block.
MAX_SPHERES = (48 * 1024) // (7 * 4)


def _check(cfg, sched, camera, spheres, accum, output, rng_state):
    check_supported(cfg)
    if cfg.scene_kind != "sphere":
        raise ValueError(f"sphere_pt: scene_kind={cfg.scene_kind!r}")
    check_schedule(cfg, sched, accum, output)
    check_rng_state(cfg, rng_state, accum.device)
    n = spheres.shape[1] if isinstance(spheres, torch.Tensor) else -1
    check_tensor("spheres", spheres, torch.float32, (7, n), accum.device)
    return check_camera(camera)


def sphere_pt(cfg, sched: torch.Tensor, camera, spheres: torch.Tensor,
              accum: torch.Tensor, output: torch.Tensor,
              rng_state: torch.Tensor | None = None) -> None:
    """One render step over the scheduled tiles, in place (see module doc).

    sched (K, 2) int32 (tile_x, tile_y); camera the packed (10, 4) float32
    host array; spheres (7, n) float32 (SphereScene.packed()); accum
    (4, Hp, Wp) and output (3, Hp, Wp) float32; rng_state the (8 or 4, Hp,
    Wp) int32 state planes of rng="tinymt"/"tauslcg", else None; all on one
    device.
    """
    camera = _check(cfg, sched, camera, spheres, accum, output, rng_state)
    if accum.device.type == "cpu":
        sphere_pt_plain(cfg, sched, camera, spheres, accum, output,
                        rng_state)
        return
    if accum.device.type != "cuda":
        raise ValueError(f"sphere_pt: no kernel for device {accum.device}")
    n = spheres.shape[1]
    if n > MAX_SPHERES:
        raise ValueError(f"sphere_pt: {n} spheres exceed the kernel's shared "
                         f"memory ({MAX_SPHERES} max)")
    ip, fp = step_params(cfg, sched.shape[0], n, camera)
    launch("sphere_pt", cfg, accum.device, ip, fp, sched, spheres, accum,
           output, rng_state)


def sphere_pt_plain(cfg, sched: torch.Tensor, camera, spheres: torch.Tensor,
                    accum: torch.Tensor, output: torch.Tensor,
                    rng_state: torch.Tensor | None = None) -> None:
    """The plain torch version of `sphere_pt`: the same in-place update,
    computed in lockstep over the pixels of the scheduled tiles on
    whatever device the tensors are on."""
    check_supported(cfg)
    cx, cy, cz, r2 = spheres[0], spheres[1], spheres[2], spheres[3]
    render_tiles_plain(cfg, sched, camera, sphere_intersector(cx, cy, cz, r2),
                       sphere_anyhit(cx, cy, cz, r2), spheres[4:7].T, accum,
                       output, rng_state)
