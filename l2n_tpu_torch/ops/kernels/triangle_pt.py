"""The triangle path-tracing step: the CUDA kernel's wrapper and its plain
torch version (counterpart of l2n_tpu/ops/kernels/triangle_pt.py).

`triangle_pt(cfg, sched, camera, buffers, accum, output)` renders the
scheduled tiles of a triangle scene and updates `accum` and `output` IN
PLACE:
  * on CUDA tensors it launches `csrc/triangle_pt.cu` (one thread per pixel
    of the K scheduled tiles, each walking the packed bound hierarchy) or
    raises; nothing falls back;
  * on CPU tensors it runs `triangle_pt_plain`, the same update in lockstep
    torch with a brute-force sweep over the whole soup
    (ops/scenes.triangle_intersector), which is also `backend="torch"`.

Both read one per-mesh albedo table, evaluated once on the host, and both
use the kernel-form tonemap. `TriangleBuffers` holds what either version
reads: the soup for the plain version, the packed bounds, slot rows and
attribute rows for the kernel (ops/kernels/triangle_pack.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from l2n_tpu_torch.maths.sampling import procedural_color
from l2n_tpu_torch.ops.kernels.common import (
    check_camera,
    check_schedule,
    check_supported,
    check_tensor,
    launch,
    render_tiles_plain,
    step_params,
)
from l2n_tpu_torch.ops.kernels.triangle_pack import SUBS, pack_mesh_blocks
from l2n_tpu_torch.ops.scenes import triangle_anyhit, triangle_intersector

# The kernel stages 8 floats per mesh (bounds, albedo, slab count) into
# shared memory without opting in to more than the default 48 KiB.
MAX_MESHES = (48 * 1024) // (8 * 4)

# Rows of the kernel's per-slot and per-triangle buffers (csrc/
# triangle_pt.cuh kTriStride, kAttrStride).
TRI_STRIDE = 12
ATTR_KEYS = ("nax", "nay", "naz", "nbx", "nby", "nbz", "ncx", "ncy", "ncz",
             "tau", "tav", "tbu", "tbv", "tcu", "tcv")


@dataclasses.dataclass(frozen=True)
class TriangleBuffers:
    """A triangle scene as the step reads it, on one device (M meshes,
    T triangles, S slabs of 128 slots per mesh).

    soup         (T,) tensors of TriangleScene.soup() (the plain version);
    albedo       (3, M) procedural albedo rows (r, g, b) per mesh;
    mesh_bounds  (M, 4) [cx cy cz r^2];  slab_count (M,) int32;
    slab_bounds  (M, S, 5);  sub_bounds (M, S, 8, 5);
    tris         (M * S * 128, 12): per slot v1 xyz, e1 xyz, e2 xyz, the
                 slot's soup index (int32 bits, -1 for padding), 0, 0;
    attrs        (T, 16): per soup triangle na nb nc xyz, ta tb tc uv, the
                 mesh id (int32 bits).
    The kernel trusts the values `from_scene` packs (slab counts <= S, slot
    indices < T); the wrappers check dtypes, shapes and devices.
    """

    soup: dict
    albedo: torch.Tensor
    mesh_bounds: torch.Tensor
    slab_count: torch.Tensor
    slab_bounds: torch.Tensor
    sub_bounds: torch.Tensor
    tris: torch.Tensor
    attrs: torch.Tensor

    @classmethod
    def from_scene(cls, scene, device="cpu") -> "TriangleBuffers":
        """Pack a TriangleScene on the host and move it to `device` once."""
        soup_np = scene.soup()
        packed = pack_mesh_blocks(scene)
        m = packed.blocks.shape[0]
        tris = np.zeros((m, packed.tpad, TRI_STRIDE), np.float32)
        tris[:, :, :9] = packed.blocks[:, :9].transpose(0, 2, 1)
        tris.view(np.int32)[:, :, 9] = packed.slot_index
        n_tri = soup_np["v1x"].shape[0]
        attrs = np.zeros((n_tri, 16), np.float32)
        attrs[:, :15] = np.stack([soup_np[k] for k in ATTR_KEYS], 1)
        attrs.view(np.int32)[:, 15] = soup_np["mesh_id"]
        albedo = torch.stack(procedural_color(torch.arange(m)))

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(device)

        return cls(
            soup={k: dev(v) for k, v in soup_np.items()},
            albedo=albedo.to(device),
            mesh_bounds=dev(packed.bounds),
            slab_count=dev(packed.slab_count),
            slab_bounds=dev(packed.slab_bounds),
            sub_bounds=dev(packed.sub_bounds),
            tris=dev(tris.reshape(-1, TRI_STRIDE)),
            attrs=dev(attrs))


def _check(cfg, sched, camera, buffers, accum, output):
    check_supported(cfg)
    if cfg.scene_kind != "triangle":
        raise ValueError(f"triangle_pt: scene_kind={cfg.scene_kind!r}")
    check_schedule(cfg, sched, accum, output)
    if not isinstance(buffers, TriangleBuffers):
        raise TypeError(f"buffers: expected TriangleBuffers, got "
                        f"{type(buffers)}")
    dev = accum.device
    m, s = buffers.slab_bounds.shape[:2]
    n_tri = buffers.attrs.shape[0]
    f32 = torch.float32
    for name, dtype, shape in (
            ("albedo", f32, (3, m)), ("mesh_bounds", f32, (m, 4)),
            ("slab_count", torch.int32, (m,)),
            ("slab_bounds", f32, (m, s, 5)),
            ("sub_bounds", f32, (m, s, SUBS, 5)),
            ("tris", f32, (m * s * 128, TRI_STRIDE)),
            ("attrs", f32, (n_tri, 16))):
        check_tensor(name, getattr(buffers, name), dtype, shape, dev)
    return check_camera(camera)


def triangle_pt(cfg, sched: torch.Tensor, camera, buffers: TriangleBuffers,
                accum: torch.Tensor, output: torch.Tensor) -> None:
    """One render step over the scheduled tiles, in place (see module doc).

    sched (K, 2) int32 (tile_x, tile_y); camera the packed (10, 4) float32
    host array; buffers the scene's TriangleBuffers; accum (4, Hp, Wp) and
    output (3, Hp, Wp) float32, all on one device.
    """
    camera = _check(cfg, sched, camera, buffers, accum, output)
    if accum.device.type == "cpu":
        triangle_pt_plain(cfg, sched, camera, buffers, accum, output)
        return
    if accum.device.type != "cuda":
        raise ValueError(f"triangle_pt: no kernel for device {accum.device}")
    m, s = buffers.slab_bounds.shape[:2]
    if m > MAX_MESHES:
        raise ValueError(f"triangle_pt: {m} meshes exceed the kernel's "
                         f"shared memory ({MAX_MESHES} max)")
    ip, fp = step_params(cfg, sched.shape[0], m, camera)
    launch("triangle_pt", cfg, accum.device, ip, fp, s, s * 128, sched,
           buffers.mesh_bounds, buffers.slab_count, buffers.slab_bounds,
           buffers.sub_bounds, buffers.tris, buffers.attrs,
           buffers.albedo, accum, output)


def triangle_pt_plain(cfg, sched: torch.Tensor, camera,
                      buffers: TriangleBuffers, accum: torch.Tensor,
                      output: torch.Tensor) -> None:
    """The plain torch version of `triangle_pt`: the same in-place update,
    computed in lockstep over the pixels of the scheduled tiles, with a
    brute-force sweep over every triangle, on whatever device the tensors
    are on."""
    check_supported(cfg)
    intersect = triangle_intersector(buffers.soup)
    render_tiles_plain(cfg, sched, camera, intersect,
                       triangle_anyhit(intersect), buffers.albedo.T, accum,
                       output)
