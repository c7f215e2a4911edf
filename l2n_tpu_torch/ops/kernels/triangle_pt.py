"""The triangle path-tracing step: the CUDA kernel's wrapper and its plain
torch version (counterpart of l2n_tpu/ops/kernels/triangle_pt.py).

`triangle_pt(cfg, sched, camera, buffers, accum, output, rng_state)`
renders the scheduled tiles of a triangle scene and updates `accum`,
`output` and, for the stateful rng modes, the `rng_state` planes IN PLACE:
  * on CUDA tensors it launches `csrc/triangle_pt.cu` (one thread per pixel
    of the K scheduled tiles, each walking the packed bound hierarchy front
    to back: primaries over the tile's cone-visible meshes, built per block
    in the kernel's prologue; in a scene of lat/long spheres the other
    casts test each mesh's shell window of cells, csrc/shellwalk.cuh) or
    raises; nothing falls back;
  * on CPU tensors it runs `triangle_pt_plain`, the same update in lockstep
    torch with a brute-force sweep over the whole soup
    (ops/scenes.triangle_intersector), which is also `backend="torch"`.

Both read one per-mesh table (albedo, and the material channels of
scene/materials.MATERIAL_CHANNELS), evaluated once on the host, and both
use the kernel-form tonemap. Explicit lights (ops/lights.ExplicitLights)
ride beside the scene; their shadow rays walk every mesh, as NEE's do
(cfg.nee: cone sampling over the emissive meshes' bounding spheres,
ops/nee.py, which are the packed `mesh_bounds` the kernel walks);
homogeneous fog (cfg.fog_density > 0) takes the kernel's fog body.
`TriangleBuffers` holds what either version
reads: the soup for the plain version, the packed bounds, slab groups,
certain-hit data, slot rows and attribute rows for the kernel
(ops/kernels/triangle_pack.py), and the shell buffers of a lat/long
sphere scene (ops/kernels/shellwalk.py). `certain_hit_seed` is the
kernel's seed of a cast in torch, for tests and counts; the plain step
does not use it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from l2n_tpu_torch.maths.sampling import procedural_color, sqrt
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
from l2n_tpu_torch.ops.kernels.shellwalk import (
    MESH_STRIDE,
    SHELL_HEAD,
    shell_buffers,
)
from l2n_tpu_torch.ops.kernels.sphere_pt import check_lights
from l2n_tpu_torch.ops.kernels.triangle_pack import (
    BALLS,
    GROUP,
    SUBS,
    pack_mesh_blocks,
)
from l2n_tpu_torch.ops.nee import mesh_light_sampler
from l2n_tpu_torch.ops.scenes import (
    TRIANGLE_MISS_COLOR,
    triangle_anyhit,
    triangle_intersector,
)
from l2n_tpu_torch.scene.materials import material_table
from l2n_tpu_torch.utils.profiling import Site

# The spans this module records (utils/profiling.py).
_SCENE_PACK = Site("scene.pack")
_KERNEL_CHECK = Site("kernel.check")
_KERNEL_TRIANGLE_PT = Site("kernel.triangle_pt")


def max_meshes(cfg, lights=None) -> int:
    """The meshes a block's shared memory holds (csrc/triangle_pt.cu
    smem_bytes): per mesh its bound, the table rows it stages, its slab
    count and a visible-list entry, plus 33 words; at most the 227 KiB a
    Hopper block can opt in to. The slab and sub-cluster bounds are read
    through the read-only cache."""
    return (MAX_SMEM - 33 * 4) // ((4 + table_rows(cfg, lights) + 2) * 4)

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
    material     (6, M) rows of scene/materials.MATERIAL_CHANNELS per mesh;
    mesh_bounds  (M, 4) [cx cy cz r^2];  slab_count (M,) int32;
    slab_bounds  (M, S, 5);  sub_bounds (M, S, 8, 5);
    group_bounds (M, ceil(S / 8), 5): the 8-slab groups' spheres;
    inner_gap    (M,) and balls (M, 8, 4): the certain-hit data;
    tris         (M * S * 128, 12): per slot v1 xyz, e1 xyz, e2 xyz, the
                 slot's soup index (int32 bits, -1 for padding), 0, 0;
    attrs        (T, 16): per soup triangle na nb nc xyz, ta tb tc uv, the
                 mesh id (int32 bits);
    shell        (64 + 8 M,), shell_tris (R, 12): the shell visit's
                 constants, spheres and stored rows by cell for a scene of
                 lat/long sphere meshes (ops/kernels/shellwalk.py
                 shell_buffers); a zero head and R = 0 for any other;
    shelled      whether the scene has them.
    The kernel trusts the values `from_scene` packs (slab counts <= S, slot
    indices < T); the wrappers check dtypes, shapes and devices.
    """

    soup: dict
    albedo: torch.Tensor
    material: torch.Tensor
    mesh_bounds: torch.Tensor
    slab_count: torch.Tensor
    slab_bounds: torch.Tensor
    sub_bounds: torch.Tensor
    group_bounds: torch.Tensor
    inner_gap: torch.Tensor
    balls: torch.Tensor
    tris: torch.Tensor
    attrs: torch.Tensor
    shell: torch.Tensor
    shell_tris: torch.Tensor
    shelled: bool

    @classmethod
    def from_scene(cls, scene, device="cpu") -> "TriangleBuffers":
        """Pack a TriangleScene on the host and move it to `device` once."""
        with _SCENE_PACK:
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
            slot_of = np.zeros(n_tri, np.int64)
            live = packed.slot_index >= 0
            slot_of[packed.slot_index[live]] = np.flatnonzero(live)
            shell, shell_tris, shelled = shell_buffers(
                scene, soup_np, packed.bounds,
                lambda idx: tris.reshape(-1, TRI_STRIDE)[slot_of[idx]])

            def dev(a):
                return torch.as_tensor(np.ascontiguousarray(a)).to(device)

            return cls(
                soup={k: dev(v) for k, v in soup_np.items()},
                albedo=albedo.to(device),
                material=material_table(m).T.contiguous().to(device),
                mesh_bounds=dev(packed.bounds),
                slab_count=dev(packed.slab_count),
                slab_bounds=dev(packed.slab_bounds),
                sub_bounds=dev(packed.sub_bounds),
                group_bounds=dev(packed.group_bounds),
                inner_gap=dev(packed.inner_gap),
                balls=dev(packed.balls),
                tris=dev(tris.reshape(-1, TRI_STRIDE)),
                attrs=dev(attrs), shell=dev(shell), shell_tris=dev(shell_tris),
                shelled=shelled)

    def kernel_arrays(self, shell: bool = True) -> tuple:
        """The scene's buffers in the kernel's argument order
        (csrc/triangle_pt.cu l2n_triangle_pt, after sched); without
        `shell`, None for the shell buffers (no shell visits)."""
        shells = (self.shell, self.shell_tris) if shell else (None, None)
        return (self.mesh_bounds, self.slab_count, self.slab_bounds,
                self.sub_bounds, self.group_bounds, self.inner_gap,
                self.balls, self.tris, self.attrs, *shells, self.albedo,
                self.material)

    def with_tables(self, albedo=None, material=None) -> "TriangleBuffers":
        """The buffers with another (M, 3) albedo or (M, 6) material table
        (host arrays or tensors; e.g. the JAX package's hash values, or an
        albedo with the Phong override applied)."""
        def rows(new, old):
            if new is None:
                return old
            new = torch.as_tensor(new, dtype=torch.float32).T
            if new.shape != old.shape:
                raise ValueError(f"table shape {tuple(new.T.shape)}, "
                                 f"expected {tuple(old.T.shape)}")
            return new.contiguous().to(old.device)

        return dataclasses.replace(
            self, albedo=rows(albedo, self.albedo),
            material=rows(material, self.material))

    def table(self) -> torch.Tensor:
        """(M, 9) the plain path's per-mesh table: albedo, then material."""
        return torch.cat([self.albedo, self.material]).T


def _check(cfg, sched, camera, buffers, accum, output, rng_state, lights):
    with _KERNEL_CHECK:
        check_supported(cfg)
        check_lights(lights)
        if cfg.scene_kind != "triangle":
            raise ValueError(f"triangle_pt: scene_kind={cfg.scene_kind!r}")
        check_schedule(cfg, sched, accum, output)
        check_rng_state(cfg, rng_state, accum.device)
        if not isinstance(buffers, TriangleBuffers):
            raise TypeError(f"buffers: expected TriangleBuffers, got "
                            f"{type(buffers)}")
        dev = accum.device
        m, s = buffers.slab_bounds.shape[:2]
        n_tri = buffers.attrs.shape[0]
        f32 = torch.float32
        for name, dtype, shape in (
                ("albedo", f32, (3, m)), ("material", f32, (6, m)),
                ("mesh_bounds", f32, (m, 4)),
                ("slab_count", torch.int32, (m,)),
                ("slab_bounds", f32, (m, s, 5)),
                ("sub_bounds", f32, (m, s, SUBS, 5)),
                ("group_bounds", f32, (m, -(-s // GROUP), 5)),
                ("inner_gap", f32, (m,)), ("balls", f32, (m, BALLS, 4)),
                ("tris", f32, (m * s * 128, TRI_STRIDE)),
                ("attrs", f32, (n_tri, 16)),
                ("shell", f32, (SHELL_HEAD + MESH_STRIDE * m,)),
                ("shell_tris", f32,
                 (buffers.shell_tris.shape[0], TRI_STRIDE))):
            check_tensor(name, getattr(buffers, name), dtype, shape, dev)
        return check_step_camera(camera, dev)


def triangle_pt(cfg, sched: torch.Tensor, camera, buffers: TriangleBuffers,
                accum: torch.Tensor, output: torch.Tensor,
                rng_state: torch.Tensor | None = None, lights=None) -> None:
    """One render step over the scheduled tiles, in place (see module doc).

    sched (K, 2) int32 (tile_x, tile_y); camera the packed (10, 4) float32
    host array or a common.DeviceCamera (sphere_pt.sphere_pt); buffers the
    scene's TriangleBuffers; accum (4, Hp, Wp) and
    output (3, Hp, Wp) float32; rng_state the (8 or 4, Hp, Wp) int32 state
    planes of rng="tinymt"/"tauslcg", else None; all on one device.
    `lights`: ops/lights.ExplicitLights, or None (its albedo override is
    the caller's, written into `buffers`).
    """
    with _KERNEL_TRIANGLE_PT:
        camera = _check(cfg, sched, camera, buffers, accum, output,
                        rng_state, lights)
        if accum.device.type == "cpu":
            triangle_pt_plain(cfg, sched, camera, buffers, accum, output,
                              rng_state, lights)
            return
        if accum.device.type != "cuda":
            raise ValueError(f"triangle_pt: no kernel for device "
                             f"{accum.device}")
        m, s = buffers.slab_bounds.shape[:2]
        if m > max_meshes(cfg, lights):
            raise ValueError(f"triangle_pt: {m} meshes exceed the kernel's "
                             f"shared memory ({max_meshes(cfg, lights)} max)")
        camera = kernel_camera(camera, accum.device)
        ip, fp = step_params(cfg, sched.shape[0], m, camera, lights)
        light_rows = None if lights is None else lights.buffer(accum.device)
        launch("triangle_pt", cfg, accum.device, ip, fp, s, s * 128,
               camera.buffer, sched, *buffers.kernel_arrays(shell_route(cfg)),
               light_rows, accum, output, rng_state)


def shell_route(cfg) -> bool:
    """Whether a step of `cfg` sends its casts through the shell visits of
    a shelled scene: the JAX kernel's gate (l2n_tpu/ops/kernels/
    triangle_pt.py:1533-1551, its `fast` with sphere normals, which
    TriangleBuffers.shelled holds): any AOV but tex_coords and param_uv,
    whose primary-only casts take no shell visit anyway."""
    return cfg.aov not in ("tex_coords", "param_uv")


def triangle_pt_plain(cfg, sched: torch.Tensor, camera,
                      buffers: TriangleBuffers, accum: torch.Tensor,
                      output: torch.Tensor,
                      rng_state: torch.Tensor | None = None,
                      lights=None) -> None:
    """The plain torch version of `triangle_pt`: the same in-place update,
    computed in lockstep over the pixels of the scheduled tiles, with a
    brute-force sweep over every triangle, on whatever device the tensors
    are on."""
    check_supported(cfg)
    nee = mesh_light_sampler(cfg, buffers.mesh_bounds) if cfg.nee else None
    intersect = triangle_intersector(
        buffers.soup, buffers.mesh_bounds[:, 3] if cfg.nee else None)
    render_tiles_plain(cfg, sched, camera, intersect,
                       triangle_anyhit(intersect), buffers.table(), accum,
                       output, rng_state, TRIANGLE_MISS_COLOR, lights, nee)


def certain_hit_seed(buffers: TriangleBuffers, ox, oy, oz, dx, dy,
                     dz) -> torch.Tensor:
    """The kernel's certain-hit seed of each cast (csrc/triangle_pt.cuh
    certain_hit, in the walk's first scan): over the meshes whose bound the
    ray enters from outside (the walk's test at best = inf), the nearest
    entry into an inscribed sphere or a live interior ball, times 1.000004
    plus 1e-5; inf where there is none. The same float32 operations in the
    same order (sqrt correctly rounded), in chunks of 4096 rays.
    (dx, dy, dz) is the bound tests' direction, of unit length."""
    shape = torch.broadcast_shapes(ox.shape, dx.shape)
    o = [torch.broadcast_to(a, shape).reshape(-1) for a in (ox, oy, oz)]
    d = [torch.broadcast_to(a, shape).reshape(-1) for a in (dx, dy, dz)]
    mb, gap = buffers.mesh_bounds, buffers.inner_gap
    balls = buffers.balls
    zero = torch.zeros((), dtype=torch.float32, device=mb.device)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=mb.device)
    out = []
    for i in range(0, o[0].numel(), 4096):
        oc = [a[i:i + 4096, None] for a in o]
        dc = [a[i:i + 4096, None] for a in d]
        ro = [oc[k] - mb[:, k] for k in range(3)]
        hb = ro[0] * dc[0] + ro[1] * dc[1] + ro[2] * dc[2]
        c = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2] - mb[:, 3]
        enters = ((c >= 0.0) & (hb < 0.0)
                  & (hb * hb - c >= -1e-6 * (c + mb[:, 3])))
        c_in = c + gap
        disc_in = hb * hb - c_in
        cross = (hb < 0.0) & (disc_in >= 0.0) & (c_in >= 0.0)
        ub = torch.where(cross, -hb - sqrt(torch.where(cross, disc_in, zero)),
                         inf)
        for k in range(BALLS):
            bl = balls[:, k]
            rb = [oc[j] - bl[:, j] for j in range(3)]
            hbb = rb[0] * dc[0] + rb[1] * dc[1] + rb[2] * dc[2]
            cb = rb[0] * rb[0] + rb[1] * rb[1] + rb[2] * rb[2] - bl[:, 3]
            discb = hbb * hbb - cb
            crossb = ((bl[:, 3] > 0.0) & (hbb < 0.0) & (discb >= 0.0)
                      & (cb >= 0.0))
            ub = torch.minimum(ub, torch.where(
                crossb, -hbb - sqrt(torch.where(crossb, discb, zero)), inf))
        seed = ub * torch.tensor(1.000004, dtype=torch.float32) + 1e-5
        out.append(torch.where(enters, seed, inf).amin(1))
    return torch.cat(out).reshape(shape)


def takes_fallback(seed: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The casts whose seeded walk finds nothing under its seed, and so
    walks again unseeded: a finite seed and no brute-force hit (t, -1 for
    a miss) below it."""
    return (seed < float("inf")) & ~((t >= 0.0) & (t < seed))
