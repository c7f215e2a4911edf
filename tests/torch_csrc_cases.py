"""Render helpers shared by the tests/test_torch_csrc*.py files: the aimed
and inside views of the default sphere scene, the small triangle config
and its aimed camera, and whole renders of the plain path or of the
header's host build (the shim of tests/torch_csrc_shim.py). The port's
modules these bind stay loaded only as long as the test modules' own
(each drops `l2n_tpu_torch*` from sys.modules, ROADMAP Queue 3 #12).
"""

import numpy as np
import torch

from torch_csrc_shim import _ptr, host_params

from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt_plain
from l2n_tpu_torch.ops.kernels.triangle_pt import (
    TriangleBuffers,
    triangle_pt_plain,
)
from l2n_tpu_torch.ops.pathtrace import count_fog_collisions
from l2n_tpu_torch.render.state import init_rng_state
from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
from l2n_tpu_torch.scene.spheres import compute_spheres


def _aimed_view(cfg):
    """Look from between a diffuse (odd) sphere and its nearest emissive
    (even) one at the diffuse sphere: a lit frame (cf. tests/test_brdf.py)."""
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c = np.stack([sc.center_x.numpy(), sc.center_y.numpy(),
                  sc.center_z.numpy()], 1)
    r = np.sqrt(sc.sqr_radius.numpy())
    odd, even = np.arange(1, cfg.sphere_count, 2), np.arange(0, cfg.sphere_count, 2)
    dm = np.linalg.norm(c[odd][:, None] - c[even][None], axis=2)
    oi, ei = np.unravel_index(np.argmin(dm), dm.shape)
    j, e = odd[oi], even[ei]
    to_e = (c[e] - c[j]) / np.linalg.norm(c[e] - c[j])
    eye = c[j] + to_e * 5.0 * r[j]
    return look_at(eye.astype(np.float32), c[j].astype(np.float32),
                   np.array([0.0, 1.0, 0.0], np.float32))


def _render(cfg, cam, steps, host_lib=None, with_state=False):
    """accum, output (and the rng_state planes, or None) after `steps`
    steps of the plain step or of the host-built header."""
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    spheres = sc.packed()
    tiles = torch.as_tensor(tile_grid(cfg))
    accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
    output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
    planes = init_rng_state(cfg)
    k = cfg.effective_tiles_per_step
    for i in range(steps):
        sched = scheduled_tiles(tiles, (i * k) % cfg.tile_count, k)
        if host_lib is None:
            sphere_pt_plain(cfg, sched, cam, spheres, accum, output, planes)
        else:
            ip, fp = host_params(cfg, k, sc.count, cam)
            s_np, sp_np = sched.numpy(), spheres.numpy()
            a_np, o_np = accum.numpy(), output.numpy()
            assert host_lib.l2n_sphere_pt_host(
                _ptr(ip), _ptr(fp), _ptr(s_np), _ptr(sp_np), None,
                _ptr(a_np), _ptr(o_np),
                None if planes is None else _ptr(planes.numpy())) == 0
    if with_state:
        return accum.numpy(), output.numpy(), planes
    return accum.numpy(), output.numpy()


def _inside_view(cfg, j):
    """The eye inside sphere j, a third of its radius off its centre,
    looking through its wall at the nearest other sphere (the d2 <= r2 case
    of the cone cull: sphere j is every tile's first hit)."""
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c = np.stack([sc.center_x.numpy(), sc.center_y.numpy(),
                  sc.center_z.numpy()], 1).astype(np.float64)
    d = np.linalg.norm(c - c[j], axis=1)
    d[j] = np.inf
    to = (c[np.argmin(d)] - c[j]) / d.min()
    eye = c[j] + to * np.sqrt(float(sc.sqr_radius[j])) / 3.0
    return look_at(eye.astype(np.float32), c[np.argmin(d)].astype(np.float32),
                   np.array([0.0, 1.0, 0.0], np.float32))


TRI_CFG = RenderConfig(width=128, height=64, tile_width=128, tile_height=32,
                       sphere_count=8, disc_lat=8, disc_long=4,
                       tiles_per_step=1, scene_kind="triangle").validate()


def _tri_aimed_camera(cfg):
    """tests/test_kernels.py::TestTriangleKernel.aimed_camera: up close at
    the emissive sphere 0."""
    sp = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c0 = np.array([float(sp.center_x[0]), float(sp.center_y[0]),
                   float(sp.center_z[0])], np.float32)
    r0 = float(np.sqrt(float(sp.sqr_radius[0])))
    vm = look_at(c0 + np.array([0.0, 0.0, 2.5 * r0], np.float32), c0,
                 np.array([0.0, 1.0, 0.0], np.float32))
    return Camera.from_config(cfg, view_matrix=vm)


def _render_triangles(cfg, scene, cam, steps, host_lib=None,
                      fog_counts=None):
    """(accum, output) of `steps` steps of the plain step, or with
    `host_lib` of the header's host build; `fog_counts`, a dict, gets the
    plain render's fog counters (ops/pathtrace.py count_fog_collisions of
    the port modules this helper bound, the ones that render)."""
    if fog_counts is not None:
        with count_fog_collisions() as counts:
            out = _render_triangles(cfg, scene, cam, steps, host_lib)
        fog_counts.update(counts)
        return out
    buf = TriangleBuffers.from_scene(scene)
    tiles = torch.as_tensor(tile_grid(cfg))
    accum = torch.zeros((4, cfg.padded_height, cfg.padded_width))
    output = torch.zeros((3, cfg.padded_height, cfg.padded_width))
    k = cfg.effective_tiles_per_step
    for i in range(steps):
        sched = scheduled_tiles(tiles, (i * k) % cfg.tile_count, k)
        if host_lib is None:
            triangle_pt_plain(cfg, sched, cam, buf, accum, output)
            continue
        m, s = buf.slab_bounds.shape[:2]
        ip, fp = host_params(cfg, k, m, cam)
        arrays = [sched, *buf.kernel_arrays()]
        assert host_lib.l2n_triangle_pt_host(
            _ptr(ip), _ptr(fp), s, s * 128,
            *(_ptr(a.numpy()) for a in arrays), None, _ptr(accum.numpy()),
            _ptr(output.numpy()), None) == 0
    return accum.numpy(), output.numpy()
