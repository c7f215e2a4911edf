"""The port's per-tile cone cull of primary rays
(l2n_tpu_torch/ops/kernels/sphere_pt.py::visibility_table, the plain
version of the kernels' in-block table, csrc/cull.cuh) against the JAX
package's visibility_table, run op by op (`jax.disable_jit`, ROADMAP Queue
3 #9), on the views the kernels render: the default sphere view, the mesh
bounds of the default triangle scene, the torus field with its aimed
camera, both goldens' views and an eye inside a bound. The header's own
table is held against the plain one in tests/test_torch_csrc.py.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.ops.kernels.sphere_pt import visibility_table as jvisibility
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.kernels.sphere_pt import (
    full_visibility_table,
    visibility_table,
)
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.render.tiles import tile_grid
from l2n_tpu_torch.scene import (
    build_triangle_scene,
    compute_spheres,
    load_obj,
    torus_field_obj,
)


def _forget_port():
    """Drop the port's modules from sys.modules (ROADMAP Queue 3 #12):
    tests/test_aot_cache.py scans every loaded module named "l2n_tpu*"."""
    for name in [m for m in sys.modules if m.startswith("l2n_tpu_torch")]:
        del sys.modules[name]


_forget_port()


@pytest.fixture(scope="module", autouse=True)
def _port_unloaded_after_module():
    # One torch thread while this module runs: the suite's workers share
    # the machine's cores, and a torch pool as wide as the machine in each
    # of them oversubscribes the cores (the JAX package's tests included).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _forget_port()


GOLDEN = str(Path(__file__).resolve().parent / "golden"
             / "{}_pt_256x128_4spp.npz")


def _sphere_bounds(cfg):
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    return sc.packed()[:4].contiguous()


def _mesh_bounds(scene):
    return TriangleBuffers.from_scene(scene).mesh_bounds.T.contiguous()


def _aimed_at(bounds, j, toward, radii):
    """A view `radii` bound radii from bound j, on bound `toward`'s side,
    looking at bound j."""
    b = bounds.numpy().astype(np.float64)
    to_e = (b[:3, toward] - b[:3, j]) / np.linalg.norm(b[:3, toward] - b[:3, j])
    eye = b[:3, j] + to_e * radii * np.sqrt(b[3, j])
    return look_at(eye.astype(np.float32), b[:3, j].astype(np.float32),
                   np.array([0.0, 1.0, 0.0], np.float32))


def _view(case):
    """(cfg, bounds (4, n), packed camera) of each covered view."""
    if case == "default_spheres":
        cfg = RenderConfig().validate()
        return cfg, _sphere_bounds(cfg), Camera.from_config(cfg).packed()
    if case == "default_meshes":
        cfg = RenderConfig(scene_kind="triangle").validate()
        scene = build_triangle_scene(compute_spheres(
            cfg.sphere_count, cfg.world_size, cfg.scene_seed),
            cfg.disc_lat, cfg.disc_long)
        return cfg, _mesh_bounds(scene), Camera.from_config(cfg).packed()
    if case == "torus_field_aimed":
        cfg = RenderConfig(scene_kind="triangle").validate()
        bounds = _mesh_bounds(load_obj(torus_field_obj()))
        b = bounds.numpy()
        j = 1 + int(np.argmin(np.linalg.norm(b[:3, 1:].T - b[:3, 0], axis=1)))
        vm = _aimed_at(bounds, j, 0, 4.0)
        return cfg, bounds, Camera.from_config(cfg, view_matrix=vm).packed()
    if case in ("sphere_golden", "triangle_golden"):
        kind = case.split("_")[0]
        with np.load(GOLDEN.format(kind)) as data:
            cfg = RenderConfig.from_json(bytes(data["config"]).decode())
            vm = data["view_matrix"] if kind == "triangle" else None
        cam = Camera.from_config(cfg, view_matrix=vm).packed()
        if kind == "sphere":
            return cfg, _sphere_bounds(cfg), cam
        scene = build_triangle_scene(compute_spheres(
            cfg.sphere_count, cfg.world_size, cfg.scene_seed),
            cfg.disc_lat, cfg.disc_long)
        return cfg, _mesh_bounds(scene), cam
    assert case == "eye_inside"
    # The eye at a point inside sphere 5 (a quarter radius off its centre),
    # looking at sphere 6: the d2 <= r2 case keeps sphere 5 in every tile.
    cfg = RenderConfig().validate()
    bounds = _sphere_bounds(cfg)
    b = bounds.numpy().astype(np.float64)
    eye = b[:3, 5] + 0.25 * np.sqrt(b[3, 5]) * np.array([0.0, 0.6, 0.8])
    vm = look_at(eye.astype(np.float32), b[:3, 6].astype(np.float32),
                 np.array([0.0, 1.0, 0.0], np.float32))
    return cfg, bounds, Camera.from_config(cfg, view_matrix=vm).packed()


CASES = ["default_spheres", "default_meshes", "torus_field_aimed",
         "sphere_golden", "triangle_golden", "eye_inside"]


def _jax_table(cfg, bounds, cam, sched):
    b = [jnp.asarray(bounds[i].numpy()) for i in range(4)]
    scene = SimpleNamespace(center_x=b[0], center_y=b[1], center_z=b[2],
                            sqr_radius=b[3], count=bounds.shape[1])
    with jax.disable_jit():
        table = jvisibility(JRenderConfig.from_json(cfg.to_json()), scene,
                            jnp.asarray(cam), jnp.asarray(sched.numpy()))
    return np.asarray(table)


@pytest.mark.parametrize("case", CASES)
def test_visibility_table_matches_jax(case):
    """Every tile of the frame: the same visible count and the same kept
    spheres, in ascending index order. No tolerance: the tables are equal
    on every tile of every covered view (a margin rounding that differed
    would have to keep the port's set a superset of JAX's, and none does).
    The JAX table caps a row at 127 entries (its scalar-memory padding); no
    covered tile keeps that many."""
    cfg, bounds, cam = _view(case)
    sched = torch.as_tensor(tile_grid(cfg))
    got = visibility_table(cfg, bounds, cam, sched).numpy()
    want = _jax_table(cfg, bounds, cam, sched)
    n = bounds.shape[1]
    assert got.shape == (cfg.tile_count, 1 + n)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert want[:, 0].max() <= min(n, 127)
    for row_got, row_want in zip(got, want):
        k = row_want[0]
        np.testing.assert_array_equal(row_got[1:1 + k], row_want[1:1 + k])
        assert (np.diff(row_got[1:1 + k]) > 0).all()  # ascending
        assert sorted(row_got[1:]) == list(range(n))  # a permutation
    # The cull bites, yet some tile sees something.
    assert 0 < got[:, 0].max() and got[:, 0].mean() < n
    if case == "eye_inside":
        assert all(5 in row[1:1 + row[0]] for row in got)


def test_full_visibility_table_rows_in_tile_order():
    """full_visibility_table is visibility_table over every tile in
    tile-id order (tid = tile_y * tile_count_x + tile_x)."""
    cfg = RenderConfig(width=512, height=256).validate()
    bounds = _sphere_bounds(cfg)
    cam = Camera.from_config(cfg).packed()
    full = full_visibility_table(cfg, bounds, cam)
    tid = torch.arange(cfg.tile_count, dtype=torch.int32)
    sched = torch.stack([tid % cfg.tile_count_x, tid // cfg.tile_count_x], 1)
    assert torch.equal(full, visibility_table(cfg, bounds, cam, sched))
    shuffled = torch.as_tensor(tile_grid(cfg))
    tid = (shuffled[:, 1] * cfg.tile_count_x + shuffled[:, 0]).long()
    assert torch.equal(visibility_table(cfg, bounds, cam, shuffled),
                       full[tid])
