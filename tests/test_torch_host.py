"""l2n_tpu_torch host layer against l2n_tpu's: scene, tile schedule,
camera block, matrix helpers and camera persistence are byte-equal."""

import sys

import numpy as np
import jax.numpy as jnp
import pytest

from l2n_tpu.camera import Camera as JCamera
from l2n_tpu.camera import ControllerInput as JInput
from l2n_tpu.camera import ViewController as JController
from l2n_tpu.camera.cache import save_view_matrix as jsave
from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.maths import linalg as jlinalg
from l2n_tpu.render import tiles as jtiles
from l2n_tpu.scene.spheres import compute_spheres as jcompute
from l2n_tpu.scene.spheres import spheres_disjoint as jdisjoint
from l2n_tpu_torch.camera import Camera, ControllerInput, ViewController
from l2n_tpu_torch.camera.cache import load_view_matrix
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths import linalg
from l2n_tpu_torch.render import tiles
from l2n_tpu_torch.scene.spheres import compute_spheres, spheres_disjoint


def _jcfg(cfg):
    """The JAX package's config for the same settings (the port's own
    RenderConfig has the same JSON form)."""
    return JRenderConfig.from_json(cfg.to_json())


def _forget_port():
    """Drop the port's modules from sys.modules; this file keeps its own
    bindings. tests/test_aot_cache.py asserts that every loaded module
    named "l2n_tpu*" lies in the JAX package's AOT digest scope, and every
    xdist worker imports every test file, so the port (a separate package
    whose name shares that prefix) must not stay loaded."""
    for name in [m for m in sys.modules if m.startswith("l2n_tpu_torch")]:
        del sys.modules[name]


_forget_port()


@pytest.fixture(scope="module", autouse=True)
def _port_unloaded_after_module():
    yield
    _forget_port()


def _bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("count,world,seed", [(128, 1024.0, 0), (16, 1024.0, 0),
                                              (37, 300.0, 5)])
def test_compute_spheres_byte_equal(count, world, seed):
    j = jcompute(count, world, seed)
    t = compute_spheres(count, world, seed)
    for name in ("center_x", "center_y", "center_z", "sqr_radius"):
        _bytes_equal(getattr(t, name).numpy(), getattr(j, name))
    _bytes_equal(t.as_numpy(), j.as_numpy())
    assert spheres_disjoint(t) == jdisjoint(j)
    assert spheres_disjoint(t, 0.02) == jdisjoint(j, 0.02)


def test_packed_scene_layout():
    """Rows: centre, r^2, the albedo, then the material table's six
    channels (scene/materials.MATERIAL_CHANNELS)."""
    t = compute_spheres(16)
    p = t.packed()
    assert p.shape == (13, 16) and p.is_contiguous()
    _bytes_equal(p[3].numpy(), t.sqr_radius.numpy())
    _bytes_equal(p[4:7].T.numpy(), t.albedo.numpy())
    _bytes_equal(p[7:].T.numpy(), t.material.numpy())


@pytest.mark.parametrize("kw", [{}, {"width": 256, "height": 128},
                                {"width": 100, "height": 70, "tile_width": 32,
                                 "tile_shuffle_seed": 3}])
def test_tile_grid_byte_equal(kw):
    cfg = RenderConfig(**kw)
    _bytes_equal(tiles.tile_grid(cfg), jtiles.tile_grid(_jcfg(cfg)))


@pytest.mark.parametrize("tiles_per_step", [0, 7, 230])
def test_schedule_and_offset_equal(tiles_per_step):
    cfg = RenderConfig(tiles_per_step=tiles_per_step)
    grid = tiles.tile_grid(cfg)
    import torch
    tgrid = torch.as_tensor(grid)
    k = cfg.effective_tiles_per_step
    off_t, off_j = 0, jnp.int32(0)
    for _ in range(30):
        want = np.asarray(jtiles.scheduled_tiles(jnp.asarray(grid), off_j, k))
        got = tiles.scheduled_tiles(tgrid, off_t, k).numpy()
        np.testing.assert_array_equal(got, want)
        off_t = tiles.advance_offset(cfg, off_t)
        off_j = jtiles.advance_offset(_jcfg(cfg), off_j)
        assert off_t == int(off_j)


def _look_at_view():
    return jlinalg.look_at(np.array([3.0, -40.0, 120.0], np.float32),
                           np.array([10.0, 5.0, -2.0], np.float32),
                           np.array([0.0, 1.0, 0.0], np.float32))


@pytest.mark.parametrize("pose", ["default", "look_at"])
def test_camera_packed_byte_equal(pose):
    cfg = RenderConfig(width=320, height=200, fovy_deg=60.0)
    vm = None if pose == "default" else _look_at_view()
    _bytes_equal(Camera.from_config(cfg, vm).packed(),
                 JCamera.from_config(_jcfg(cfg), vm).packed())


def test_linalg_byte_equal():
    eye = np.array([1.0, 2.0, 3.0], np.float32)
    center = np.array([-4.0, 0.5, 9.0], np.float32)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    _bytes_equal(linalg.look_at(eye, center, up),
                 jlinalg.look_at(eye, center, up))
    _bytes_equal(linalg.perspective(0.7, 1.5, 0.01, 100.0),
                 jlinalg.perspective(0.7, 1.5, 0.01, 100.0))
    m = jlinalg.DEFAULT_VIEW_MATRIX
    _bytes_equal(linalg.rotate(m, 0.3, np.array([1.0, 2.0, 0.5])),
                 jlinalg.rotate(m, 0.3, np.array([1.0, 2.0, 0.5])))
    _bytes_equal(linalg.inverse(m), jlinalg.inverse(m))
    _bytes_equal(linalg.camera_position(linalg.inverse(m)),
                 jlinalg.camera_position(jlinalg.inverse(m)))
    for a, b in zip(linalg.camera_axes(linalg.inverse(m)),
                    jlinalg.camera_axes(jlinalg.inverse(m))):
        _bytes_equal(a, b)


def test_camera_cache_format_shared(tmp_path):
    """A pose saved by l2n_tpu reads back byte-equal in the port."""
    vm = _look_at_view()
    jsave(vm, tmp_path)
    _bytes_equal(load_view_matrix(tmp_path), vm)
    _bytes_equal(load_view_matrix(tmp_path / "missing"),
                 jlinalg.DEFAULT_VIEW_MATRIX)


def test_view_controller_equal():
    inputs = [dict(forward=True), dict(left=True, up=True),
              dict(roll_left=True), dict(dragging=True, cursor_dx=4.0,
                                         cursor_dy=-2.0), {}]
    t, j = ViewController(speed=102.4), JController(speed=102.4)
    for kw in inputs:
        assert t.update(ControllerInput(**kw), 0.016) == \
            j.update(JInput(**kw), 0.016)
        _bytes_equal(t.view_matrix, j.view_matrix)
