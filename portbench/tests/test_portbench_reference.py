"""The frozen reference agrees with the port's plain path, to the bit, at
a small size: the scenes, the camera block, the tile schedule and whole
steps of both configurations, fast_math on and off."""

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.generator import Snapshot, orbit_view
from portbench.reference import schedule
from portbench.reference.camera import DEFAULT_VIEW, packed_camera
from portbench.reference.scene import make_soup, make_spheres
from portbench.reference.tracer import make_scene
from portbench.tests.frames import SMALL


def cell(name, **extra):
    return harness.load_cell(name, 2 ** 31 + 12345, dict(SMALL, **extra))


def test_scene_matches_the_port():
    from l2n_tpu_torch.scene.spheres import compute_spheres
    from l2n_tpu_torch.scene.tessellate import build_triangle_scene
    c = cell("tri32k.converge")
    ref = make_spheres(c.ref_cfg, "cpu")
    port = compute_spheres(16, 1024.0, 0)
    for a, b in ((ref.cx, port.center_x), (ref.r2, port.sqr_radius),
                 (ref.albedo, port.albedo)):
        assert torch.equal(a, b)
    soup = make_soup(c.ref_cfg, "cpu")
    psoup = build_triangle_scene(port, 8, 4).soup()
    assert len(soup.tri) == 19  # v1, e1, e2, three normals, the mesh id
    for k, v in soup.tri.items():
        assert np.array_equal(v.numpy(), psoup[k]), k


@pytest.mark.parametrize("degrees", [0.0, 37.0, 200.0])
def test_camera_matches_the_port(degrees):
    from l2n_tpu_torch.camera.camera import Camera
    c = cell("spheres128.orbit")
    view = orbit_view(DEFAULT_VIEW, degrees)
    port = Camera.from_config(harness.port_config(c.ref_cfg),
                              view_matrix=view).packed()
    assert np.array_equal(packed_camera(c.ref_cfg, view), port)


@pytest.mark.parametrize("tiles", [0, 1, 3, 8])
def test_schedule_matches_the_port(tiles):
    from l2n_tpu_torch.render.tiles import tile_grid
    c = cell("tri32k.rows", width=1024, height=256, tiles_per_step=tiles)
    cfg = harness.port_config(c.ref_cfg)
    grid = tile_grid(cfg)
    assert np.array_equal(schedule.tile_order(c.ref_cfg),
                          grid[:, 1] * cfg.tile_count_x + grid[:, 0])
    k, t = cfg.effective_tiles_per_step, cfg.tile_count
    want = np.zeros(t, np.int64)
    for step in range(5, 12):
        for j in range(k):
            g = grid[(step * k + j) % t]
            want[g[1] * cfg.tile_count_x + g[0]] += 1
    assert np.array_equal(schedule.touches(c.ref_cfg, 5, 12), want)


@pytest.mark.parametrize("name,fast", [("spheres128.converge", True),
                                       ("spheres128.converge", False),
                                       ("tri32k.rows", False),
                                       ("tri32k.rows", True)])
def test_steps_match_the_plain_path(name, fast):
    """Two calls of the mix through the port's plain step, the second from
    the first's sums, against the reference at every pixel."""
    from l2n_tpu_torch.camera.camera import Camera
    from l2n_tpu_torch.render.state import init_frame_state
    c = cell(name, fast_math=fast)
    cfg = harness.port_config(c.ref_cfg)
    renderer, _ = harness.build_renderer(c, torch.device("cpu"), "torch")
    spc = int(c.mix["steps_per_call"])
    step = renderer.program.step
    view = orbit_view(DEFAULT_VIEW, 11.0)
    cam = Camera.from_config(cfg, view_matrix=view).packed()
    state = step(init_frame_state(cfg), cam)
    before = state.accum[:3].clone()
    state = step(state, cam)
    pixels = torch.arange(cfg.padded_height * cfg.padded_width)
    snap = Snapshot(spc, 0, view, before, state.accum, state.output)
    acc, out, _ = check.reference_call(c.ref_cfg, make_scene(c.ref_cfg,
                                                             "cpu"),
                                       snap, pixels, spc)
    assert torch.equal(acc, state.accum.reshape(4, -1))
    assert torch.equal(out, state.output.reshape(3, -1))
    assert float(acc[:3].sum()) > 0.0
