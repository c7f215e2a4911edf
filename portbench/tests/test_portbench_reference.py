"""The frozen reference agrees with the port's plain path, to the bit, at
a small size: the scenes and the meshes' bounds, the camera block, the
tile schedule and whole steps of the configurations, fast_math on and
off, NEE with MIS on and off; and it refuses the NEE settings it does not
render."""

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.generator import Snapshot, orbit_view
from portbench.reference import schedule
from portbench.reference.camera import DEFAULT_VIEW, packed_camera
from portbench.reference.scene import make_soup, make_spheres
from portbench.reference.tracer import Counts, make_scene, render
from portbench.tests.frames import NEE_MIX, NEE_SMALL, SMALL


def cell(name, mix=None, **extra):
    return harness.load_cell(name, 2 ** 31 + 12345, dict(SMALL, **extra),
                             mix)


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


def test_mesh_bounds_match_the_port():
    from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
    from l2n_tpu_torch.scene.spheres import compute_spheres
    from l2n_tpu_torch.scene.tessellate import build_triangle_scene
    c = cell("tri32k-nee.converge", **NEE_SMALL)
    port = build_triangle_scene(compute_spheres(128, 1024.0, 0), 4, 4)
    bounds = TriangleBuffers.from_scene(port, torch.device("cpu")).mesh_bounds
    assert torch.equal(make_soup(c.ref_cfg, "cpu").bounds, bounds)


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
    two_calls_match(cell(name, fast_math=fast))


def two_calls_match(c, counts=None):
    from l2n_tpu_torch.camera.camera import Camera
    from l2n_tpu_torch.render.state import init_frame_state
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
                                       snap, pixels, spc, counts=counts)
    assert torch.equal(acc, state.accum.reshape(4, -1))
    assert torch.equal(out, state.output.reshape(3, -1))
    assert float(acc[:3].sum()) > 0.0


@pytest.mark.parametrize("mis", [True, False])
def test_nee_steps_match_the_plain_path(mis):
    """NEE by cone sampling, with MIS on and off: two calls as above, on a
    scene where every piece of it has lanes to work on."""
    counts = Counts()
    two_calls_match(cell("tri32k-nee.converge", NEE_MIX, mis=mis,
                         **NEE_SMALL), counts)
    c = counts.totals()
    assert c["nee"] > 1000 and c["shadow_hits"] > 500
    if mis:
        assert c["nee_mis"] > 1000 and c["mis_emission"] > 20
    else:
        assert c["nee_mis"] == c["mis_emission"] == 0


@pytest.mark.parametrize("setting,why", [
    ({"scene_kind": "sphere"}, "area NEE"),
    ({"fog_density": 0.001}, "fog_density"),
    ({"material_mode": "microfacet"}, "material_mode"),
    ({"normal_map": 0.5}, "normal_map")])
def test_nee_settings_the_reference_does_not_render_raise(setting, why):
    c = cell("tri32k-nee.converge", **setting)
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match=why):
        render(c.ref_cfg, make_scene(c.ref_cfg, "cpu"),
               packed_camera(c.ref_cfg, DEFAULT_VIEW), one, one, one + 1)
