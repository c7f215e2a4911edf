"""The frozen reference agrees with the port's plain path, to the bit, at
a small size: the scenes and the meshes' bounds, the camera block, the
tile schedule and whole steps of the configurations, fast_math on and
off, NEE with MIS on and off; it refuses the NEE settings it does not
render; and its triangle sweep takes no point that Moller-Trumbore
reports off a pole sliver's mesh, while it leaves every genuine hit as
the plain per-candidate sweep finds it."""

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.generator import Snapshot, orbit_view
from portbench.reference import schedule, tracer
from portbench.reference.camera import DEFAULT_VIEW, packed_camera
from portbench.reference.rng import PhiloxSampler, max_pairs_per_sample
from portbench.reference.scene import (make_soup, make_spheres, soup_of,
                                       tessellate_sphere)
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
    acc, out, _, _ = check.reference_call(c.ref_cfg, make_scene(c.ref_cfg,
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


# --------------------------------------------------------------------------
# The sweep's off-mesh rule.

def plain_sweep(soup, o, d):
    """The sweep without the off-mesh rule: (t, u, v, triangle) of the
    first soup index of the least Moller-Trumbore t over every triangle at
    once; a miss t = -1, u = v = 0, triangle -1."""
    t, u, v, valid = tracer._moller_trumbore(
        *(a.reshape(-1, 1) for a in o + d), soup.tri)
    t, u, v = (torch.broadcast_to(a, valid.shape) for a in (t, u, v))
    t = torch.where(valid, t, torch.full_like(t, float("inf")))
    i = torch.argmin(t, dim=1, keepdim=True)
    best = torch.gather(t, 1, i).squeeze(1)
    hit = torch.isfinite(best)
    zero = torch.zeros_like(best)
    return (torch.where(hit, best, zero - 1.0),
            torch.where(hit, torch.gather(u, 1, i).squeeze(1), zero),
            torch.where(hit, torch.gather(v, 1, i).squeeze(1), zero),
            torch.where(hit, i.squeeze(1), torch.full_like(i.squeeze(1), -1)))


def sliver_scene():
    """(soup, slivers, centre, radius): mesh 0 a sphere of radius 22 at
    |c| ~ 298 tessellated 16 x 8 as the configurations' meshes are, whose
    pole slivers have two corners one ulp apart; mesh 1 a wall of two
    triangles at z = -2000 behind it."""
    centre, radius = np.array([-24.0, 250.0, -160.0], np.float32), 22.0
    pos, _, idx = tessellate_sphere(centre, np.float32(radius), 16, 8)
    corners = [pos[idx.reshape(-1, 3)[:, k]] for k in range(3)]
    wall = np.array([[-5000, -5000, -2000], [5000, -5000, -2000],
                     [5000, 5000, -2000], [-5000, 5000, -2000]], np.float32)
    for k, w in enumerate((wall[[0, 0]], wall[[1, 2]], wall[[2, 3]])):
        corners[k] = np.concatenate([corners[k], w])
    v1, v2, v3 = corners
    arrays = {"mesh_id": np.repeat([0, 1], [len(idx) // 3, 2])}
    for name, arr in (("v1", v1), ("e1", v2 - v1), ("e2", v3 - v1)):
        for k, ax in enumerate("xyz"):
            arrays[f"{name}{ax}"] = arr[:, k]
    area = np.linalg.norm(np.cross(v2 - v1, v3 - v1), axis=1)
    slivers = np.flatnonzero((area > 0.0) & (area < 1e-3))
    return soup_of(arrays, 2, "cpu"), slivers, centre, radius


def test_a_pole_sliver_s_far_point_is_no_hit():
    """Rays that cross a pole sliver's plane on the extended line of its
    long edge, 1.2 to 30 edge lengths from the pole: Moller-Trumbore takes
    some of them at points off the mesh, some between 1 and 2 radii from
    its centre and some farther, nearer than the wall behind. The sweep
    takes the hit that float64 arithmetic finds (the wall, or the sphere
    where the ray meets it), and its tally counts each cast it changed."""
    soup, slivers, centre, radius = sliver_scene()
    assert len(slivers) == 8
    gen = torch.Generator().manual_seed(3)
    tri = soup.tri
    rays = []
    for s in slivers:
        v1 = torch.stack([tri[f"v1{a}"][s] for a in "xyz"])
        e2 = torch.stack([tri[f"e2{a}"][s] for a in "xyz"])
        k = torch.cat([1.2 + 3.8 * torch.rand(128, 1, generator=gen),
                       5.0 + 25.0 * torch.rand(128, 1, generator=gen)])
        x = v1 + k * e2
        o = x + torch.tensor([0.0, 0.0, 420.0]) + 200.0 * (
            torch.rand(256, 3, generator=gen) - 0.5)
        rays.append(torch.cat([o, (x - o) / (x - o).norm(dim=1,
                                                         keepdim=True)], 1))
    rays = torch.cat(rays).T
    o, d = list(rays[:3]), list(rays[3:])
    t0, _, _, i0 = plain_sweep(soup, o, d)
    point = torch.stack([a + t0 * b for a, b in zip(o, d)], 1)
    dist = (point - torch.as_tensor(centre)).norm(dim=1) / radius
    artefact = torch.isin(i0, torch.as_tensor(slivers)) & (dist > 1.001)
    assert int(artefact.sum()) >= 20
    assert int((artefact & (dist < 2.0)).sum()) >= 3
    tally = {"candidates": 0, "casts": 0}
    t, u, v, i = tracer._triangle_sweep(soup, *o, *d, tally)
    assert int(tally["casts"]) == int((i != i0).sum())
    assert not torch.isin(i[artefact], torch.as_tensor(slivers)).any()
    assert (soup.tri["mesh_id"][i[artefact]] == 1).any()
    wide = type(soup)({k: a.double() for k, a in soup.tri.items()},
                      soup.albedo, soup.bounds, soup.reach)
    t64, _, _, i64 = plain_sweep(wide, [a.double() for a in o],
                                 [a.double() for a in d])
    assert torch.equal(i, i64)
    assert torch.allclose(t.double(), t64, rtol=1e-5)


def test_genuine_hits_are_untouched():
    """Seeded rays aimed at random points of random triangles of a small
    tri32k-style soup, from anywhere in the world: the sweep returns what
    the plain per-candidate sweep returns, bit for bit, and its tally
    reads no changed cast. (The targets leave out the pole slivers: a ray
    aimed at one, a triangle one ulp wide, is the case of the test
    above.)"""
    soup = make_soup(cell("tri32k.converge").ref_cfg, "cpu")
    tri = soup.tri
    e1, e2 = ([tri[f"{e}{x}"] for x in "xyz"] for e in ("e1", "e2"))
    area = torch.linalg.cross(torch.stack(e1, 1), torch.stack(e2, 1)).norm(
        dim=1)
    wide = torch.nonzero(area > 1e-3).squeeze(1)
    gen = torch.Generator().manual_seed(11)
    n = 4096
    pick = wide[torch.randint(0, wide.numel(), (n,), generator=gen)]
    a, b = torch.rand(2, n, generator=gen)
    a, b = torch.where(a + b > 1.0, 1.0 - a, a), torch.where(
        a + b > 1.0, 1.0 - b, b)
    target = [tri[f"v1{x}"][pick] + a * tri[f"e1{x}"][pick]
              + b * tri[f"e2{x}"][pick] for x in "xyz"]
    o = list(1024.0 * (torch.rand(3, n, generator=gen) - 0.5))
    d = [p - q for p, q in zip(target, o)]
    rcp = 1.0 / torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = [c * rcp for c in d]
    want = plain_sweep(soup, o, d)
    assert float((want[0] >= 0.0).float().mean()) > 0.95
    tally = {"candidates": 0, "casts": 0}
    got = tracer._triangle_sweep(soup, *o, *d, tally)
    assert int(tally["casts"]) == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name,seed,row,col,sample,tri,t_far", [
    ("tri32k.converge", 3000000403, 379, 964, 6402, 20729, 512.0),
    ("tri32k.rows", 3000000404, 159, 788, 10385, 20711, 426.66668701171875)])
def test_a_recorded_parting_ray_misses_the_sliver(name, seed, row, col,
                                                  sample, tri, t_far):
    """Camera rays of the full-size cells on which the card's walk and the
    plain Moller-Trumbore sweep parted: regenerated from the reference's
    sampler, the plain sweep takes a pole sliver of light mesh 80 at a
    point more than 5 radii from the mesh; the sweep misses the scene."""
    c = harness.load_cell(name, seed)
    cfg = c.ref_cfg
    soup = make_soup(cfg, "cpu")
    cam = torch.as_tensor(packed_camera(cfg, np.asarray(c.config["view"],
                                                        np.float32)))
    wp = cfg["padded_width"]
    pix, smp = torch.tensor([row * wp + col]), torch.tensor([sample])
    sampler = PhiloxSampler(cfg["seed"], 0, pix, smp, max_pairs_per_sample(
        cfg["max_bounces"], False))
    u1, u2 = sampler.draw2()
    rays = tracer.primary_rays(cfg, cam, (pix % wp).float(),
                               (pix // wp).float(), u1, u2)
    o = [torch.broadcast_to(a, (1,)) for a in rays[:3]]
    d = list(rays[3:])
    t0, _, _, i0 = plain_sweep(soup, o, d)
    assert int(i0) == tri and float(t0) == t_far
    mesh = int(soup.tri["mesh_id"][tri])
    point = torch.stack([a + t0 * b for a, b in zip(o, d)]).squeeze(1)
    gap = float((point - soup.bounds[mesh, :3]).norm())
    assert mesh == 80 and gap > 5.0 * float(soup.bounds[mesh, 3].sqrt())
    tally = {"candidates": 0, "casts": 0}
    t, _, _, i = tracer._triangle_sweep(soup, *o, *d, tally)
    assert float(t) == -1.0 and int(i) == -1
    assert {k: int(v) for k, v in tally.items()} == {"candidates": 1,
                                                     "casts": 1}
