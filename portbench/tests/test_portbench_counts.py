"""The work count and its arithmetic on a hand-checked ray, NEE's prices,
and the counts and launch bounds of the cells that render without NEE,
frozen from before the reference learned NEE."""

import numpy as np
import pytest
import torch

from portbench.counts import floor
from portbench.reference import tracer
from portbench.reference.scene import Spheres

CFG = {"emissive_every": 16, "emission_scale": 8192.0, "fast_math": False,
       "rr_ceiling": 0.9, "ray_epsilon": 0.01, "max_bounces": 2,
       "env_scale": 3.0, "seed": 7}


def one_sphere(index_emissive: bool):
    """A sphere of radius 2 at (0, 0, -10); object 0 is emissive."""
    t = torch.tensor
    albedo = torch.full((1, 3), 0.5)
    s = Spheres(t([0.0]), t([0.0]), t([-10.0]), t([4.0]), albedo)
    cfg = dict(CFG, emissive_every=1 if index_emissive else 16)
    return cfg, tracer.Scene(s, False)


def trace_one(cfg, scene, d):
    counts = tracer.Counts()
    sampler = tracer.PhiloxSampler(7, 0, torch.tensor([0]), torch.tensor([0]),
                                   6)
    sampler.draw2()  # the jitter
    z = torch.zeros(())
    rgb = tracer.trace(cfg, scene, sampler, z, z, z,
                       *(torch.tensor([v]) for v in d), counts=counts)
    counts.add("samples", 1)
    counts.add("pairs", 1)  # the jitter, as render() counts it
    counts.add("touches", 1)
    return rgb, counts.totals()


def test_an_emissive_hit_ends_the_path():
    cfg, scene = one_sphere(True)
    rgb, c = trace_one(cfg, scene, (0.0, 0.0, -1.0))
    # Le = 8192 / (4 pi r^2) with r^2 = 4
    assert rgb[0].item() == pytest.approx(8192.0 / (4 * np.pi * 4.0),
                                          rel=1e-6)
    assert c == {"touches": 1, "samples": 1, "pairs": 1, "hits": 1,
                 "any_hits": 0, "scatters": 0, "emissive": 1, "sky": 0,
                 "sky_in": 0, "sky_iters": 0, "nee": 0, "nee_mis": 0,
                 "shadow_hits": 0, "mis_emission": 0}
    # ray 30 + sum 3, the jitter's Philox pair 51, a sphere hit 24 + 20,
    # the emission 10, the pixel's accumulate 30
    ops = floor.floor_ops(c, "sphere", "tpu_hw")
    assert ops == 33 + 51 + 44 + 10 + 30


def test_a_miss_evaluates_the_sky_once():
    cfg, scene = one_sphere(False)
    d = torch.tensor([1.0, 0.0, 0.0])  # +x: inside the Mandelbrot box
    rgb, c = trace_one(cfg, scene, tuple(d.tolist()))
    le, in_box, iters = tracer.mandelbrot(*(v.reshape(1) for v in d))
    assert bool(in_box) and rgb[0].item() == pytest.approx(
        3.0 * le.item())
    assert (c["hits"], c["scatters"], c["sky"], c["sky_in"]) == (0, 0, 1, 1)
    assert c["sky_iters"] == int(iters)
    ops = floor.floor_ops(c, "sphere", "tpu_hw")
    assert c["pairs"] == 1
    assert ops == 33 + 51 + 8 + 60 + 9 * int(iters) + 30


def test_the_bound_of_a_launch():
    c = {"touches": 2, "samples": 8, "pairs": 32, "hits": 4, "any_hits": 1,
         "scatters": 3, "emissive": 1, "sky": 4, "sky_in": 2,
         "sky_iters": 20}
    ops = (8 * 33 + 32 * 51 + 4 * (62 + 27) + 62 + 3 * 70 + 10 + 4 * 8
           + 2 * 60 + 20 * 9 + 2 * 30)
    assert floor.floor_ops(c, "triangle", "tpu_hw") == ops
    seconds, by = floor.launch_bound(c, "triangle", "tpu_hw", 80, 20, 1000)
    assert by == "operations"
    assert seconds == pytest.approx(ops * 10 / floor.PEAK_OPS)
    seconds, by = floor.launch_bound(c, "triangle", "tpu_hw", 8, 10 ** 6, 0)
    assert by == "bytes" and seconds == pytest.approx(
        44e6 / floor.PEAK_BYTES)
    assert floor.scene_bytes("sphere", 128) == 3584
    assert floor.scene_bytes("triangle", 128, 32768) == 32768 * 72 + 1536


def test_cone_solid_angle():
    d2 = torch.tensor([4.0, 1.0, 0.5])
    omega, cos_max = tracer.cone_solid_angle(d2, torch.ones(3))
    assert cos_max[0].item() == pytest.approx(np.sqrt(0.75), rel=1e-6)
    assert omega[0].item() == pytest.approx(2 * np.pi * (1 - np.sqrt(0.75)),
                                            rel=1e-5)
    # on the sphere and inside it: every direction, 4 pi
    assert cos_max[1:].tolist() == [-1.0, -1.0]
    assert omega[1:].tolist() == pytest.approx([4 * np.pi] * 2)


def test_nee_work_is_priced():
    c = {"touches": 1, "samples": 1, "pairs": 5, "hits": 2, "any_hits": 0,
         "scatters": 2, "emissive": 1, "sky": 0, "sky_in": 0, "sky_iters": 0}
    plain = floor.floor_ops(c, "triangle", "tpu_hw")
    nee = dict(c, nee=2, nee_mis=1, shadow_hits=1, mis_emission=1)
    # a cone sample each, one balance weight, one shadow cast's winning
    # test (a Moller-Trumbore candidate), one emission's balance weight
    assert floor.floor_ops(nee, "triangle", "tpu_hw") == plain + (
        2 * 139 + 9 + 62 + 43)
    assert floor.floor_ops(dict(c, nee=0, nee_mis=0, shadow_hits=0,
                                mis_emission=0), "triangle",
                           "tpu_hw") == plain


# Counts.totals() of the check's reference over 512 pixels of a second call
# (cell, SMALL or SMALL with all 128 spheres), and the bound of a step they
# give: read from the harness before NEE, which the cells without NEE must
# still read (the new keys 0). tri32k.rows' bound is bytes, and a call's 4
# steps at SMALL read the scene once (harness.work_bound): read after that
# change; the others are bound by operations, which it leaves alone.
_KEYS = ("touches", "samples", "pairs", "hits", "any_hits", "scatters",
         "emissive", "sky", "sky_in", "sky_iters")
FROZEN = {
    ("spheres128.converge", 16): (
        (4096, 16384, 16856, 265, 0, 236, 29, 16153, 5988, 120153),
        1.8636173134328357e-07, "operations"),
    ("spheres128.orbit", 16): (
        (512, 2048, 2106, 32, 0, 29, 3, 2020, 749, 15040),
        1.8640143283582089e-07, "operations"),
    ("tri32k.converge", 16): (
        (1024, 4096, 4197, 58, 0, 51, 7, 4042, 1498, 29907),
        1.8629635820895524e-07, "operations"),
    ("tri32k.rows", 16): (
        (2048, 2048, 2096, 27, 0, 24, 3, 2023, 749, 15040),
        1.1311283582089552e-07, "bytes"),
    ("spheres128.converge", 128): (
        (4096, 16384, 24962, 4632, 46, 4503, 129, 13834, 4088, 114196),
        None, None),
    ("spheres128.orbit", 128): (
        (512, 2048, 3132, 585, 13, 570, 15, 1729, 510, 14353), None, None),
    ("tri32k.converge", 128): (
        (1024, 4096, 6040, 1054, 10, 1021, 33, 3503, 1053, 28741),
        None, None),
    ("tri32k.rows", 128): (
        (2048, 2048, 3018, 528, 12, 510, 18, 1753, 527, 14567), None, None),
}


@pytest.mark.parametrize("cell,spheres", sorted(FROZEN))
def test_cells_without_nee_read_the_frozen_counts(cell, spheres):
    from portbench import check, harness
    from portbench.generator import Snapshot
    from portbench.tests.frames import SMALL, SMALL_MIX
    seed = 2 ** 31 + 77
    c = harness.load_cell(cell, seed, dict(SMALL, sphere_count=spheres),
                          SMALL_MIX.get(cell))
    spc = int(c.mix["steps_per_call"])
    pixels = check.check_pixels(c.ref_cfg, 512, seed, "cpu")
    snap = Snapshot(spc, 0, np.asarray(c.config["view"], np.float32), None,
                    None, None)
    counts = tracer.Counts()
    check.reference_call(c.ref_cfg, tracer.make_scene(c.ref_cfg, "cpu"),
                         snap, pixels, spc, counts=counts)
    totals, seconds, by = FROZEN[cell, spheres]
    got = counts.totals()
    assert got == dict(zip(_KEYS, totals), nee=0, nee_mis=0, shadow_hits=0,
                       mis_emission=0)
    if seconds is not None:
        cfg = harness.port_config(c.ref_cfg)
        px = cfg.effective_tiles_per_step * cfg.tile_height * cfg.tile_width
        run = {"kernel": ("sphere_pt" if cfg.scene_kind == "sphere"
                          else "triangle_pt"),
               "samples_per_step": px * cfg.spp_per_step,
               "pixels_per_step": px}
        assert harness.work_bound(c, run, got) == {"seconds": seconds,
                                                   "by": by}
