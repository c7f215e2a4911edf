"""The work count and its arithmetic on a hand-checked ray."""

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
                 "sky_in": 0, "sky_iters": 0}
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
