"""The port's rng="tpu_hw" mode on the CPU: Philox4x32-10 in place of the
TPU core's hardware PRNG (l2n_tpu_torch/rng/philox.py).

The counterpart of tests/test_tpu_hw.py, whose gates need a TPU. Like the
hardware stream, Philox is held to statistical parity, with those gates at
their sizes and thresholds: (a) at the bit level, on the raw-bits kernel's
plain version (ops/kernels/philox_bits.py, the counterpart of that file's
`draw_raw_bits`): monobit balance per bit position, byte chi-square,
per-lane balance, cross-draw and cross-seed correlation, the uniform_oo
moments; (b) at the estimator level, the port's plain tpu_hw render against
the JAX package's XLA threefry render (the JAX package has no CPU tpu_hw
render: l2n_tpu/render/step.py refuses it off the TPU). chip_smoke.py runs
the same gates on the card's kernels. All bounds are 6 sigma or looser.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from l2n_tpu.camera import Camera as JCamera
from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.render.state import init_frame_state as jinit
from l2n_tpu.render.step import build_render_step as jbuild
from l2n_tpu.scene.spheres import compute_spheres as jcompute
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.ops.kernels.philox_bits import philox_bits, philox_bits_plain
from l2n_tpu_torch.render.state import init_frame_state
from l2n_tpu_torch.render.step import build_render_step
from l2n_tpu_torch.rng.threefry import uniform_oo_from_bits
from l2n_tpu_torch.scene.spheres import compute_spheres


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
    # One torch thread while this module runs: the suite's workers share
    # the machine's cores, and a torch pool as wide as the machine in each
    # of them oversubscribes the cores (the JAX package's tests included).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _forget_port()


def draw_raw_bits(seed0: int, seed1: int, k: int = 4, h: int = 256):
    """(k, h, 128) uint32 words from two int32 seeds (the wrapper on a CPU
    tensor runs the plain version)."""
    seeds = torch.tensor([seed0, seed1], dtype=torch.int32)
    return philox_bits(seeds, k, h).numpy().view(np.uint32)


POPCOUNT = np.array([bin(x).count("1") for x in range(256)], np.int64)


def test_wrapper_cpu_is_plain_and_checks():
    seeds = torch.tensor([3, 9], dtype=torch.int32)
    np.testing.assert_array_equal(philox_bits(seeds, 2, 8).numpy(),
                                  philox_bits_plain(seeds, 2, 8).numpy())
    with pytest.raises(TypeError, match="seeds"):
        philox_bits(seeds.long())
    with pytest.raises(ValueError, match="positive"):
        philox_bits(seeds, 0, 8)
    with pytest.raises(ValueError, match="no kernel"):
        philox_bits(seeds.to("meta"))


def test_monobit_per_bit_position():
    words = draw_raw_bits(0x1234, 0x5678)
    n = words.size
    ones = np.array([(words >> b & 1).sum() for b in range(32)], np.int64)
    assert np.abs(ones - n / 2).max() < 6 * np.sqrt(n) / 2, ones


def test_byte_chi_square():
    by = draw_raw_bits(0xBEEF, 7).view(np.uint8)
    hist = np.bincount(by.reshape(-1), minlength=256).astype(np.float64)
    expect = by.size / 256.0
    chi2 = float(((hist - expect) ** 2 / expect).sum())
    assert chi2 < 255 + 8 * np.sqrt(2 * 255), chi2


def test_per_lane_balance():
    by = draw_raw_bits(42, 99).view(np.uint8).reshape(4, 256, 128, 4)
    ones_per_lane = POPCOUNT[by].sum(axis=(0, 1, 3))
    n = 4 * 256 * 32
    assert np.abs(ones_per_lane - n / 2).max() < 6 * np.sqrt(n) / 2


def test_cross_draw_and_cross_seed_correlation():
    a = draw_raw_bits(1, 2)
    np.testing.assert_array_equal(a, draw_raw_bits(1, 2))  # deterministic
    n = a[0].size * 32
    for x, y in [(a[0], a[1]), (a[1], a[2]), (a[0], a[3]),
                 (a[0], draw_raw_bits(3, 2)[0]),
                 (a[0], draw_raw_bits(1, 3)[0])]:
        match = POPCOUNT[(~(x ^ y)).view(np.uint8)].sum()
        assert abs(match - n / 2) < 6 * np.sqrt(n) / 2, (match, n)


def test_uniform_oo_mapping():
    words = draw_raw_bits(0xABCD, 0x42)
    u = uniform_oo_from_bits(torch.from_numpy(words.astype(np.int64))).numpy()
    assert u.min() > 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 6 * np.sqrt(1 / 12 / u.size)
    assert abs(u.var() - 1 / 12) < 0.001


# The estimator gates of tests/test_tpu_hw.py at its configuration. Both
# gates read one run of 24 steps per sampler (96 spp): the variance gate's
# run length; the mean gates there use 32 steps. One shared run per sampler
# halves the time of the plain CPU render.
EST_CFG = RenderConfig(width=256, height=128, tile_height=32, tile_width=128,
                       tiles_per_step=8, spp_per_step=4)
EST_STEPS = 24


def _contributions(step, state, camera, cfg, accum_of):
    """Per-step sample-mean images (independent 1-step estimates)."""
    prev = np.zeros((3, cfg.padded_height, cfg.padded_width), np.float32)
    out = []
    for _ in range(EST_STEPS):
        state = step(state, camera)
        acc = accum_of(state)
        out.append((acc - prev) / cfg.spp_per_step)
        prev = acc
    return np.stack(out)[:, :, :cfg.height, :cfg.width]


@pytest.fixture(scope="module")
def estimates():
    """(threefry per-step images from the JAX XLA step, tpu_hw per-step
    images from the port's plain step)."""
    jcfg = JRenderConfig.from_json(EST_CFG.to_json())
    jstep = jbuild(jcfg, jcompute(jcfg.sphere_count, jcfg.world_size,
                                  jcfg.scene_seed), backend="xla")
    tf = _contributions(jstep, jinit(jcfg), JCamera.from_config(jcfg).packed(),
                        EST_CFG, lambda s: np.asarray(s.accum[:3]))
    hw_cfg = EST_CFG.replace(rng="tpu_hw")
    step = build_render_step(hw_cfg, compute_spheres(
        hw_cfg.sphere_count, hw_cfg.world_size, hw_cfg.scene_seed),
        backend="torch")
    hw = _contributions(step, init_frame_state(hw_cfg),
                        Camera.from_config(hw_cfg).packed(), hw_cfg,
                        lambda s: s.accum[:3].numpy().copy())
    return tf, hw


def test_tpu_hw_matches_threefry_estimate(estimates):
    tf, hw = estimates
    img_tf, img_hw = tf.mean(0), hw.mean(0)
    assert abs(float(img_hw.mean() - img_tf.mean())) < 0.02
    assert float(np.median(np.abs(img_hw - img_tf))) < 0.05
    assert not np.array_equal(img_hw, img_tf)  # another generator
    assert (img_hw.max(0) > 0).mean() > 0.05  # a lit frame


def test_tpu_hw_variance_matches_threefry(estimates):
    tf, hw = estimates
    var_tf, var_hw = tf.var(axis=0), hw.var(axis=0)
    ratio = (float(np.median(var_hw[var_hw > 1e-6]))
             / float(np.median(var_tf[var_tf > 1e-6])))
    assert 0.8 < ratio < 1.25, ratio
