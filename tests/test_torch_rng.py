"""l2n_tpu_torch RNG against l2n_tpu's: threefry words, their float
conversion and the sampler's draw sequences are bit-exact on inputs made
from a numpy seed."""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from l2n_tpu.rng import sampler as jsampler
from l2n_tpu.rng import threefry as jthreefry
from l2n_tpu_torch.rng import sampler as tsampler
from l2n_tpu_torch.rng import threefry as tthreefry


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


N = 100_000


@pytest.fixture(scope="module")
def words():
    gen = np.random.Generator(np.random.PCG64(7))
    return tuple(gen.integers(0, 2**32, N, dtype=np.uint32) for _ in range(4))


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def test_threefry2x32_bit_exact(words):
    k0, k1, x0, x1 = words
    j0, j1 = jthreefry.threefry2x32(*(jnp.asarray(w) for w in words))
    t0, t1 = tthreefry.threefry2x32(*(_t(w) for w in words))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


def test_threefry2x32_scalar_key_bit_exact(words):
    _, _, x0, x1 = words
    j0, j1 = jthreefry.threefry2x32(jnp.uint32(42), jnp.uint32(7),
                                    jnp.asarray(x0), jnp.asarray(x1))
    t0, t1 = tthreefry.threefry2x32(42, 7, _t(x0), _t(x1))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


def test_uniform_oo_from_bits_bit_exact(words):
    bits = np.concatenate([words[0], np.array([0, 1, 511, 512, 2**32 - 1],
                                              np.uint32)])
    j = np.asarray(jthreefry.uniform_oo_from_bits(jnp.asarray(bits)))
    t = tthreefry.uniform_oo_from_bits(_t(bits)).numpy()
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    assert (t > 0).all() and (t < 1).all()


def test_sample_draws_bit_exact(words):
    pix = words[0][:4096]
    samp = words[1][:4096] % 1000
    j = jthreefry.sample_draws(3, 1, jnp.asarray(pix), jnp.asarray(samp), 3)
    t = tthreefry.sample_draws(3, 1, _t(pix), _t(samp), 3)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("seed,stream", [(0, 0), (12345, 3)])
def test_sampler_sequence_bit_exact(words, seed, stream):
    """draw2, draw1, draw1, draw2, draw1: the lockstep tracer's pattern,
    including the cached second half of a draw1 pair."""
    pix = words[2][:8192]
    samp = (words[3][:8192] % 4096).astype(np.uint32)
    mp = jsampler.max_pairs_per_sample(2)
    js = jsampler.ThreefrySampler(seed, stream, jnp.asarray(pix),
                                  jnp.asarray(samp), mp)
    ts = tsampler.ThreefrySampler(seed, stream, _t(pix), _t(samp), mp)
    for call in ("draw2", "draw1", "draw1", "draw2", "draw1"):
        j = getattr(js, call)()
        t = getattr(ts, call)()
        j = j if isinstance(j, tuple) else (j,)
        t = t if isinstance(t, tuple) else (t,)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_sampler_budget_enforced():
    ts = tsampler.ThreefrySampler(0, 0, torch.zeros(4, dtype=torch.int64),
                                  torch.zeros(4, dtype=torch.int64), 2)
    ts.draw2()
    ts.draw2()
    with pytest.raises(RuntimeError, match="budget"):
        ts.draw2()


@pytest.mark.parametrize("max_bounces,nee,fog", [
    (1, False, False), (2, False, False), (3, False, False),
    (2, True, False), (2, False, True), (4, True, True)])
def test_max_pairs_per_sample(max_bounces, nee, fog):
    assert (tsampler.max_pairs_per_sample(max_bounces, nee, fog)
            == jsampler.max_pairs_per_sample(max_bounces, nee, fog))
