"""Per-pixel stateful RNG initialisation for the TinyMT and TausLCG parity
modes (counterpart of l2n_tpu.rng.state).

One state per pixel. By default the TinyMT mode reproduces the reference's
scheme exactly: a default-constructed std::mt19937 (rng/tinymt_params.
cpp_mt19937) draws, per pixel in row-major order, a 32-bit seed and then an
index into the 65,536-entry parameter table, and tinymt32_init builds the
state from (seed, mat1, mat2, tmat). `param_table="canonical"` keeps every
pixel on the canonical TinyMT triple with seeds from a numpy MT19937 (a
cheap deviation the JAX package keeps for tests).

The draws and the table lookup run on the host in numpy; the key
derivation and warm-up steps (rng/tinymt.init) run on host torch tensors.
Every function returns int64 word tensors on the CPU, shaped
(height, width).

The layout of the state planes that a frame carries and the kernels read
lives here too: `STATE_PLANES` counts them, `init_state_planes` builds
them and `sampler_from_planes` splits them into a sampler.
"""

from __future__ import annotations

import numpy as np
import torch

from l2n_tpu_torch.rng import tauslcg, tinymt
from l2n_tpu_torch.rng.sampler import TausLCGSampler, TinyMTSampler
from l2n_tpu_torch.rng.tinymt_params import cpp_mt19937, load_param_table

# Per-pixel state planes of the stateful modes, in the order of
# csrc/pathtrace.cuh's TinyMTSampler / TausLCGSampler: tinymt {s0..s3,
# mat1, mat2, tmat, pad}, tauslcg {s0..s3}. A sampler's final_state() is
# the first four planes.
STATE_PLANES = {"tinymt": 8, "tauslcg": 4}


def _words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def mt19937_seeds(n: int, seed: int = 0) -> np.ndarray:
    """n uint32 seeds from numpy's Mersenne Twister."""
    gen = np.random.Generator(np.random.MT19937(seed))
    return gen.integers(0, 2**32, size=n, dtype=np.uint32)


def init_tinymt_states(height: int, width: int, seed: int = 0,
                       param_table: str = "reference"):
    """(status, params): one TinyMT32 state per pixel.

    param_table: "reference" (default), the shipped table with the
    reference's per-pixel (seed, parameter) assignment (`seed` 0 maps to
    std::mt19937's default seed 5489); "canonical", the canonical triple
    (Python ints) with numpy MT19937 seeds.
    """
    if param_table == "canonical":
        gen = np.random.Generator(np.random.MT19937(seed))
        seeds = gen.integers(0, 2**32, size=(height, width), dtype=np.uint32)
        return tinymt.init(_words(seeds), None)
    if param_table != "reference":
        raise ValueError(f"param_table={param_table!r}: expected "
                         "'reference' or 'canonical'")
    table = load_param_table()
    n = height * width
    draws = cpp_mt19937(2 * n, 5489 if seed == 0 else seed)
    seeds = draws[0::2].reshape(height, width)
    idx = (draws[1::2] % np.uint32(table.shape[0])).reshape(height, width)
    params = tuple(_words(table[idx, i]) for i in range(3))
    return tinymt.init(_words(seeds), params)


def init_tauslcg_states(height: int, width: int, seed: int = 0):
    """One TausLCG four-word state per pixel."""
    seeds = mt19937_seeds(height * width, seed).reshape(height, width)
    return tauslcg.init(_words(seeds))


def init_state_planes(rng: str, height: int, width: int, seed: int = 0):
    """(STATE_PLANES[rng], height, width) int64 words of mode `rng`'s
    per-pixel states; None for the counter-based modes."""
    if rng == "tinymt":
        status, params = init_tinymt_states(height, width, seed)
        words = list(status) + [
            torch.broadcast_to(torch.as_tensor(p), (height, width))
            for p in params]
        words.append(torch.zeros((height, width), dtype=torch.int64))
    elif rng == "tauslcg":
        words = list(init_tauslcg_states(height, width, seed))
    else:
        return None
    return torch.stack(words)


def sampler_from_planes(rng: str, words):
    """The sampler of stateful mode `rng` over its STATE_PLANES[rng] word
    tensors, in plane order."""
    if rng == "tinymt":
        return TinyMTSampler(words[:4], words[4:7])
    return TausLCGSampler(words[:4])
