"""The TinyMT32 precomputed parameter table, 65,536 independent streams
(counterpart of l2n_tpu.rng.tinymt_params).

The reference ships 65,536 (mat1, mat2, tmat) sets of dynamically created
TinyMT generators, and each pixel's stream draws one at start-up. The table
ships as `tinymt32dc_params.npz` beside this module (a byte-for-byte copy
of the JAX package's file; the port reads its own). `cpp_mt19937`
reproduces std::mt19937's output stream, so the per-pixel (seed, parameter)
assignment is the reference's (rng/state.py).
"""

from __future__ import annotations

import pathlib

import numpy as np

PARAMS_NPZ = pathlib.Path(__file__).with_name("tinymt32dc_params.npz")
TABLE_SIZE = 65536


def load_param_table() -> np.ndarray:
    """The shipped (65536, 3) uint32 table."""
    with np.load(PARAMS_NPZ) as z:
        return z["params"]


def cpp_mt19937(n: int, seed: int = 5489) -> np.ndarray:
    """The first `n` outputs of std::mt19937 seeded with `seed`, bit-exact
    (init_genrand seeding, then the MT19937 twist and temper), as uint32."""
    with np.errstate(over="ignore"):
        mt = np.empty(624, np.uint32)
        mt[0] = np.uint32(seed)
        for i in range(1, 624):
            mt[i] = (np.uint32(1812433253)
                     * (mt[i - 1] ^ (mt[i - 1] >> np.uint32(30)))
                     + np.uint32(i))

        out = np.empty(n, np.uint32)
        produced = 0
        upper = np.uint32(0x80000000)
        lower = np.uint32(0x7FFFFFFF)
        mag = np.array([0, 0x9908B0DF], np.uint32)
        one = np.uint32(1)
        while produced < n:
            # One twist of the 624-word block: mt[i] = mt[(i + 397) % 624]
            # ^ f(mt[i], mt[i + 1]), where sources past the wrap point are
            # already twisted and the last word pairs with the new mt[0].
            new = np.empty_like(mt)
            y = (mt[:623] & upper) | (mt[1:624] & lower)
            xa = (y >> one) ^ mag[y & one]
            new[:227] = mt[397:624] ^ xa[:227]
            # The middle segment reads its own earlier outputs (new[i-227]),
            # so it splits where that dependency starts (i = 454).
            new[227:454] = new[0:227] ^ xa[227:454]
            new[454:623] = new[227:396] ^ xa[454:623]
            y_last = (mt[623] & upper) | (new[0] & lower)
            new[623] = new[396] ^ (y_last >> one) ^ mag[y_last & one]
            mt = new

            take = min(624, n - produced)
            z = mt.copy()
            z ^= z >> np.uint32(11)
            z ^= (z << np.uint32(7)) & np.uint32(0x9D2C5680)
            z ^= (z << np.uint32(15)) & np.uint32(0xEFC60000)
            z ^= z >> np.uint32(18)
            out[produced:produced + take] = z[:take]
            produced += take
    return out
