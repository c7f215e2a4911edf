"""Combined Tausworthe + LCG generator (counterpart of
l2n_tpu.rng.tauslcg; GPU Gems 3 ch. 37): three Tausworthe steps XOR'd with
one LCG step over a four-word state per pixel, stepped in lockstep.

Words are int64 tensors holding values in [0, 2**32), as in rng/threefry.py.
The float conversion rounds the 32-bit word to the nearest float32: torch
converts int64 to float32 correctly rounded, as XLA and CUDA's
`__uint2float_rn` (the kernels' `TausLCGSampler`) do; above 2**24 the
conversion rounds, and a word within 128 of 2**32 becomes exactly 1.0.
"""

from __future__ import annotations

import torch

from l2n_tpu_torch.rng.philox import mulhilo32
from l2n_tpu_torch.rng.threefry import MASK32, as_words

State = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

RCP_2_32 = 2.3283064365387e-10  # rand_TausLCG.cs.glsl:23, as a float32


def taus_step(z, s1: int, s2: int, s3: int, m: int):
    b = (((z << s1) & MASK32) ^ z) >> s2
    return (((z & m) << s3) & MASK32) ^ b


def lcg_step(z, a: int, c: int):
    return (a * z + c) & MASK32


def rand1(state: State):
    """One float32 in [0, 1] and the new state (rand1_TausLCG)."""
    x, y, z, w = state
    x = taus_step(x, 13, 19, 12, 4294967294)
    y = taus_step(y, 2, 25, 4, 4294967288)
    z = taus_step(z, 3, 11, 17, 4294967280)
    w = lcg_step(w, 1664525, 1013904223)
    word = (x ^ y ^ z ^ w).to(torch.float32)
    rcp = torch.tensor(RCP_2_32, dtype=torch.float32, device=word.device)
    return rcp * word, (x, y, z, w)


def init(seed) -> State:
    """A four-word state from 32-bit seeds: components spread with distinct
    odd constants and forced >= 128 (the Tausworthe steps need z > 2**s2)."""
    seed = as_words(torch.as_tensor(seed))
    # The products of two 32-bit words overflow int64: take the low word of
    # rng/philox.mulhilo32's exact product.
    x = mulhilo32(0x9E3779B9, seed)[1] | 128
    y = mulhilo32(0x85EBCA6B, seed ^ 0xDEADBEEF)[1] | 128
    z = mulhilo32(0xC2B2AE35, (seed + 0x41C64E6D) & MASK32)[1] | 128
    w = seed ^ 0x6C078965
    return (x, y, z, w)
