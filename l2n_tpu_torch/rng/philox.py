"""Philox4x32-10, the port's `rng="tpu_hw"` generator.

The JAX package's `tpu_hw` mode draws from the TPU core's hardware PRNG
(l2n_tpu/ops/kernels/common.py::TpuHwSampler, seeded per tile and sample
by `seed_tpu_hw`). An H100 has no per-core hardware generator, so on the
card this mode is Philox4x32-10 (Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3", SC'11), a counter-based generator written into the
kernels (csrc/pathtrace.cuh). It is not a hardware stream: the mode keeps
its config value so that a config written for the JAX package runs
unchanged, and it is held, as `tpu_hw` always was, to statistical parity
with threefry, not to bit parity.

Addressing, like the threefry sampler's: key = (seed, stream), counter =
(pixel_index, sample_index, pair >> 1, 0); pair k takes words 2 (k & 1)
and 2 (k & 1) + 1 of its block, so one block serves two pairs.

Words are int64 tensors holding values in [0, 2**32), as in rng/threefry.py.
A 32 x 32-bit product needs 64 bits and overflows signed int64, so
`mulhilo32` builds it from 16-bit halves of one factor: every partial
product stays below 2**48.
"""

from __future__ import annotations

import torch

from l2n_tpu_torch.rng.threefry import MASK32, as_words

# Multipliers and Weyl key increments of Philox4x32 (Random123; the same
# constants as torch's ATen/core/PhiloxRNGEngine.h).
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10


def mulhilo32(a: int, b):
    """(hi, lo) 32-bit words of the 64-bit product of the constant `a` and
    the words `b` (an int64 tensor in [0, 2**32))."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    p_lo = a * b_lo  # < 2**48
    p_hi = a * b_hi  # < 2**48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & MASK32
    return hi, lo


def philox4x32(k0, k1, c0, c1, c2, c3):
    """One Philox4x32-10 block: ROUNDS rounds, the key bumped between
    rounds. Keys and counters are Python ints or integer tensors
    (broadcastable); returns four int64 tensors of words."""
    k0, k1 = as_words(k0), as_words(k1)
    c = [as_words(x) for x in (c0, c1, c2, c3)]
    shape = torch.broadcast_shapes(*(x.shape for x in c
                                     if isinstance(x, torch.Tensor)))
    dev = next((x.device for x in c if isinstance(x, torch.Tensor)), None)
    c = [x if isinstance(x, torch.Tensor)
         else torch.full(shape, x, dtype=torch.int64, device=dev) for x in c]
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = mulhilo32(M0, c[0])
        hi1, lo1 = mulhilo32(M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c
