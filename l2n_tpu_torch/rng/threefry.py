"""Counter-based threefry-2x32 RNG, bit-exact with l2n_tpu.rng.threefry.

Draw ``(u0, u1) = threefry(key=(seed, stream), counter=(pixel,
sample*K + pair))``: independent per-pixel streams, reproducible across
devices and backends, and resumable (the "state" is the per-pixel sample
count already kept in the accumulation buffer).

torch has no uint32 arithmetic (`+`, `<<` and `>>` raise for
torch.uint32), so 32-bit words are carried as int64 tensors holding values
in [0, 2**32) and every sum is masked with `& MASK32`. Shifts of such a
word by at most 31 bits stay inside int64, and `>>` of a non-negative int64
is the logical shift. The CUDA kernel (csrc/sphere_pt.cuh) computes the same
function on plain uint32_t.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# Rotation schedule for Threefry-2x32 (8 distinct rotations, cycled).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
# Key-schedule parity constant for the 2x32 variant.
_PARITY = 0x1BD11BDA


def as_words(x):
    """A Python int or an integer tensor as 32-bit words: an int stays an
    int in [0, 2**32), a tensor becomes int64 in [0, 2**32) (an int32 tensor
    is read as its unsigned bit pattern)."""
    if isinstance(x, int):
        return x & MASK32
    return x.to(torch.int64) & MASK32


def to_int32(words: torch.Tensor) -> torch.Tensor:
    """Words held in int64 as int32 tensors of the same bit patterns (how
    the state planes store them; `as_words` reads them back)."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """One Threefry-2x32 block (20 rounds, key injection every 4 rounds).

    Arguments are Python ints or integer tensors (broadcastable); returns
    two int64 tensors of words in [0, 2**32).
    """
    k0, k1 = as_words(k0), as_words(k1)
    x0, x1 = as_words(x0), as_words(x1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)

    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for block in range(5):
        for r in range(4):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, _ROTATIONS[(block % 2) * 4 + r])
            x1 = x1 ^ x0
        inj = block + 1
        x0 = (x0 + ks[inj % 3]) & MASK32
        x1 = (x1 + ks[(inj + 1) % 3] + inj) & MASK32
    return x0, x1


def uniform_oo_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words -> float32 strictly inside (0, 1): the top 23 bits as a
    mantissa with the lowest mantissa bit forced to 1 (0x3f800001), a float
    in (1, 2), minus 1. The word fits in int32, whose bits are viewed as
    float32."""
    u = (as_words(bits) >> 9) | 0x3F800001
    return u.to(torch.int32).view(torch.float32) - 1.0


def sample_draws(seed: int, stream: int, pixel_index: torch.Tensor,
                 sample_index: torch.Tensor, n_pairs: int) -> list[torch.Tensor]:
    """`2 * n_pairs` float32 draws in (0, 1) per element:
    key = (seed, stream), counter = (pixel, sample * n_pairs + pair)."""
    base = (as_words(sample_index) * n_pairs) & MASK32
    draws: list[torch.Tensor] = []
    for pair in range(n_pairs):
        b0, b1 = threefry2x32(seed, stream, pixel_index,
                              (base + pair) & MASK32)
        draws.append(uniform_oo_from_bits(b0))
        draws.append(uniform_oo_from_bits(b1))
    return draws
