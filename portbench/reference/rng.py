"""Philox4x32-10, the sampler of `rng="tpu_hw"` configurations, in plain
torch (frozen copy; PROVENANCE.md).

Addressing: key = (seed, stream), counter = (pixel_index, sample_index,
pair >> 1, 0); pair k takes words 2 (k & 1) and 2 (k & 1) + 1 of its
block. A draw1 takes the first word of a fresh pair and keeps the second
for the next draw1. Words are int64 tensors in [0, 2**32); a 32 x 32-bit
product is built from 16-bit halves so that it never overflows int64.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10


def as_words(x):
    if isinstance(x, int):
        return x & MASK32
    return x.to(torch.int64) & MASK32


def mulhilo32(a: int, b):
    b_lo, b_hi = b & 0xFFFF, b >> 16
    p_lo = a * b_lo
    p_hi = a * b_hi
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & MASK32
    return hi, lo


def philox4x32(k0, k1, c0, c1, c2, c3):
    """One Philox4x32-10 block; returns four int64 word tensors."""
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


def uniform_oo(bits: torch.Tensor) -> torch.Tensor:
    """A word as a float32 strictly inside (0, 1): the top 23 bits as the
    mantissa of a float in (1, 2) with its lowest bit set, minus 1."""
    u = (as_words(bits) >> 9) | 0x3F800001
    return u.to(torch.int32).view(torch.float32) - 1.0


class PhiloxSampler:
    """The draws of one sample over lane tensors of pixel and sample
    indices, in `dtype` (float32; the control takes a lower precision)."""

    def __init__(self, seed: int, stream: int, pixel_index: torch.Tensor,
                 sample_index: torch.Tensor, max_pairs: int,
                 dtype=torch.float32):
        self._k0, self._k1 = as_words(seed), as_words(stream)
        self._pixel = as_words(pixel_index)
        self._sample = as_words(sample_index)
        self._max_pairs = max_pairs
        self._dtype = dtype
        self._pair = 0
        self._spare = None
        self._block = (None, None)

    def _pair_words(self, pair: int):
        if self._block[0] != pair >> 1:
            self._block = (pair >> 1, philox4x32(
                self._k0, self._k1, self._pixel, self._sample, pair >> 1, 0))
        w = 2 * (pair & 1)
        return self._block[1][w], self._block[1][w + 1]

    def draw2(self):
        if self._pair >= self._max_pairs:
            raise RuntimeError(f"sampler budget exceeded: pair {self._pair} "
                               f">= max_pairs {self._max_pairs}")
        b0, b1 = self._pair_words(self._pair)
        self._pair += 1
        return (uniform_oo(b0).to(self._dtype),
                uniform_oo(b1).to(self._dtype))

    def draw1(self):
        if self._spare is not None:
            u, self._spare = self._spare, None
            return u
        u, self._spare = self.draw2()
        return u


def max_pairs_per_sample(max_bounces: int, nee: bool = False) -> int:
    """The draw budget of a sample without fog: the pixel jitter, then a
    hemisphere pair and a roulette pair per bounce, and under NEE a light
    pick and a direction pair more per bounce: the port's budget. Philox
    counts samples in a counter word of their own, so here it only bounds
    the pairs a sample may draw."""
    return 2 + (4 if nee else 2) * max_bounces
