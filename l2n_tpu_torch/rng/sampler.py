"""Sampler: the path tracer's only interface to randomness.

Counterpart of l2n_tpu.rng.sampler for the slice's one sampler, threefry.
Draws are addressed, not consumed: pair k of sample s of pixel p is
threefry(key=(seed, stream), counter=(p, s * max_pairs + k)). The lockstep
plain path draws every pair for every lane; the CUDA kernel's per-thread
sampler (csrc/sphere_pt.cuh) replays the same call sequence along its own
path and so reads the same addresses. `ThreefrySampler.resumed` picks a
stream up in the middle of a sample (the wavefront step's pass B).
"""

from __future__ import annotations

import torch

from l2n_tpu_torch.rng.threefry import (
    MASK32,
    as_words,
    threefry2x32,
    uniform_oo_from_bits,
)


class ThreefrySampler:
    """Counter-based sampler over lane tensors of pixel and sample indices.

    `max_pairs` bounds the pairs drawn per sample so consecutive samples
    never collide. `draw1` caches the unused half of a pair, so two draw1
    call sites (e.g. per-bounce Russian roulette) share one block.
    """

    def __init__(self, seed: int, stream: int, pixel_index: torch.Tensor,
                 sample_index: torch.Tensor, max_pairs: int):
        self._k0 = as_words(seed)
        self._k1 = as_words(stream)
        self._pixel = as_words(pixel_index)
        self._base = (as_words(sample_index) * max_pairs) & MASK32
        self._max_pairs = max_pairs
        self._pair = 0
        self._spare = None

    def draw2(self):
        if self._pair >= self._max_pairs:
            raise RuntimeError(
                f"sampler budget exceeded: {self._pair + 1} pairs > max_pairs="
                f"{self._max_pairs}")
        b0, b1 = threefry2x32(self._k0, self._k1, self._pixel,
                              (self._base + self._pair) & MASK32)
        self._pair += 1
        return uniform_oo_from_bits(b0), uniform_oo_from_bits(b1)

    def draw1(self):
        if self._spare is not None:
            u, self._spare = self._spare, None
            return u
        u, self._spare = self.draw2()
        return u

    @classmethod
    def resumed(cls, seed: int, stream: int, pixel_index: torch.Tensor,
                sample_index: torch.Tensor, max_pairs: int, next_pair: int,
                has_spare: bool) -> "ThreefrySampler":
        """A sampler in the middle of a sample: the next fresh pair is
        `next_pair`, and with `has_spare` the unused second word of pair
        `next_pair - 1` is pending, regenerated (draws are addressed, so
        evaluating a pair again is exact). The wavefront step's pass B
        resumes each path's stream where pass A stopped."""
        s = cls(seed, stream, pixel_index, sample_index, max_pairs)
        if has_spare:
            s._pair = next_pair - 1
            _, s._spare = s.draw2()
        else:
            s._pair = next_pair
        return s

    @property
    def draw_position(self) -> tuple[int, bool]:
        """(next fresh pair, spare word pending): Python values, since the
        lockstep tracer's draw pattern does not depend on the data."""
        return self._pair, self._spare is not None


def max_pairs_per_sample(max_bounces: int, nee: bool = False,
                         fog: bool = False) -> int:
    """Static threefry draw budget: 1 pair of pixel jitter + per bounce one
    hemisphere pair and one RR pair (the RR draw wastes its sibling), with
    one spare pair for AOV modes. NEE adds a light pick plus a surface-point
    pair per bounce; fog one collision draw per path segment. The formula is
    l2n_tpu's: the budget fixes the counter layout, so both packages must
    agree on it even for options this slice does not render."""
    return (2 + (4 if nee else 2) * max_bounces
            + (max_bounces + 1 if fog else 0))
