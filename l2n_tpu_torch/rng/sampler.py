"""Sampler: the path tracer's only interface to randomness (counterpart of
l2n_tpu.rng.sampler).

`draw2(mask=None)` / `draw1(mask=None)` return float32 lane tensors in
(0, 1) (TausLCG: [0, 1]). Four samplers, one per `RenderConfig.rng`:

  * threefry (`ThreefrySampler`) and tpu_hw (`PhiloxSampler`) are counter
    based: draws are addressed, not consumed, and masks are ignored. Pair k
    of sample s of pixel p is threefry(key=(seed, stream), counter=(p,
    s * max_pairs + k)), or words 2 (k & 1), 2 (k & 1) + 1 of Philox
    block (p, s, k >> 1, 0) (rng/philox.py). The lockstep plain path draws
    every pair for every lane; the CUDA kernels' per-thread samplers
    (csrc/pathtrace.cuh) replay the same call sequence along their own path
    and so read the same addresses. `resumed` picks a stream up in the
    middle of a sample (the wavefront step's pass B).
  * tinymt (`TinyMTSampler`) and tauslcg (`TausLCGSampler`) step per-pixel
    states, and only in the lanes that `mask` selects: the reference's
    divergent shader draws only where its control flow reaches a draw, and
    the lockstep tracer reproduces that by masking. A draw2 is two draw1s.
    The plain step builds them over the scheduled pixels' states alone
    (ops/kernels/common.py), so pixels outside the step never draw.
"""

from __future__ import annotations

import torch

from l2n_tpu_torch.rng import tauslcg, tinymt
from l2n_tpu_torch.rng.philox import philox4x32
from l2n_tpu_torch.rng.threefry import (
    MASK32,
    as_words,
    threefry2x32,
    uniform_oo_from_bits,
)


class _CounterSampler:
    """Shared by the counter-based samplers over lane tensors of pixel and
    sample indices. `max_pairs` bounds the pairs drawn per sample so
    consecutive samples never collide. `draw1` caches the unused half of a
    pair, so two draw1 call sites (e.g. per-bounce Russian roulette) share
    one pair."""

    def __init__(self, seed: int, stream: int, pixel_index: torch.Tensor,
                 sample_index: torch.Tensor, max_pairs: int):
        self._k0 = as_words(seed)
        self._k1 = as_words(stream)
        self._pixel = as_words(pixel_index)
        self._sample = as_words(sample_index)
        self._max_pairs = max_pairs
        self._pair = 0
        self._spare = None

    def _pair_words(self, pair: int):
        raise NotImplementedError

    def draw2(self, mask=None):
        if self._pair >= self._max_pairs:
            raise RuntimeError(
                f"sampler budget exceeded: {self._pair + 1} pairs > max_pairs="
                f"{self._max_pairs}")
        b0, b1 = self._pair_words(self._pair)
        self._pair += 1
        return uniform_oo_from_bits(b0), uniform_oo_from_bits(b1)

    def draw1(self, mask=None):
        if self._spare is not None:
            u, self._spare = self._spare, None
            return u
        u, self._spare = self.draw2()
        return u

    def final_state(self):
        return None

    @classmethod
    def resumed(cls, seed: int, stream: int, pixel_index: torch.Tensor,
                sample_index: torch.Tensor, max_pairs: int, next_pair: int,
                has_spare: bool):
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


class ThreefrySampler(_CounterSampler):
    """rng="threefry": pair k is threefry(key=(seed, stream),
    counter=(pixel, sample * max_pairs + k))."""

    def _pair_words(self, pair: int):
        base = (self._sample * self._max_pairs + pair) & MASK32
        return threefry2x32(self._k0, self._k1, self._pixel, base)


class PhiloxSampler(_CounterSampler):
    """rng="tpu_hw" on the card: pair k is words 2 (k & 1) and
    2 (k & 1) + 1 of Philox4x32-10(key=(seed, stream), counter=(pixel,
    sample, k >> 1, 0)). Not the TPU's hardware stream (rng/philox.py).
    The last block is kept, so pairs 2j and 2j + 1 evaluate it once."""

    _block = (None, None)  # (block index, its four words)

    def _pair_words(self, pair: int):
        if self._block[0] != pair >> 1:
            self._block = (pair >> 1, philox4x32(
                self._k0, self._k1, self._pixel, self._sample, pair >> 1, 0))
        w = 2 * (pair & 1)
        return self._block[1][w], self._block[1][w + 1]


def _masked(new, old, mask):
    if mask is None:
        return new
    return tuple(torch.where(mask, n, o) for n, o in zip(new, old))


class _StatefulSampler:
    """Per-pixel states stepped by `_step(state) -> (value, state)`, only
    in the lanes `mask` selects; unselected lanes read 0.5."""

    def _step(self, state):
        raise NotImplementedError

    def draw2(self, mask=None):
        return self.draw1(mask), self.draw1(mask)

    def draw1(self, mask=None):
        value, new = self._step(self._state)
        self._state = _masked(new, self._state, mask)
        if mask is not None:
            value = torch.where(mask, value, torch.full_like(value, 0.5))
        return value

    def final_state(self):
        return self._state


class TinyMTSampler(_StatefulSampler):
    """rng="tinymt": per-pixel TinyMT32 streams, `status` four word tensors
    and `params` the (mat1, mat2, tmat) words."""

    def __init__(self, status: tinymt.State, params: tinymt.Params):
        self._state = tuple(status)
        self._params = tuple(params)

    def _step(self, state):
        return tinymt.generate_float_oo(state, self._params)


class TausLCGSampler(_StatefulSampler):
    """rng="tauslcg": per-pixel four-word Tausworthe + LCG states."""

    def __init__(self, state: tauslcg.State):
        self._state = tuple(state)

    def _step(self, state):
        return tauslcg.rand1(state)


# RenderConfig.rng -> the counter-based sampler class of that mode.
COUNTER_SAMPLERS = {"threefry": ThreefrySampler, "tpu_hw": PhiloxSampler}


def max_pairs_per_sample(max_bounces: int, nee: bool = False,
                         fog: bool = False) -> int:
    """Static draw budget of the counter-based samplers: 1 pair of pixel
    jitter + per bounce one hemisphere pair and one RR pair (the RR draw
    wastes its sibling), with one spare pair for AOV modes. NEE adds a
    light pick plus a surface-point pair per bounce; fog one collision draw
    per path segment. The formula is l2n_tpu's: the budget fixes the
    counter layout, so both packages must agree on it even for options this
    slice does not render."""
    return (2 + (4 if nee else 2) * max_bounces
            + (max_bounces + 1 if fog else 0))


def config_max_pairs(cfg) -> int:
    """max_pairs_per_sample of a RenderConfig: NEE's draws and fog's
    collision draws, whatever the AOV (the JAX package budgets them so)."""
    return max_pairs_per_sample(cfg.max_bounces, cfg.nee,
                                cfg.fog_density > 0.0)
