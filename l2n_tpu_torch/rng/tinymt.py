"""Bit-exact, vectorised TinyMT32 (counterpart of l2n_tpu.rng.tinymt).

TinyMT32 (Saito & Matsumoto): 127 bits of state in four 32-bit words plus
the (mat1, mat2, tmat) parameter triple of the generator. `status` is a
tuple of four word tensors and the parameters broadcast, so one call steps
every per-pixel stream in lockstep. Integer-only, so bit-exact with the C
implementation (tests/golden/tinymt32_vectors.json) and with the CUDA
kernels' per-thread `TinyMTSampler` (csrc/pathtrace.cuh).

Words are int64 tensors holding values in [0, 2**32), as in rng/threefry.py:
every left shift and sum is masked back to 32 bits.
"""

from __future__ import annotations

import torch

from l2n_tpu_torch.rng.threefry import MASK32, as_words, uniform_oo_from_bits

SH0 = 1
SH1 = 10
SH8 = 8
MASK = 0x7FFFFFFF
MIN_LOOP = 8
PRE_LOOP = 8

# The canonical parameter triple of upstream TinyMT's check program.
DEFAULT_MAT1 = 0x8F7011EE
DEFAULT_MAT2 = 0xFC78FF1F
DEFAULT_TMAT = 0x3793FDFF

State = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
Params = tuple


def _neg_mask(bit):
    """-(int32)(y & 1) as a 32-bit word: all ones when the bit is set."""
    return (-bit) & MASK32


def next_state(status: State, params: Params) -> State:
    """State transition (tinymt32.hpp next_state)."""
    s0, s1, s2, s3 = status
    mat1, mat2, _ = params
    y = s3
    x = (s0 & MASK) ^ s1 ^ s2
    x = x ^ ((x << SH0) & MASK32)
    y = y ^ (y >> SH0) ^ x
    n2 = x ^ ((y << SH1) & MASK32)
    m = _neg_mask(y & 1)
    return (s1, s2 ^ (m & mat1), n2 ^ (m & mat2), y)


def temper(status: State, params: Params):
    """Output function (tinymt32.hpp temper)."""
    s0, _, s2, s3 = status
    tmat = params[2]
    t1 = (s0 + (s2 >> SH8)) & MASK32
    t0 = s3 ^ t1
    return t0 ^ (_neg_mask(t1 & 1) & tmat)


def temper_conv_open(status: State, params: Params) -> torch.Tensor:
    """The tempered word as a float32 in (1, 2) (0x3f800001 exponent trick)."""
    u = (temper(status, params) >> 9) | 0x3F800001
    return u.to(torch.int32).view(torch.float32)


def generate_uint32(status: State, params: Params):
    status = next_state(status, params)
    return temper(status, params), status


def generate_float_oo(status: State, params: Params):
    """floatOO: a float32 strictly inside (0, 1) and the new state. The JAX
    package computes temper_conv_open(...) - 1; that is the 0x3f800001
    float minus 1, which uniform_oo_from_bits computes directly."""
    status = next_state(status, params)
    return uniform_oo_from_bits(temper(status, params)), status


def init(seed, params: Params | None = None) -> tuple[State, Params]:
    """Seed-initialise states for a tensor of 32-bit seeds (tinymt32.cpp
    tinymt32_init: 8-step key derivation, period certification, 8 warm-up
    steps). `params` defaults to the canonical triple."""
    if params is None:
        params = (DEFAULT_MAT1, DEFAULT_MAT2, DEFAULT_TMAT)
    seed = as_words(torch.as_tensor(seed))
    mat1, mat2, tmat = (as_words(p) for p in params)
    st = [seed] + [torch.broadcast_to(torch.as_tensor(p), seed.shape)
                   .to(seed.device) for p in (mat1, mat2, tmat)]
    for i in range(1, MIN_LOOP):
        prev = st[(i - 1) & 3]
        st[i & 3] = st[i & 3] ^ (
            (i + 1812433253 * (prev ^ (prev >> 30))) & MASK32)
    # Period certification: an all-zero (masked) state becomes 'TINY'.
    zero = (((st[0] & MASK) == 0) & (st[1] == 0) & (st[2] == 0)
            & (st[3] == 0))
    for j, ch in enumerate("TINY"):
        st[j] = torch.where(zero, torch.full_like(st[j], ord(ch)), st[j])
    status: State = (st[0], st[1], st[2], st[3])
    for _ in range(PRE_LOOP):
        status = next_state(status, (mat1, mat2, tmat))
    return status, (mat1, mat2, tmat)


def pack(status: State, params: Params) -> torch.Tensor:
    """The reference's 8-word struct layout {status[4], mat1, mat2, tmat,
    pad} along a new last axis."""
    shape = status[0].shape
    dev = status[0].device
    words = list(status) + [torch.broadcast_to(torch.as_tensor(p), shape)
                            .to(dev) for p in params]
    words.append(torch.zeros_like(status[0]))
    return torch.stack(words, dim=-1)


def unpack(arr: torch.Tensor) -> tuple[State, Params]:
    s = tuple(arr[..., i] for i in range(4))
    p = tuple(arr[..., 4 + i] for i in range(3))
    return s, p  # type: ignore[return-value]
