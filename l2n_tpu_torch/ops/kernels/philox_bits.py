"""Raw Philox4x32-10 bits: the kernel behind the rng="tpu_hw" statistical
gates, and its plain torch version (counterpart of the raw-bits Pallas
kernel in tests/test_tpu_hw.py::draw_raw_bits).

`philox_bits(seeds, k, h)` returns (k, h, 128) 32-bit words as int32 bit
patterns from a (2,) int32 seed tensor: draw i of lane p = row * 128 +
column is word i & 3 of Philox4x32-10 at key (seeds[0], seeds[1]), counter
(p, 0, i >> 2, 0) — the layout of the samplers' draws (rng/sampler.py::
PhiloxSampler, pixel p, sample 0, pair i >> 1). On a CUDA tensor it
launches csrc/philox_bits.cu or raises; on a CPU tensor it runs
`philox_bits_plain`.
"""

from __future__ import annotations

import torch

from l2n_tpu_torch.ops.kernels.common import check_tensor, launch_raw
from l2n_tpu_torch.rng.philox import philox4x32
from l2n_tpu_torch.rng.threefry import as_words, to_int32

LANES = 128


def _check(seeds, k: int, h: int) -> None:
    dev = seeds.device if isinstance(seeds, torch.Tensor) else None
    check_tensor("seeds", seeds, torch.int32, (2,), dev)
    if k <= 0 or h <= 0:
        raise ValueError("philox_bits: k and h must be positive")


def philox_bits(seeds: torch.Tensor, k: int = 4, h: int = 256) -> torch.Tensor:
    """(k, h, 128) int32 words on the device of `seeds` (see module doc)."""
    _check(seeds, k, h)
    if seeds.device.type == "cpu":
        return philox_bits_plain(seeds, k, h)
    if seeds.device.type != "cuda":
        raise ValueError(f"philox_bits: no kernel for device {seeds.device}")
    out = torch.empty((k, h, LANES), dtype=torch.int32, device=seeds.device)
    launch_raw("philox_bits", seeds.device, seeds, k, h, out)
    return out


def philox_bits_plain(seeds: torch.Tensor, k: int = 4,
                      h: int = 256) -> torch.Tensor:
    """The plain torch version of `philox_bits`, on `seeds`' device."""
    _check(seeds, k, h)
    k0, k1 = (int(w) for w in as_words(seeds).tolist())
    lane = torch.arange(h * LANES, dtype=torch.int64, device=seeds.device)
    draws = []
    for i in range(k):
        block = philox4x32(k0, k1, lane, 0, i >> 2, 0)
        draws.append(block[i & 3])
    return to_int32(torch.stack(draws)).view(k, h, LANES)
