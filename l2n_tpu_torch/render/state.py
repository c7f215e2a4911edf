"""Frame state (counterpart of l2n_tpu.render.state).

  * `accum`  — (4, Hp, Wp) float32: rgb = sum of radiance samples, plane 3
    = per-pixel sample count;
  * `output` — (3, Hp, Wp) float32 tonemapped display planes, rewritten only
    for the tiles rendered in a step;
  * `tile_offset` — the wrap-around scheduler cursor (host int);
  * `iteration` — the step counter (host int);
  * `rng_state` — the per-pixel states of the stateful rng modes, 32-bit
    words stored as int32 bit patterns (torch has no uint32 arithmetic, and
    the kernels read the same bytes as uint32_t): (8, Hp, Wp) for tinymt,
    laid out {s0..s3, mat1, mat2, tmat, pad}, (4, Hp, Wp) for tauslcg; None
    for threefry and tpu_hw, whose "state" is the sample count in accum[3].

Channel-major planes padded to the tile grid, the JAX package's layout, on
one torch device. Pad pixels are rendered and cropped at display time.

IN PLACE: a render step writes `accum`, `output` and `rng_state` in place
and returns a new FrameState that shares them with updated counters — the
counterpart of the JAX step's donated input buffers. `clear_accumulation`
zeroes `accum` in place and leaves the RNG states alone. Callers that need
an earlier state keep a copy (`to_numpy`). `load_state` copies another
state into the live buffers, so that a step's CUDA graph, which holds their
addresses (render/step.py), stays right.

The session form (`to_session`, `from_session`) is the JAX package's
FrameState as numpy arrays, what its session files hold
(utils/checkpoint.py): `rng_state` as uint32, `tile_offset` and
`iteration` as 0-d int32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from l2n_tpu_torch.rng.state import init_state_planes
from l2n_tpu_torch.rng.threefry import to_int32


@dataclasses.dataclass(frozen=True)
class FrameState:
    accum: torch.Tensor   # (4, Hp, Wp) f32, updated in place
    output: torch.Tensor  # (3, Hp, Wp) f32, updated in place
    tile_offset: int
    iteration: int
    rng_state: torch.Tensor | None = None  # (8 or 4, Hp, Wp) i32, in place

    @classmethod
    def from_numpy(cls, accum, output, tile_offset=0, iteration=0,
                   device="cpu", rng_state=None) -> "FrameState":
        """Copy host planes (e.g. a JAX FrameState as numpy; its uint32
        `rng_state` becomes int32 bit patterns) to `device`."""
        if rng_state is not None:
            rng_state = torch.from_numpy(
                np.array(rng_state, np.uint32).view(np.int32)).to(device)
        return cls(
            accum=torch.as_tensor(np.array(accum, np.float32)).to(device),
            output=torch.as_tensor(np.array(output, np.float32)).to(device),
            tile_offset=int(tile_offset), iteration=int(iteration),
            rng_state=rng_state)

    def to_numpy(self):
        """(accum, output, tile_offset, iteration) as host copies."""
        return (self.accum.cpu().numpy().copy(),
                self.output.cpu().numpy().copy(),
                self.tile_offset, self.iteration)

    def to_session(self) -> dict[str, np.ndarray]:
        """The session form (module doc) as host copies: accum, output,
        tile_offset, iteration and, for the stateful rng modes, rng_state."""
        accum, output, tile_offset, iteration = self.to_numpy()
        arrays = {"accum": accum, "output": output,
                  "tile_offset": np.asarray(tile_offset, np.int32),
                  "iteration": np.asarray(iteration, np.int32)}
        if self.rng_state is not None:
            arrays["rng_state"] = self.rng_state.cpu().numpy().view(np.uint32)
        return arrays

    @classmethod
    def from_session(cls, arrays, device="cpu") -> "FrameState":
        """The state of the session form `arrays` (a mapping, e.g. an NPZ
        file), on `device`."""
        return cls.from_numpy(
            arrays["accum"], arrays["output"], arrays["tile_offset"],
            arrays["iteration"], device,
            arrays["rng_state"] if "rng_state" in arrays else None)


def init_rng_state(cfg, device="cpu") -> torch.Tensor | None:
    """The stateful modes' per-pixel state planes, built on the host and
    moved to `device` once (rng/state.py); None for the counter-based
    modes."""
    planes = init_state_planes(cfg.rng, cfg.padded_height, cfg.padded_width,
                               cfg.seed)
    return None if planes is None else to_int32(planes).to(device)


def init_frame_state(cfg, device="cpu") -> FrameState:
    h, w = cfg.padded_height, cfg.padded_width
    return FrameState(
        accum=torch.zeros((4, h, w), dtype=torch.float32, device=device),
        output=torch.zeros((3, h, w), dtype=torch.float32, device=device),
        tile_offset=0, iteration=0, rng_state=init_rng_state(cfg, device))


def clear_accumulation(state: FrameState) -> FrameState:
    """clearFramebuffer: zero the accumulation only — not the output (stale
    pixels keep displaying until re-rendered), not the tile offset, not the
    RNG states."""
    state.accum.zero_()
    return state


def load_state(live: FrameState, new: FrameState) -> FrameState:
    """`new`'s planes copied IN PLACE into `live`'s buffers (from any
    device), with `new`'s counters; raises ValueError where a plane's shape
    or presence differs."""
    pairs = [(live.accum, new.accum), (live.output, new.output)]
    if (live.rng_state is None) != (new.rng_state is None):
        raise ValueError("rng_state: the states are of different rng modes")
    if live.rng_state is not None:
        pairs.append((live.rng_state, new.rng_state))
    for dst, src in pairs:
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"state plane {tuple(src.shape)} {src.dtype} "
                             f"does not fit {tuple(dst.shape)} {dst.dtype}")
    for dst, src in pairs:
        dst.copy_(src)
    return dataclasses.replace(live, tile_offset=int(new.tile_offset),
                               iteration=int(new.iteration))


def display_image(cfg, state: FrameState) -> np.ndarray:
    """(H, W, 3) float32 tonemapped image, cropped to the visible area."""
    return np.moveaxis(
        state.output[:, :cfg.height, :cfg.width].cpu().numpy(), 0, -1)
