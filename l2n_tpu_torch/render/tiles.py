"""Shuffled round-robin tile scheduler (counterpart of l2n_tpu.render.tiles).

The image splits into tiles; the tile list is shuffled once with a
fixed-seed Mersenne Twister (numpy MT19937, as in the JAX package), and
each step renders `effective_tiles_per_step` tiles starting at a
wrap-around offset. The FrameState keeps the offset as a host integer (the
JAX package keeps it as a traced scalar). A step that runs several
scheduler steps per call (render/step.py, `steps_per_call`) reads it from a
device int32 cursor instead, so that one CUDA graph of those steps is right
from any starting offset: the gather and the cursor's advance both run on
the device.
"""

from __future__ import annotations

import numpy as np
import torch


def tile_grid(cfg) -> np.ndarray:
    """(T, 2) int32 of (tile_x, tile_y), row-major order shuffled once."""
    tx, ty = np.meshgrid(np.arange(cfg.tile_count_x, dtype=np.int32),
                         np.arange(cfg.tile_count_y, dtype=np.int32))
    tiles = np.stack([tx.reshape(-1), ty.reshape(-1)], axis=1)
    gen = np.random.Generator(np.random.MT19937(cfg.tile_shuffle_seed))
    gen.shuffle(tiles, axis=0)
    return tiles


def scheduled_tiles(tile_array: torch.Tensor, offset: int | torch.Tensor,
                    count: int) -> torch.Tensor:
    """The `count` tiles dispatched from `offset`: tileArray[(i + offset) %
    T], gathered on the tile array's device. `offset` is a host int or a
    device int32 cursor of one element (`advance_cursor`); `count` may
    exceed T, wrapping as often as it needs (the schedules of several steps
    at once)."""
    t = tile_array.shape[0]
    idx = (torch.arange(count, device=tile_array.device) + offset) % t
    return tile_array[idx].contiguous()


def scheduled_pixel_mask(cfg, tile_array: torch.Tensor,
                         offset: int | torch.Tensor, count: int,
                         height: int | None = None) -> torch.Tensor:
    """(H, W) bool: True at the pixels of the tiles scheduled from `offset`
    (`scheduled_tiles`), on the tile array's device. `height` overrides
    the covered row count for a slab of a sharded frame, whose tile array
    holds slab-local tile coordinates (l2n_tpu_torch/parallel). A tile
    scheduled twice (count > T) is covered once."""
    t = tile_array.shape[0]
    dev = tile_array.device
    sched = scheduled_tiles(tile_array, offset, count).to(torch.int64)
    flags = torch.zeros((max(t, 1),), dtype=torch.bool, device=dev)
    flags[sched[:, 1] * cfg.tile_count_x + sched[:, 0]] = True
    py = torch.arange(height or cfg.padded_height, device=dev)[:, None]
    px = torch.arange(cfg.padded_width, device=dev)[None, :]
    return flags[(py // cfg.tile_height) * cfg.tile_count_x
                 + px // cfg.tile_width]


def advance_offset(cfg, offset: int, steps: int = 1) -> int:
    """tileOffset = (tileOffset + tilesPerIteration) % tileCount, `steps`
    times."""
    return (int(offset) + steps * cfg.effective_tiles_per_step) \
        % cfg.tile_count


def advance_cursor(cfg, cursor: torch.Tensor, steps: int) -> None:
    """`advance_offset` on the device: the (1,) int32 cursor, in place."""
    cursor.add_(steps * cfg.effective_tiles_per_step).remainder_(
        cfg.tile_count)
