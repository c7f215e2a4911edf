"""Shuffled round-robin tile scheduler (counterpart of l2n_tpu.render.tiles).

The image splits into tiles; the tile list is shuffled once with a
fixed-seed Mersenne Twister (numpy MT19937, as in the JAX package), and
each step renders `effective_tiles_per_step` tiles starting at a
wrap-around offset. The offset is a host integer here (the JAX package
keeps it as a traced scalar).
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


def scheduled_tiles(tile_array: torch.Tensor, offset: int,
                    count: int) -> torch.Tensor:
    """The `count` tiles dispatched this step: tileArray[(i + offset) % T],
    gathered on the tile array's device."""
    t = tile_array.shape[0]
    idx = (torch.arange(count, device=tile_array.device) + offset) % t
    return tile_array[idx].contiguous()


def advance_offset(cfg, offset: int) -> int:
    """tileOffset = (tileOffset + tilesPerIteration) % tileCount."""
    return (int(offset) + cfg.effective_tiles_per_step) % cfg.tile_count
