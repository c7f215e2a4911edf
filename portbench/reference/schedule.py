"""The tile schedule, regenerated from a configuration (frozen copy;
PROVENANCE.md): the frame's tiles in row-major order, shuffled once with
numpy's MT19937 seeded by `tile_shuffle_seed`; step i renders the
`tiles_per_step` tiles from position i * tiles_per_step of that list,
wrapping around (0 tiles per step means one row of tiles)."""

from __future__ import annotations

import numpy as np
import torch


def tile_counts(cfg: dict) -> tuple[int, int]:
    return (-(-cfg["width"] // cfg["tile_width"]),
            -(-cfg["height"] // cfg["tile_height"]))


def tiles_per_step(cfg: dict) -> int:
    tcx, tcy = tile_counts(cfg)
    n = cfg["tiles_per_step"] if cfg["tiles_per_step"] > 0 else tcx
    return min(n, tcx * tcy)


def tile_order(cfg: dict) -> np.ndarray:
    """(T,) row-major tile ids (ty * tile_count_x + tx) in schedule order."""
    tcx, tcy = tile_counts(cfg)
    tx, ty = np.meshgrid(np.arange(tcx, dtype=np.int32),
                         np.arange(tcy, dtype=np.int32))
    tiles = np.stack([tx.reshape(-1), ty.reshape(-1)], axis=1)
    gen = np.random.Generator(np.random.MT19937(cfg["tile_shuffle_seed"]))
    gen.shuffle(tiles, axis=0)
    return tiles[:, 1] * tcx + tiles[:, 0]


def touches(cfg: dict, first_step: int, last_step: int) -> np.ndarray:
    """(T,) times each tile id is rendered by steps [first_step,
    last_step)."""
    order = tile_order(cfg)
    t, k = order.shape[0], tiles_per_step(cfg)
    g0, g1 = first_step * k, last_step * k
    pos = np.arange(t)
    n = (g1 - pos + t - 1) // t - (g0 - pos + t - 1) // t  # g in [g0, g1)
    out = np.zeros(t, np.int64)
    out[order] = n
    return out


def pixel_tiles(cfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """The tile id of each flat pixel index of the padded frame."""
    tcx, _ = tile_counts(cfg)
    wp = tcx * cfg["tile_width"]
    return ((pixels // wp) // cfg["tile_height"]) * tcx \
        + (pixels % wp) // cfg["tile_width"]
