"""Render-session checkpoints (counterpart of l2n_tpu.utils.checkpoint).

One NPZ holds the FrameState planes plus the config and the camera, so a
progressive render resumes bit-exactly across process restarts, the rng
state planes of the stateful modes included. The file is the JAX
package's: the same keys, dtypes and config bytes (render/state.py's
session form), so a session saved by either package loads in the other.

Sharded sessions (l2n_tpu_torch.parallel) are the JAX package's too: one
NPZ with the config, `sharded_accum` (n_sample, 4, Hp, Wp), one
accumulation per sample replica, so that a resume goes on with each
replica's stream, the display `output` (3, Hp, Wp), `tile_offset` and
`iteration`, and `rng_state` and `view_matrix` where there are. Rank 0
gathers and writes; every rank reads its own shard back.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.render.state import FrameState


def save_session(path: str | Path, cfg: RenderConfig, state: FrameState,
                 view_matrix: np.ndarray) -> Path:
    path = Path(path)
    arrays = state.to_session()
    rng_state = arrays.pop("rng_state", None)
    arrays["view_matrix"] = np.asarray(view_matrix, np.float32)
    if rng_state is not None:
        arrays["rng_state"] = rng_state
    np.savez_compressed(path, config=np.frombuffer(
        cfg.to_json().encode(), dtype=np.uint8), **arrays)
    return path


def load_session(path: str | Path, device="cuda"
                 ) -> tuple[RenderConfig, FrameState, np.ndarray]:
    """(config, the state on `device`, view matrix) of a session file."""
    with np.load(Path(path)) as data:
        cfg = RenderConfig.from_json(bytes(data["config"]).decode())
        state = FrameState.from_session(data, device)
        view = data["view_matrix"]
    return cfg, state, view


def save_sharded_session(path: str | Path, cfg: RenderConfig, state, mesh,
                         view_matrix: np.ndarray | None = None) -> Path:
    """Checkpoint a sharded render (parallel/step.py ShardedFrameState):
    every rank of the mesh calls it; the shards are gathered to rank 0,
    which writes the file (module doc)."""
    from l2n_tpu_torch.parallel.step import gather_state
    path = Path(path)
    arrays = gather_state(mesh, state)
    if arrays is not None:
        if view_matrix is not None:
            arrays["view_matrix"] = np.asarray(view_matrix, np.float32)
        np.savez_compressed(path, config=np.frombuffer(
            cfg.to_json().encode(), dtype=np.uint8), **arrays)
    return path


def load_sharded_session(path: str | Path, mesh, device="cuda"):
    """This rank's shard of a sharded session on `device`: (cfg,
    ShardedFrameState, view_matrix or None). ValueError where the session's
    sample replicas are not the mesh's."""
    from l2n_tpu_torch.parallel.mesh import mesh_coordinate, mesh_shape
    from l2n_tpu_torch.parallel.step import ShardedFrameState, slab_rows

    shape = mesh_shape(mesh)
    tile, sample = mesh_coordinate(mesh)
    with np.load(Path(path)) as data:
        cfg = RenderConfig.from_json(bytes(data["config"]).decode())
        accum = data["sharded_accum"]
        if accum.shape[0] != shape["sample"]:
            raise ValueError(
                f"session has {accum.shape[0]} sample replicas; mesh has "
                f"{shape['sample']}")
        h = slab_rows(cfg, shape["tile"])
        rows = slice(tile * h, (tile + 1) * h)
        rng_state = None
        if "rng_state" in data:
            rng_state = torch.from_numpy(np.ascontiguousarray(
                data["rng_state"][:, rows]).view(np.int32)).to(device)
        state = ShardedFrameState(
            accum=torch.from_numpy(np.ascontiguousarray(
                accum[sample, :, rows], np.float32)).to(device),
            output=torch.from_numpy(np.ascontiguousarray(
                data["output"][:, rows], np.float32)).to(device),
            tile_offset=int(data["tile_offset"]),
            iteration=int(data["iteration"]), rng_state=rng_state)
        view = data["view_matrix"] if "view_matrix" in data else None
    return cfg, state, view
