"""The (tile, sample) mesh of ranks (counterpart of l2n_tpu.parallel.mesh).

A rank is one process with one shard of the frame. The mesh is a
torch.distributed DeviceMesh over the first n_tile * n_sample ranks of the
default process group, its dimensions named ("tile", "sample"), with rank
= tile * n_sample + sample: the JAX package's reshape(n_tile, n_sample) of
its device list. The process group comes first (parallel/launch.py, or
torchrun), with the backend its caller chose.

The slabs and replicas move between ranks only in the gathers of
`gather_slabs` / `gather_replicas` (display and sessions) and in the sample
axis' fold (parallel/step.py). A gather's tensors go through the host
under gloo and stay on the card under NCCL (`comm_device`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("tile", "sample")


def mesh_factors(n_devices: int, cfg=None) -> tuple[int, int]:
    """Split n devices into (n_tile, n_sample), as the JAX package does.

    Prefer tile-sharding (it needs no collectives); keep a sample axis of 2
    when the device count allows so the step exercises a real fold. The
    tile factor must divide the tile-grid rows when a config is given (the
    default config's 23 rows leave the sample axis only).
    """
    n_sample = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    n_tile = n_devices // n_sample
    if cfg is not None:
        while n_tile > 1 and cfg.tile_count_y % n_tile != 0:
            n_tile //= 2
        n_sample = n_devices // n_tile if n_devices % n_tile == 0 else 1
    return n_tile, n_sample


def make_device_mesh(n_tile: int | None = None, n_sample: int = 1,
                     device_type: str = "cuda") -> DeviceMesh:
    """The DeviceMesh named ("tile", "sample") over the first n_tile *
    n_sample ranks of the default process group (module doc); n_tile
    defaults to all ranks. Every rank of the group calls it (it creates
    the dimensions' groups); a rank past the mesh gets a mesh it is not
    in (`mesh_coordinate` is None) and renders nothing."""
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs the default process "
                           "group (parallel/launch.py, or torchrun)")
    world = dist.get_world_size()
    if n_tile is None:
        n_tile = world // n_sample
    need = n_tile * n_sample
    if n_tile < 1 or n_sample < 1 or need > world:
        raise ValueError(f"{n_tile} x {n_sample} mesh needs {need} ranks, "
                         f"have {world}")
    ranks = torch.arange(need, dtype=torch.int64).reshape(n_tile, n_sample)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """{"tile": n_tile, "sample": n_sample} (the JAX Mesh's `shape`)."""
    if tuple(mesh.mesh_dim_names or ()) != AXES:
        raise ValueError(f"mesh dimensions {mesh.mesh_dim_names}, expected "
                         f"{AXES} (make_device_mesh)")
    n_tile, n_sample = mesh.mesh.shape
    return {"tile": int(n_tile), "sample": int(n_sample)}


def mesh_coordinate(mesh: DeviceMesh) -> tuple[int, int] | None:
    """(tile_rank, sample_rank) of this rank, None if it is not in the
    mesh."""
    coord = mesh.get_coordinate()
    return None if coord is None else (int(coord[0]), int(coord[1]))


def comm_device(group, device: torch.device) -> torch.device:
    """Where a gather's tensors live: the host under gloo, `device` (the
    rank's card) under NCCL."""
    return device if dist.get_backend(group) == "nccl" else torch.device("cpu")


def _gather(t: torch.Tensor, group, dst: int, n: int, here: bool):
    """dist.gather of `t` over `group` (n ranks) to global rank `dst`,
    staged on comm_device; the n tensors at dst (`here`), else None."""
    dev = comm_device(group, t.device)
    src = t.contiguous().to(dev)
    parts = [torch.empty_like(src) for _ in range(n)] if here else None
    dist.gather(src, parts, dst=dst, group=group)
    return parts


def gather_slabs(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor | None:
    """This rank's slab `t` (..., h, W) and those of its tile group (the
    ranks of its sample index), stacked along rows in tile order: the whole
    frame's rows, at the group's tile rank 0 (global rank = the sample
    rank), None on the others. Every rank of the mesh calls it."""
    tile, sample = mesh_coordinate(mesh)
    n_tile = mesh_shape(mesh)["tile"]
    parts = _gather(t, mesh.get_group("tile"), sample, n_tile, tile == 0)
    return None if parts is None else torch.cat(parts, dim=-2)


def gather_replicas(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor | None:
    """`t` of the sample replicas of tile rank 0, stacked (n_sample, ...) in
    sample order at rank 0, None on the others. The ranks of tile rank 0
    call it."""
    tile, sample = mesh_coordinate(mesh)
    if tile != 0:
        raise ValueError("gather_replicas: called on tile rank "
                         f"{tile}; the ranks of tile rank 0 gather")
    n_sample = mesh_shape(mesh)["sample"]
    parts = _gather(t, mesh.get_group("sample"), 0, n_sample, sample == 0)
    return None if parts is None else torch.stack(parts)
