"""Start the ranks of a sharded render on one host.

`launch(fn, n, backend)` runs fn(rank, *args) in n new processes, each a
rank of one default process group over the backend its caller names:
"nccl" when each rank has a card of its own, "gloo" otherwise (several
ranks on one card, or on the CPU). Nothing picks the backend for the
caller, and nothing replaces it: NCCL with two ranks on one card raises,
as NCCL does.

The processes start with the *spawn* method (CUDA forbids fork), so `fn`
and `args` are pickled and `fn` must be a module-level function of a module
the children can import. Where CUDA is available, rank r takes card r mod
the card count before the group starts. fn's return values come back to
the caller in rank order; a rank that raises or dies ends every rank and
raises here with its traceback. Every process `launch` starts has ended
when it returns.

Several hosts, or one process per card under torchrun, need no launcher:
torchrun sets RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT, and each
process calls torch.distributed.init_process_group("nccl") and
torch.cuda.set_device(LOCAL_RANK) itself (README.md).
"""

from __future__ import annotations

import multiprocessing
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def free_port() -> int:
    """A TCP port of localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, backend, init_method, fn, args, results) -> None:
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method,
                                world_size=n, rank=rank)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the caller, which raises
        results.put((rank, False, traceback.format_exc()))


def launch(fn, n: int, backend: str, args: tuple = (),
           init_method: str | None = None, timeout: float = 600.0) -> list:
    """[fn(0, *args), ..., fn(n - 1, *args)], each run by its own rank
    (module doc). `init_method`: the process group's rendezvous, by
    default tcp://localhost at a free port (a file:// path keeps
    concurrent launches apart without ports). Raises RuntimeError when a
    rank fails, dies or outlasts `timeout` seconds."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if n < 1:
        raise ValueError(f"launch: {n} ranks")
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, backend, init_method, fn, args, results))
             for r in range(n)]
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} ended with exit code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       "result") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"launch: ranks {sorted(set(range(n)) - set(out))} "
                                       f"still running after {timeout} s") \
                        from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    return [out[r] for r in range(n)]
