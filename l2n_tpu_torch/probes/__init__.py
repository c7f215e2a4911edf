"""H100 probes: the counterparts of the JAX package's microbenchmark
kernels (benchmarks/cond_cost.py, benchmarks/sweep_variants.py,
benchmarks/onehot_recovery.py), each with hand-written CUDA kernels
(csrc/cond_cost.cu, csrc/sweep_variants.cu, csrc/onehot_recovery.cu) beside
their plain torch versions.

  * `cond_cost` — the cost of a block-wide vote and a branch in a kernel;
  * `sweep_variants` — the sphere sweep carrying the winner's attributes,
    keeping (t, index) and gathering, or with its dot products on the
    tensor cores;
  * `onehot_recovery` — the winner's attributes carried or read afterwards.

Each runs as a module, on the card by default:

    python3 -m l2n_tpu_torch.probes.cond_cost
    python3 -m l2n_tpu_torch.probes.sweep_variants
    python3 -m l2n_tpu_torch.probes.onehot_recovery [check|time]

`--device cpu` runs the plain versions (small sizes only); `--device cuda`
without a card raises. Wrappers follow ops/kernels: a CUDA tensor launches
the kernel (counted in `common.launches`), a CPU tensor runs the plain
version.
"""

from __future__ import annotations

import time

import torch


def probe_device(name: str) -> torch.device:
    """The device a probe runs on: "cuda" (the kernels; raises without a
    card) or "cpu" (the plain versions)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the probes time the card's "
                               "kernels (--device cpu runs the plain "
                               "versions)")
    elif dev.type != "cpu":
        raise ValueError(f"--device {name}: expected cuda or cpu")
    return dev


def elapsed_ms(fn, n: int, device: torch.device, rounds: int = 1) -> float:
    """Milliseconds per call of fn() over n calls in a row, the best of
    `rounds`. On a card: the kernels' device time, the n calls captured
    once into a CUDA graph and the graph replayed between CUDA events, so
    that the host's dispatch of each call (tens of microseconds, more than
    many of the probes' kernels take) is not timed. On the CPU: the host
    clock."""
    if device.type != "cuda":
        best = float("inf")
        for _ in range(rounds):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter() - t0) * 1e3 / n)
        return best
    fn()  # builds the library and warms the allocator outside the capture
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(rounds + 1):  # the first replay uploads the graph
        torch.cuda.synchronize(device)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(end) / n)
    return best
