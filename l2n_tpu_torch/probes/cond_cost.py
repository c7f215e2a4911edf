"""The cost of a block-wide vote and a branch inside a kernel, on the card
(counterpart of benchmarks/cond_cost.py).

A grid of programs, each running REPS copies of one structure over the same
(32, 128) float32 block, all writing the one (1, 32, 128) output:

  * work: W chained acc = acc * 1.0000001 + 1e-9 (the slope: ns per op);
  * any: a vote over the whole block feeding nothing conditional;
  * cond_taken / cond_skipped: the vote as the predicate (always true /
    always false) of W chained ops on the first of M carried values.

`cond_cost` launches csrc/cond_cost.cu on a CUDA tensor and runs
`cond_cost_plain` on a CPU tensor. On this card the M - 1 carries that
never reach the output are dead code, deleted by the compiler (see the
kernel's note).

    python3 -m l2n_tpu_torch.probes.cond_cost [--device cuda|cpu]

prints, per setting of the JAX probe's `main` (GRID programs), the kernel
time per unit (program x repeat) in ns.
"""

from __future__ import annotations

import argparse

import torch

from l2n_tpu_torch.ops.kernels.common import check_tensor, launch_raw
from l2n_tpu_torch.probes import elapsed_ms, probe_device

GRID = 256
REPS = 16
SHAPE = (32, 128)
MODES = {"work": 0, "any": 1, "cond_taken": 2, "cond_skipped": 3}
# The carry counts the kernel is instantiated for (the JAX probe's main).
CARRIES = (1, 3, 6, 12, 20)
# (mode, m_carry, w_work) of benchmarks/cond_cost.py:82-89, in its order.
SETTINGS = ([("work", 0, w) for w in (0, 16, 64, 256)] + [("any", 0, 0)]
            + [(mode, m, 16) for m in CARRIES
               for mode in ("cond_taken", "cond_skipped")])


def _check(x, mode: str, m_carry: int, w_work: int, grid: int,
           reps: int) -> None:
    dev = x.device if isinstance(x, torch.Tensor) else None
    check_tensor("x", x, torch.float32, (1, *SHAPE), dev)
    if mode not in MODES:
        raise ValueError(f"cond_cost: mode {mode!r}, expected one of "
                         f"{sorted(MODES)}")
    if mode.startswith("cond") and m_carry not in CARRIES:
        raise ValueError(f"cond_cost: m_carry {m_carry} for {mode}, "
                         f"expected one of {CARRIES}")
    if w_work < 0 or grid <= 0 or reps < 0:
        raise ValueError("cond_cost: w_work and reps must be >= 0, grid > 0")


def cond_cost(x: torch.Tensor, mode: str, m_carry: int = 0, w_work: int = 0,
              grid: int = GRID, reps: int = REPS) -> torch.Tensor:
    """The (1, 32, 128) output every program writes (see module doc)."""
    _check(x, mode, m_carry, w_work, grid, reps)
    if x.device.type == "cpu":
        return cond_cost_plain(x, mode, m_carry, w_work, grid, reps)
    if x.device.type != "cuda":
        raise ValueError(f"cond_cost: no kernel for device {x.device}")
    out = torch.empty_like(x)
    launch_raw("cond_cost", x.device, x, MODES[mode], m_carry, w_work, grid,
               reps, out)
    return out


def _fma_chain(h: torch.Tensor, w: int) -> torch.Tensor:
    for _ in range(w):
        h = h * 1.0000001 + 1e-9
    return h


def cond_cost_plain(x: torch.Tensor, mode: str, m_carry: int = 0,
                    w_work: int = 0, grid: int = GRID,
                    reps: int = REPS) -> torch.Tensor:
    """The plain torch version of `cond_cost`: all `grid` programs in
    lockstep, each vote over its own block; returns the last program's
    block (every program writes the same one)."""
    _check(x, mode, m_carry, w_work, grid, reps)
    f32 = torch.float32
    tiny = torch.tensor(1e-9, dtype=f32, device=x.device)
    zero = torch.zeros((), dtype=f32, device=x.device)
    acc = x.expand(grid, *SHAPE).clone()

    def vote(cond: torch.Tensor) -> torch.Tensor:  # per program, (grid,1,1)
        return cond.flatten(1).any(1).view(grid, 1, 1)

    for _ in range(reps):
        if mode == "work":
            acc = _fma_chain(acc, w_work)
        elif mode == "any":
            acc = acc + torch.where(vote(acc > -1e30), tiny, zero)
        else:
            pred = vote(acc > -1e30 if mode == "cond_taken" else acc > 1e30)
            carry = [acc + float(i) for i in range(m_carry)]
            acc = torch.where(pred, _fma_chain(carry[0], w_work), carry[0])
    return acc[-1:].clone()


def run(x: torch.Tensor, mode: str, m_carry: int = 0, w_work: int = 0,
        grid: int = GRID) -> float:
    """ns per unit (program x repeat) of `cond_cost` on x's device: the best
    of 4 rounds of 10 calls, as benchmarks/cond_cost.py:68-76, by the
    kernel's device time on a card (`elapsed_ms`)."""
    call = (lambda: cond_cost(x, mode, m_carry, w_work, grid))
    best = elapsed_ms(call, 10, x.device, rounds=4)
    per = best * 1e6 / (grid * REPS)
    print(f"{mode:13s} m={m_carry:2d} w={w_work:3d}  {per:9.1f} ns/unit",
          flush=True)
    return per


def main(argv: list[str] | None = None) -> dict:
    """Every setting of benchmarks/cond_cost.py's main; returns
    {(mode, m, w): ns per unit}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    dev = probe_device(p.parse_args(argv).device)
    x = torch.ones((1, *SHAPE), dtype=torch.float32, device=dev)
    return {s: run(x, *s, grid=GRID) for s in SETTINGS}


if __name__ == "__main__":
    main()
