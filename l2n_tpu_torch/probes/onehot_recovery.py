"""Winner-attribute recovery for the bounce sweep, on the card (counterpart
of benchmarks/onehot_recovery.py).

One sweep over S spheres (the assume_outside t1-only form) for every lane
of one (32, 128) block of rays, writing six planes: t (3e38 on a miss), the
winner's index as float (-1 on a miss), and its cx, cy, cz, r2:

  * `onehot_carry` — the attributes carried through every candidate, from
    (0, 0, 0, 1): a miss leaves r2 = 1;
  * `onehot_gather` — (t, index) only, the attributes read afterwards from
    the (S, 8) table (the TPU's exact one-hot matmul; 0 on a miss).

Each wrapper launches csrc/onehot_recovery.cu on CUDA tensors and runs its
`*_plain` version on CPU tensors. The kernels split each ray's sweep over a
group of lanes (`launch_shape` gives the group, block and grid).

    python3 -m l2n_tpu_torch.probes.onehot_recovery [check|time]
        [--device cuda|cpu]

over S spheres. `check`: the two recoveries bit-equal on hits. `time`: the marginal time
per call of each kernel on the card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from l2n_tpu_torch.maths.sampling import sqrt
from l2n_tpu_torch.ops.kernels import build
from l2n_tpu_torch.ops.kernels.common import check_tensor, launch_raw
from l2n_tpu_torch.probes import probe_device

S = 128           # spheres
TH, TW = 32, 128  # lane block
REPS = 400
BIG = 3.0e38
NAMES = ("t", "i", "cx", "cy", "cz", "r2")


def inputs(s: int = S) -> dict:
    """The probe's inputs as numpy arrays, built as
    benchmarks/onehot_recovery.py:43-55 and :143-152 build them: rays (6,
    32, 128) = ox, oy, oz, dx, dy, dz (seed 3), spheres (4, s) = cx, cy, cz,
    r2 (seed 7), and the (s, 8) table whose columns 0-3 are the spheres."""
    r = np.random.RandomState(3)
    o = r.uniform(-6, 6, size=(3, TH, TW)).astype(np.float32)
    d = r.normal(size=(3, TH, TW)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    r = np.random.RandomState(7)
    c = r.uniform(-4, 4, size=(3, s)).astype(np.float32)
    rad = r.uniform(0.2, 0.9, size=(s,)).astype(np.float32)
    spheres = np.stack([c[0], c[1], c[2], (rad * rad).astype(np.float32)])
    table = np.zeros((s, 8), np.float32)
    table[:, :4] = spheres.T
    return {"rays": np.concatenate([o, d]), "spheres": spheres,
            "table": table}


def _check(rays, spheres, table=None):
    """(S, device) after checking the inputs."""
    dev = rays.device if isinstance(rays, torch.Tensor) else None
    check_tensor("rays", rays, torch.float32, (6, TH, TW), dev)
    s = spheres.shape[1] if isinstance(spheres, torch.Tensor) and \
        spheres.dim() == 2 else -1
    check_tensor("spheres", spheres, torch.float32, (4, s), dev)
    if table is not None:
        check_tensor("table", table, torch.float32, (s, 8), dev)
    if s <= 0:
        raise ValueError("onehot: at least one sphere")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"onehot: no kernel for device {dev}")
    return s, dev


def onehot_carry(rays: torch.Tensor, spheres: torch.Tensor) -> torch.Tensor:
    """(6, 32, 128) float32: t, index, cx, cy, cz, r2 of the carry sweep."""
    s, dev = _check(rays, spheres)
    if dev.type == "cpu":
        return onehot_carry_plain(rays, spheres)
    out = torch.empty_like(rays)
    launch_raw("onehot_carry", dev, rays, spheres, s, TH * TW, out)
    return out


def onehot_gather(rays: torch.Tensor, spheres: torch.Tensor,
                  table: torch.Tensor) -> torch.Tensor:
    """(6, 32, 128) float32: the index-only sweep, attributes from
    `table`."""
    s, dev = _check(rays, spheres, table)
    if dev.type == "cpu":
        return onehot_gather_plain(rays, spheres, table)
    if table.data_ptr() % 16:
        raise ValueError("table: must be 16-byte aligned (the kernel reads "
                         "a winner's row in one 16-byte load)")
    out = torch.empty_like(rays)
    launch_raw("onehot_gather", dev, rays, spheres, s, table, TH * TW, out)
    return out


def launch_shape(lanes: int = TH * TW) -> tuple[int, int, int]:
    """(lanes per ray, threads per block, blocks) of the kernels at
    `lanes` lanes, from the built library."""
    shape = np.zeros(3, np.int32)
    build.load().l2n_onehot_shape(lanes, shape.ctypes.data)
    return tuple(int(v) for v in shape)


def _sweep_plain(rays, spheres, carry: bool):
    """benchmarks/onehot_recovery.py::_sweep in lockstep over the lanes."""
    dev = rays.device
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    ox, oy, oz, dx, dy, dz = rays
    best_t = torch.full_like(ox, BIG)
    best_i = torch.full(ox.shape, -1, dtype=torch.int32, device=dev)
    attrs = [torch.zeros_like(ox) for _ in range(3)] + [torch.ones_like(ox)]
    for j in range(spheres.shape[1]):
        cx, cy, cz, r2 = spheres[:, j]
        cox, coy, coz = cx - ox, cy - oy, cz - oz
        nhb = cox * dx + coy * dy + coz * dz
        c = (cox * cox - r2) + coy * coy + coz * coz
        sq = sqrt(nhb * nhb - c)
        t1 = nhb - sq
        t = torch.where(t1 >= 0.0, t1, big)
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, j, best_i)
        if carry:
            attrs = [torch.where(better, v, a)
                     for v, a in zip((cx, cy, cz, r2), attrs)]
    return best_t, best_i, attrs


def onehot_carry_plain(rays: torch.Tensor,
                       spheres: torch.Tensor) -> torch.Tensor:
    """The plain torch version of `onehot_carry`."""
    _check(rays, spheres)
    t, i, attrs = _sweep_plain(rays, spheres, carry=True)
    return torch.stack([t, i.to(torch.float32), *attrs])


def onehot_gather_plain(rays: torch.Tensor, spheres: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """The plain torch version of `onehot_gather`."""
    _check(rays, spheres, table)
    t, i, _ = _sweep_plain(rays, spheres, carry=False)
    zero = torch.zeros((), dtype=torch.float32, device=rays.device)
    row = table[i.clamp(min=0).long()]  # (32, 128, 8)
    attrs = [torch.where(i >= 0, row[..., k], zero) for k in range(4)]
    return torch.stack([t, i.to(torch.float32), *attrs])


def _device_inputs(dev, s: int):
    return {k: torch.from_numpy(v).to(dev) for k, v in inputs(s).items()}


def check(device: torch.device, s: int = S) -> bool:
    """The two recoveries bit-equal on hits (benchmarks/onehot_recovery.py:
    155-169); prints the hit fraction and each plane's verdict."""
    x = _device_inputs(device, s)
    a = onehot_carry(x["rays"], x["spheres"]).cpu().numpy()
    b = onehot_gather(x["rays"], x["spheres"], x["table"]).cpu().numpy()
    hit = a[1] >= 0
    print(f"hit fraction: {hit.mean():.3f}")
    ok = True
    for k, name in enumerate(NAMES):
        eq = np.array_equal(a[k][hit], b[k][hit])
        ok = ok and eq
        print(f"  {name}: bit-equal on hits = {eq}")
        if not eq:
            print(f"    max |diff| = {np.abs(a[k] - b[k])[hit].max():.3e}")
    print("CHECK", "PASS" if ok else "FAIL")
    return ok


def timeit(device: torch.device, s: int = S) -> dict:
    """Marginal ms per call of each kernel, (t(2N) - t(N)) / N on the host
    clock to a synchronize (benchmarks/onehot_recovery.py:172-191)."""
    if device.type != "cuda":
        raise RuntimeError("time mode needs the card")
    x = _device_inputs(device, s)
    calls = {"carry": lambda: onehot_carry(x["rays"], x["spheres"]),
             "onehot": lambda: onehot_gather(x["rays"], x["spheres"],
                                             x["table"])}
    res = {}
    for kind, f in calls.items():
        f()
        torch.cuda.synchronize(device)

        def run(n):
            t0 = time.perf_counter()
            for _ in range(n):
                f()
            torch.cuda.synchronize(device)
            return time.perf_counter() - t0

        run(20)
        t1, t2 = run(REPS), run(2 * REPS)
        res[kind] = (t2 - t1) / REPS * 1e3
        print(f"{kind:7s}: {res[kind]:.4f} ms/call marginal", flush=True)
    return res


def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", nargs="?", default="check",
                   choices=("check", "time"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = probe_device(args.device)
    return check(dev, S) if args.mode == "check" else timeit(dev, S)


if __name__ == "__main__":
    if main() is False:
        raise SystemExit(1)
