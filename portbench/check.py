"""The output check that decides `correct`: each snapshotted call of the
timed path (generator.py) against the plain reference (reference/), on a
sample of pixels drawn from the seed.

For each snapshot the reference regenerates the scene, the camera from the
call's view matrix, the tile schedule and so each pixel's sample count
before the call and its touches in it, renders those samples, and
accumulates them onto the program's radiance sums from before the call
(zero after a clear): the one piece of the program's state it takes, since
a converging frame holds the sum of every earlier call. Three numbers,
each the worst over the snapshots:
  * count_mismatch: checked pixels whose sample count after the call
    differs from the reference's (the schedule, the cursor, the touches);
  * accum_gap: sum |program - reference| of the radiance sums after the
    call, over the reference's sum |contribution of the call|;
  * output_gap: sum |program - reference| of the display planes over the
    reference's sum |display|.
Each is held to the cell's limit (cells/<cell>.json).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import schedule
from portbench.reference.camera import packed_camera
from portbench.reference.tracer import Counts, make_scene, render

NUMBERS = ("count_mismatch", "accum_gap", "output_gap")


def check_pixels(cfg: dict, n: int, seed: int, device) -> torch.Tensor:
    """`n` distinct visible pixels (flat indices into the padded frame),
    drawn from the seed, in ascending order."""
    wp = schedule.tile_counts(cfg)[0] * cfg["tile_width"]
    visible = cfg["width"] * cfg["height"]
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(visible, size=min(n, visible), replace=False))
    flat = (pick // cfg["width"]) * wp + pick % cfg["width"]
    return torch.as_tensor(flat, dtype=torch.int64, device=device)


def snapshot_times(seed: int, seconds: float, n: int) -> list:
    """`n` times in the window, drawn from the seed, in (0.15, 0.85) of
    it."""
    rng = np.random.default_rng([seed, 1])
    return sorted(float(f) * seconds for f in rng.uniform(0.15, 0.85, n))


def reference_call(cfg: dict, scene, snap, pixels, steps_per_call: int,
                   dtype=torch.float32, counts=None):
    """The reference's (accum (4, P), output (3, P)) of the checked pixels
    after the snapshotted call, the radiance sums it started from, and the
    off-mesh tally of its triangle sweeps (`Scene.take_off_mesh`)."""
    tiles = schedule.pixel_tiles(cfg, pixels).cpu().numpy()
    spp = cfg["spp_per_step"]
    before = schedule.touches(cfg, snap.clear_step, snap.steps_before)
    during = schedule.touches(cfg, snap.steps_before,
                              snap.steps_before + steps_per_call)
    dev = pixels.device
    count_before = torch.as_tensor(spp * before[tiles], device=dev)
    touched = torch.as_tensor(during[tiles], device=dev)
    rgb_before = (None if snap.rgb_before is None
                  else snap.rgb_before.reshape(3, -1)[:, pixels].float())
    scene.take_off_mesh()
    acc, out = render(cfg, scene, packed_camera(cfg, snap.view), pixels,
                      count_before, touched, rgb_before, dtype=dtype,
                      counts=counts)
    base = (torch.zeros_like(acc[:3]) if rgb_before is None else rgb_before)
    return acc, out, base, scene.take_off_mesh()


def compare(acc, out, base, prog_acc, prog_out) -> dict:
    """The three numbers of one snapshot (module doc)."""
    contribution = (acc[:3].double() - base.double()).abs().sum()
    gap = (prog_acc[:3].double() - acc[:3].double()).abs().sum()
    return {
        "count_mismatch": int((prog_acc[3] != acc[3]).sum()),
        "accum_gap": float(gap / torch.clamp(contribution, min=1e-30)),
        "output_gap": float((prog_out.double() - out.double()).abs().sum()
                            / torch.clamp(out.double().abs().sum(),
                                          min=1e-30)),
    }


def worse(a: float, b: float) -> float:
    """The larger of two readings; NaN, which no limit passes, sticks."""
    return a if math.isnan(a) else b if math.isnan(b) else max(a, b)


def judge(cfg: dict, snaps: list, pixels: torch.Tensor, steps_per_call: int,
          limits: dict, count_work: bool = True):
    """({number: (worst value, limit)}, snapshots that failed, the
    reference's work counts or None, its off-mesh tally summed over the
    snapshots). NaN fails."""
    scene = make_scene(cfg, pixels.device)
    counts = Counts() if count_work else None
    worst = {k: 0.0 for k in NUMBERS}
    failed = 0
    off_mesh = {}
    for snap in snaps:
        acc, out, base, off = reference_call(cfg, scene, snap, pixels,
                                             steps_per_call, counts=counts)
        off_mesh = {k: off_mesh.get(k, 0) + v for k, v in off.items()}
        got = compare(acc, out, base,
                      snap.accum.reshape(4, -1)[:, pixels].float(),
                      snap.output.reshape(3, -1)[:, pixels].float())
        if any(not (got[k] <= limits[k]) for k in NUMBERS):
            failed += 1
        worst = {k: worse(worst[k], got[k]) for k in NUMBERS}
    numbers = {k: (worst[k], limits[k]) for k in NUMBERS}
    return (numbers, failed, None if counts is None else counts.totals(),
            off_mesh)


def passes(numbers: dict) -> bool:
    return all(v <= lim for v, lim in numbers.values())
