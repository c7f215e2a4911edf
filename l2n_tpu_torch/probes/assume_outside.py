"""Does the JAX package's t1-only sweep (`assume_outside`, l2n_tpu/ops/
intersect.py:38 and :127, taken for bounce and shadow casts when
`spheres_disjoint(scene, margin=2 * ray_epsilon)` holds) change any cast
of the port's plain path? A count, on a disjoint scene of the default
size.

The plain sphere step (ops/kernels/sphere_pt.py sphere_pt_plain) renders
the scheduled tiles with its nearest-hit and any-hit closures wrapped: each
cast also runs the t1-only forms (a candidate counts only where t1 >= 0;
an any-hit only ahead, hb < 0 and hb^2 >= c) and the wrapper counts, per
kind (primary, the rest), the live lanes, those whose origin lies inside a
sphere (c < 0) and those whose result differs (t or index; the hit flag).
The render itself keeps the full sweep's results.

    python3 -m l2n_tpu_torch.probes.assume_outside [--device cuda|cpu] \
        [--steps N] [--width W --height H]

Prints one JSON line: the scene seed (the first seed >= 0 whose default
128 spheres are disjoint at margin 2 ray_epsilon; 339), the config, and
the counts. `--device cpu` runs a small frame.
"""

from __future__ import annotations

import argparse
import collections
import json

import torch

from l2n_tpu_torch.maths.sampling import sqrt
from l2n_tpu_torch.ops.intersect import _candidates
from l2n_tpu_torch.probes import probe_device

_BIG = 3.0e38


def disjoint_seed(cfg) -> int:
    """The first scene seed >= 0 whose cfg.sphere_count spheres are disjoint
    at margin 2 ray_epsilon, the JAX package's condition."""
    from l2n_tpu_torch.scene.spheres import compute_spheres, spheres_disjoint
    seed = 0
    while not spheres_disjoint(compute_spheres(
            cfg.sphere_count, cfg.world_size, seed),
            margin=2 * cfg.ray_epsilon):
        seed += 1
    return seed


def nearest_t1_only(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2):
    """(t, index) of the JAX package's `assume_outside` nearest sweep: a
    candidate counts only where t1 = -hb - sqrt(disc) >= 0; t = -1 and
    index = -1 on a miss. The full sweep's operations otherwise
    (ops/intersect.py intersect_sphere_scene)."""
    hb, cc = _candidates(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2)
    t1 = -hb - sqrt(hb * hb - cc)
    t = torch.where(t1 >= 0.0, t1, torch.full_like(t1, _BIG))
    best_i = torch.argmin(t, dim=-1)
    best_t = torch.gather(t, -1, best_i.unsqueeze(-1)).squeeze(-1)
    hit = best_t < _BIG
    return (torch.where(hit, best_t, torch.full_like(best_t, -1.0)),
            torch.where(hit, best_i, torch.full_like(best_i, -1)))


def anyhit_t1_only(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2):
    """The JAX package's `assume_outside` any-hit: a sphere ahead only
    (hb < 0 and hb^2 >= c), never one holding the origin."""
    hb, cc = _candidates(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2)
    return ((hb < 0.0) & (hb * hb >= cc)).any(-1)


def t2_lanes(cfg, steps: int, device) -> dict:
    """Counts of `steps` plain steps of `cfg` (its scene seed disjoint)."""
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.ops.kernels.common import render_tiles_plain
    from l2n_tpu_torch.ops.scenes import (
        SPHERE_MISS_COLOR,
        sphere_anyhit,
        sphere_intersector,
    )
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    from l2n_tpu_torch.scene.spheres import compute_spheres
    spheres = compute_spheres(cfg.sphere_count, cfg.world_size,
                              cfg.scene_seed, device=device).packed()
    cx, cy, cz, r2 = spheres[:4]
    full = sphere_intersector(cx, cy, cz, r2, cfg.fast_math)
    full_any = sphere_anyhit(cx, cy, cz, r2)
    c = collections.Counter()

    def inside(ox, oy, oz, dx, dy, dz):
        live = torch.broadcast_to(ox, dx.shape) < 1e30
        _, cc = _candidates(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2)
        return live, live & (cc < 0.0).any(-1)

    def nearest(ox, oy, oz, dx, dy, dz):
        h = full(ox, oy, oz, dx, dy, dz)
        t, i = nearest_t1_only(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2)
        live, held = inside(ox, oy, oz, dx, dy, dz)
        k = "primary" if ox.dim() == 0 else "rest"
        c[k + "_casts"] += int(live.sum())
        c[k + "_inside"] += int(held.sum())
        c[k + "_differ"] += int((live & ((t != h.t)
                                         | (i != h.index))).sum())
        return h

    def anyhit(ox, oy, oz, dx, dy, dz):
        hit = full_any(ox, oy, oz, dx, dy, dz)
        ahead = anyhit_t1_only(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2)
        live, held = inside(ox, oy, oz, dx, dy, dz)
        c["anyhit_casts"] += int(live.sum())
        c["anyhit_inside"] += int(held.sum())
        c["anyhit_differ"] += int((live & (ahead != hit)).sum())
        return hit

    tiles = torch.as_tensor(tile_grid(cfg)).to(device)
    cam = Camera.from_config(cfg).packed()
    state = init_frame_state(cfg, device)
    k = cfg.effective_tiles_per_step
    for i in range(steps):
        sched = scheduled_tiles(tiles, i * k % cfg.tile_count, k)
        render_tiles_plain(cfg, sched, cam, nearest, anyhit, spheres[4:].T,
                           state.accum, state.output, state.rng_state,
                           SPHERE_MISS_COLOR)
    c["lit"] = float((state.accum[:3].amax(0) > 0).float().mean())
    return dict(c)


def main() -> int:
    from l2n_tpu_torch.config import RenderConfig
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    args = ap.parse_args()
    dev = probe_device(args.device)
    size = {}
    if args.width:
        size["width"] = args.width
    if args.height:
        size["height"] = args.height
    if dev.type == "cpu" and not size:
        size = {"width": 256, "height": 128}
    cfg = RenderConfig(**size).validate()
    cfg = cfg.replace(scene_seed=disjoint_seed(cfg),
                      tiles_per_step=cfg.tile_count).validate()
    counts = t2_lanes(cfg, args.steps, dev)
    print(json.dumps({"scene_seed": cfg.scene_seed, "width": cfg.width,
                      "height": cfg.height, "steps": args.steps,
                      "spp_per_step": cfg.spp_per_step,
                      "max_bounces": cfg.max_bounces, **counts}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
