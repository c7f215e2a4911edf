"""Where the program and the reference part: consecutive calls of a cell's
timed path, each held to the reference at the pixels the cell's check
draws from the seed, and for each pixel that differs the reference's
samples of that call one by one (colour, primary hit) and, with
`--witness`, the port's plain path on the card from the same state. The
benchmark's runs do not run this; still-camera mixes only.

    python3 -m portbench.scan --workload <cell> --seed <n> --calls <N> \\
        [--first F] [--stride K] [--witness]

Prints one JSON line per call checked (the check's three numbers, the
reference's off-mesh tally over the call: sliver candidates its sweep
rejected and casts whose nearest hit that changed, and the pixels that
differ, the first ten of them in detail).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from portbench import check, harness
from portbench.generator import Snapshot
from portbench.reference import schedule
from portbench.reference.camera import packed_camera
from portbench.reference.rng import PhiloxSampler, max_pairs_per_sample
from portbench.reference.tracer import check_nee, make_scene, primary_rays, \
    trace


def reference_samples(cfg: dict, scene, view, pixel: int, first: int,
                      n: int) -> list:
    """[sample index, (r, g, b), primary t, primary object] of the
    reference's samples first .. first + n - 1 of one pixel."""
    dev = scene.albedo.device
    cam = torch.as_tensor(packed_camera(cfg, view)).to(dev)
    lights = check_nee(cfg, scene)
    pix = torch.full((n,), pixel, dtype=torch.int64, device=dev)
    sample = torch.arange(first, first + n, device=dev)
    sampler = PhiloxSampler(cfg["seed"], 0, pix, sample, max_pairs_per_sample(
        cfg["max_bounces"], lights is not None))
    u1, u2 = sampler.draw2()
    wp = cfg["padded_width"]
    rays = primary_rays(cfg, cam, (pix % wp).float(), (pix // wp).float(),
                        u1, u2)
    hit = scene.nearest(*rays)
    rgb = trace(cfg, scene, sampler, *rays, lights=lights)
    return [[first + i, [float(c[i]) for c in rgb], float(hit.t[i]),
             int(hit.index[i])] for i in range(n)]


def scan(name: str, seed: int, calls: int, first: int = 0, stride: int = 1,
         witness: bool = False, device="cuda", backend: str = "cuda",
         overrides=None, mix_overrides=None):
    """Yield, per call checked, {"call", "numbers", "off_mesh", "differ",
    "pixels"}."""
    from l2n_tpu_torch.camera.camera import Camera
    dev = torch.device(device)
    c = harness.load_cell(name, seed, overrides, mix_overrides)
    if c.mix["camera"] != "still" or c.mix.get("clear_each_frame"):
        raise ValueError(f"{name}: scan takes still-camera mixes")
    cfg = harness.port_config(c.ref_cfg)
    spc, spp = int(c.mix["steps_per_call"]), cfg.spp_per_step
    renderer, _ = harness.build_renderer(c, dev, backend)
    view = np.asarray(c.config["view"], np.float32)
    camera = Camera.from_config(cfg, view_matrix=view)
    scene = make_scene(c.ref_cfg, dev)
    pixels = check.check_pixels(c.ref_cfg, int(c.cell["check"]["pixels"]),
                                seed, dev)
    tiles = schedule.pixel_tiles(c.ref_cfg, pixels).cpu().numpy()
    tcx = schedule.tile_counts(c.ref_cfg)[0]
    wp = c.ref_cfg["padded_width"]
    plain = None
    for call in range(first + calls):
        if call < first or (call - first) % stride:
            renderer.step(camera)
            continue
        st0 = renderer.state
        before = dataclasses.replace(st0, accum=st0.accum.clone(),
                                     output=st0.output.clone())
        st = renderer.step(camera)
        snap = Snapshot(call * spc, 0, view,
                        None if call == 0 else before.accum[:3], st.accum,
                        st.output)
        acc, out, base, off_mesh = check.reference_call(
            c.ref_cfg, scene, snap, pixels, spc)
        got = st.accum.reshape(4, -1)[:, pixels]
        numbers = check.compare(acc, out, base, got,
                                st.output.reshape(3, -1)[:, pixels])
        bad = torch.nonzero((got[:3] != acc[:3]).any(0)).squeeze(1).tolist()
        seen = []
        if bad and witness:
            if plain is None:
                plain = type(renderer.program)(
                    cfg, scene=renderer.program.scene, backend="torch",
                    device=dev, steps_per_call=spc)
            wst = plain.step(dataclasses.replace(
                before, accum=before.accum.clone(),
                output=before.output.clone()), camera.packed())
            wit = wst.accum.reshape(4, -1)[:, pixels]
        done = spp * schedule.touches(c.ref_cfg, 0, call * spc)
        during = spp * schedule.touches(c.ref_cfg, call * spc,
                                        (call + 1) * spc)
        for i in bad[:10]:
            p, t = int(pixels[i]), int(tiles[i])
            entry = {"row": p // wp, "col": p % wp,
                     "tile": [t % tcx, t // tcx],
                     "program": got[:3, i].tolist(),
                     "reference": acc[:3, i].tolist(),
                     "before": base[:, i].tolist()}
            if witness:
                entry["witness"] = wit[:3, i].tolist()
            entry["samples"] = [s for s in reference_samples(
                c.ref_cfg, scene, view, p, int(done[t]), int(during[t]))
                if any(s[1])]
            seen.append(entry)
        yield {"call": call, "numbers": numbers, "off_mesh": off_mesh,
               "differ": len(bad), "pixels": seen}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--witness", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.scan: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for line in scan(args.workload, args.seed, args.calls, args.first,
                     args.stride, args.witness):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
