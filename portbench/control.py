"""The control of the output check, and the check's readings over many
seeds in one process: for each seed, a short window of the cell's own
traffic at its own size, then its snapshots judged three ways against the
float32 reference: the program (the sound reading), the reference itself
computed in bfloat16, the nearest precision below the configuration's
float32 (the control), and the program with one fault planted under the
timed path where asked (`--fault`), or rendering with a render field of
the configuration changed while the reference keeps it (`--setting`, e.g.
mis=false). The benchmark's runs do not run this.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 2] [--fault NAME] \\
        [--setting KEY=JSON ...]

Prints one JSON line per seed and reading, and the largest sound and the
smallest control reading of each number; on standard error, per seed, the
off-mesh tally of the float32 reference's triangle sweeps and of the
control's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check, harness
from portbench.reference.tracer import make_scene

FAULTS = ("unchanged", "half_batch", "altered")


def plant(fault: str, set_attr=setattr):
    """Plant `fault` under the timed path: wrap the port's step kernels so
    that a step leaves its state unchanged, renders only the first half of
    its scheduled tiles, or alters the radiance it produced (the red sums
    of the scheduled tiles' pixels scaled by 1.01). `set_attr` installs
    the wrappers (a test's monkeypatch undoes them)."""
    import l2n_tpu_torch.render.step as step_mod
    from l2n_tpu_torch.ops.kernels.common import tile_pixel_coords

    def wrap(kernel):
        def faulty(cfg, sched, cam, buffers, accum, output, rng_state,
                   **kw):
            if fault == "unchanged":
                return None
            if fault == "half_batch":
                half = sched[:max(1, sched.shape[0] // 2)].contiguous()
                return kernel(cfg, half, cam, buffers, accum, output,
                              rng_state, **kw)
            kernel(cfg, sched, cam, buffers, accum, output, rng_state, **kw)
            row, col = tile_pixel_coords(cfg, sched)
            flat = (row * cfg.padded_width + col).reshape(-1)
            red = accum[0].view(-1)
            red[flat] = red[flat] * 1.01
            return None
        return faulty

    for name in ("sphere_pt", "triangle_pt", "sphere_pt_plain",
                 "triangle_pt_plain"):
        set_attr(step_mod, name, wrap(getattr(step_mod, name)))


def readings(name: str, seed: int, seconds: float, device, backend: str,
             control: bool, overrides=None, mix_overrides=None,
             program_overrides=None) -> list:
    """[(reading, {number: worst value})] of one seed; `program_overrides`
    replace render fields of the program's configuration only."""
    c = harness.load_cell(name, seed, overrides, mix_overrides)
    prog = c if not program_overrides else harness.load_cell(
        name, seed, dict(overrides or {}, **program_overrides), mix_overrides)
    run = harness.measure(prog, seed, seconds, False, device, backend)
    spc = int(c.mix["steps_per_call"])
    pixels = check.check_pixels(c.ref_cfg, int(c.cell["check"]["pixels"]),
                                seed, run["device"])
    scene = make_scene(c.ref_cfg, run["device"])
    low = make_scene(c.ref_cfg, run["device"], torch.bfloat16) \
        if control else None
    worst = {"program": {}, "control": {}}
    off_mesh = {"reference": {}, "control": {}}
    for snap in run["snaps"]:
        acc, out, base, off = check.reference_call(c.ref_cfg, scene, snap,
                                                   pixels, spc)
        got_off = {"reference": off}
        got = {"program": check.compare(
            acc, out, base, snap.accum.reshape(4, -1)[:, pixels].float(),
            snap.output.reshape(3, -1)[:, pixels].float())}
        if control:
            lacc, lout, _, got_off["control"] = check.reference_call(
                c.ref_cfg, low, snap, pixels, spc, torch.bfloat16)
            got["control"] = check.compare(acc, out, base, lacc, lout)
        for kind, numbers in got.items():
            for k, v in numbers.items():
                worst[kind][k] = check.worse(worst[kind].get(k, 0.0), v)
        for kind, tally in got_off.items():
            off_mesh[kind] = {k: off_mesh[kind].get(k, 0) + v
                              for k, v in tally.items()}
    print(f"[off_mesh] seed {seed}: {off_mesh}", file=sys.stderr)
    return [(k, v) for k, v in worst.items() if v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=FAULTS)
    ap.add_argument("--setting", action="append", default=[],
                    metavar="KEY=JSON")
    args = ap.parse_args(argv)
    settings = {k: json.loads(v) for k, v in
                (a.split("=", 1) for a in args.setting)}
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    if args.fault:
        plant(args.fault)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    summary = {}
    for seed in seeds:
        t0 = time.perf_counter()
        for kind, numbers in readings(args.workload, seed, args.seconds,
                                      "cuda", "cuda", seed in control_seeds,
                                      program_overrides=settings):
            if kind == "program" and args.fault:
                kind = f"fault:{args.fault}"
            elif kind == "program" and settings:
                kind = "setting:" + ",".join(args.setting)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": kind, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            agg = summary.setdefault(kind, {})
            for k, v in numbers.items():
                pick = min if kind == "control" else max
                agg[k] = v if k not in agg else pick(agg[k], v)
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
