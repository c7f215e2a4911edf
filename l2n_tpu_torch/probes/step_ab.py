"""Device time of the fused step kernels, sphere_pt and triangle_pt, at the
default configs' two schedules (the reference's 10 tiles and whole-frame
steps of 230 tiles), for holding two versions of the kernels against each
other on one card in one call.

    # the kernels of the tree at DIR (e.g. a `git archive` of the parent
    # commit) and of this tree, in turns: DIR, this, this, DIR
    python3 l2n_tpu_torch/probes/step_ab.py --parent DIR

Each measurement runs in a process of its own that imports the package
from its tree (`--root`), renders from a zero frame state with the default
camera, and times N back-to-back calls of the public wrapper captured once
into a CUDA graph and replayed between CUDA events, the best of 3 replays:
the kernels' device time without the host's dispatch. Needs one CUDA card;
prints one JSON line per process and a summary, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
THIS_TREE = HERE.parents[2]
CALLS = {"10-tile": 50, "whole-frame": 20}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(torch, fn, n: int, rounds: int = 3) -> float:
    """Device ms per call of fn() over n calls captured into one CUDA graph,
    the best of `rounds` replays (the first replay uploads the graph)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(rounds + 1):
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def _families(root: Path):
    """(torch, {family: (module, cfg, scene argument)}) of the tree at
    root, on the card."""
    sys.path.insert(0, str(root))
    import torch
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.ops.kernels import sphere_pt, triangle_pt
    from l2n_tpu_torch.scene import build_triangle_scene, compute_spheres
    assert Path(sphere_pt.__file__).resolve().is_relative_to(root)
    dev = torch.device("cuda")
    cfg = RenderConfig().validate()
    spheres = compute_spheres(cfg.sphere_count, cfg.world_size,
                              cfg.scene_seed, device=dev).packed()
    tcfg = RenderConfig(scene_kind="triangle").validate()
    buf = triangle_pt.TriangleBuffers.from_scene(build_triangle_scene(
        compute_spheres(tcfg.sphere_count, tcfg.world_size, tcfg.scene_seed),
        tcfg.disc_lat, tcfg.disc_long), dev)
    cam = Camera.from_config(cfg).packed()
    return torch, cam, {"sphere_pt": (sphere_pt, cfg, spheres),
                        "triangle_pt": (triangle_pt, tcfg, buf)}


def _schedules(torch, cfg):
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    tiles = torch.as_tensor(tile_grid(cfg)).to("cuda")
    return {"10-tile": (cfg, scheduled_tiles(tiles, 0, 10)),
            "whole-frame": (cfg.replace(tiles_per_step=cfg.tile_count),
                            scheduled_tiles(tiles, 0, cfg.tile_count))}


def measure_tree(root: Path) -> dict:
    """ms per call of each family's public wrapper, per schedule."""
    torch, cam, families = _families(root)
    from l2n_tpu_torch.render.state import init_frame_state
    times = {}
    for name, (mod, cfg, scene) in families.items():
        kernel = getattr(mod, name)
        for label, (scfg, sched) in _schedules(torch, cfg).items():
            st = init_frame_state(scfg, torch.device("cuda"))
            times[f"{name} {label}"] = graph_ms(torch, lambda: kernel(
                scfg, sched, cam, scene, st.accum, st.output), CALLS[label])
    return {"root": str(root), "card": card(), "ms": times}


def _run(args) -> dict:
    proc = subprocess.run([sys.executable, str(HERE), *args],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"step_ab {args} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="the other tree: measure DIR, this, this, DIR")
    ap.add_argument("--root", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.root is not None:  # one measurement, in this process
        print(json.dumps(measure_tree(args.root.resolve())), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent DIR")
    turns = [args.parent.resolve(), THIS_TREE, THIS_TREE,
             args.parent.resolve()]
    runs = []
    for root in turns:
        runs.append(_run(["--root", str(root)]))
        print(json.dumps(runs[-1]), flush=True)
    keys = runs[0]["ms"].keys()
    summary = {k: {"parent": [runs[0]["ms"][k], runs[3]["ms"][k]],
                   "this": [runs[1]["ms"][k], runs[2]["ms"][k]]}
               for k in keys}
    print(json.dumps({"turns": ["parent", "this", "this", "parent"],
                      "ms": summary}), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
