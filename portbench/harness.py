"""Runs one cell of BENCHMARK.json once: finds its configuration, traffic
mix, cell file and metric readers by name, builds the port's renderer,
warms up, measures, checks the outputs against the reference, and returns
the result line.

Everything that belongs to one configuration, mix, cell or metric is a
file of its own under portbench/, found by the name in BENCHMARK.json:
configs/<config>.json, traffic/<mix>.json, cells/<cell>.json and
metrics/<metric>.py (a `read(run)` that returns the metric or None). The
program under test is `l2n_tpu_torch`, driven through its app entry point
`render/renderer.py` `Renderer.step(camera)`.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check
from portbench.counts import floor
from portbench.generator import Generator

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# What is left out of sys.modules by the end of a run, by top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "l2n_tpu")
TRACED_SECONDS = 1.0


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


@functools.cache
def reader(name: str):
    """The `read` of metrics/<name>.py."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict      # configs/<config>.json
    mix: dict         # traffic/<mix>.json
    cell: dict        # cells/<cell>.json
    ref_cfg: dict     # every render field, as the reference reads them

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_cell(name: str, seed: int, overrides: dict | None = None,
              mix_overrides: dict | None = None) -> Cell:
    """The cell `name` with RenderConfig.seed = `seed`; `overrides` replace
    render fields and `mix_overrides` the mix's (the CPU tests' small
    runs)."""
    m = manifest()
    wl = next((w for w in m["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == wl["config"])
    config = _json(ROOT / conf["file"])
    mix = dict(_json(PKG / "traffic" / f"{wl['traffic']}.json"),
               **(mix_overrides or {}))
    cell = _json(PKG / "cells" / f"{name}.json")
    ref = dict(config["render"])
    for key in ("tiles_per_step", "spp_per_step"):
        ref[key] = mix[key]
    ref.update(overrides or {})
    ref["seed"] = int(seed)
    ref["padded_width"] = (-(-ref["width"] // ref["tile_width"])
                           * ref["tile_width"])
    return Cell(name, wl, config, mix, cell, ref)


def port_config(ref: dict):
    """The port's RenderConfig of the reference fields."""
    from l2n_tpu_torch.config import RenderConfig
    known = {f.name for f in dataclasses.fields(RenderConfig)}
    return RenderConfig(**{k: v for k, v in ref.items()
                           if k in known}).validate()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_renderer(c: Cell, device, backend: str):
    """(the port's Renderer over the cell's program, the triangle scene's
    set-up seconds or None)."""
    from l2n_tpu_torch.render.program import SphereProgram, TriangleProgram
    from l2n_tpu_torch.render.renderer import Renderer
    cfg = port_config(c.ref_cfg)
    spc = int(c.mix["steps_per_call"])
    pack_s = None
    if cfg.scene_kind == "sphere":
        program = SphereProgram(cfg, backend=backend, device=device,
                                steps_per_call=spc)
    else:
        from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
        from l2n_tpu_torch.scene.spheres import compute_spheres
        from l2n_tpu_torch.scene.tessellate import build_triangle_scene
        t0 = time.perf_counter()
        scene = build_triangle_scene(
            compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed),
            cfg.disc_lat, cfg.disc_long)
        buffers = TriangleBuffers.from_scene(scene, device)
        _sync(device)
        pack_s = time.perf_counter() - t0
        program = TriangleProgram(cfg, scene=buffers, backend=backend,
                                  device=device, steps_per_call=spc)
    return Renderer({program.name: program}), pack_s


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def measure(c: Cell, seed: int, seconds: float, trace: bool, device,
            backend: str = "cuda", t_start: float | None = None) -> dict:
    """Set-up, warm-up and the measured window of one run of cell `c`, and
    with `trace` a traced stretch after it; the program is freed after.
    Returns what the metrics and the check read (`run_cell`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    if trace and device.type != "cuda":
        raise ValueError("a traced run needs the card")
    from l2n_tpu_torch.camera.camera import Camera
    cfg = port_config(c.ref_cfg)
    t_import = time.perf_counter()
    renderer, pack_s = build_renderer(c, device, backend)
    t_built = time.perf_counter()
    k = cfg.effective_tiles_per_step
    pixels_per_step = k * cfg.tile_height * cfg.tile_width
    gen = Generator(c.mix, renderer,
                    lambda view: Camera.from_config(cfg, view_matrix=view),
                    np.asarray(c.config["view"], np.float32), seed,
                    pixels_per_step * cfg.spp_per_step, device)
    spec = c.cell["check"]
    snaps = []
    # Warm-up: the first call builds or loads the kernel library and runs
    # eagerly, the second captures its CUDA graph, the third replays it.
    first = gen.call(snapshot=True)
    if spec.get("start"):
        snaps.append(first)
    del first
    t_first = time.perf_counter()
    gen.call()
    gen.call()
    _sync(device)
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    phases = {"imports": t_import - t_start, "renderer": t_built - t_import,
              "first_call": t_first - t_built, "capture": t_warm - t_first}

    times = check.snapshot_times(seed, seconds, int(spec["window_calls"]))
    window, window_snaps = gen.run(seconds, times, timed_events=trace)
    snaps += window_snaps
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    profile = None
    if trace:
        from portbench.devtrace import traced_stretch
        profile = traced_stretch(gen, TRACED_SECONDS)
    del gen, renderer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"setup_s": setup_s, "setup_phases": phases, "pack_s": pack_s,
            "window": window, "snaps": snaps, "memory_peak": memory_peak,
            "profile": profile, "pixels_per_step": pixels_per_step,
            "samples_per_step": pixels_per_step * cfg.spp_per_step,
            "kernel": ("sphere_pt" if cfg.scene_kind == "sphere"
                       else "triangle_pt"), "device": device}


def work_bound(c: Cell, run: dict, counts: dict) -> dict:
    """The least seconds of one step by the reference's work counts
    (counts/floor.py), and what bounds them. A call's N steps are bounded
    as one launch, which reads the scene once: each step does its own
    samples and pixels and reads 1/N of the scene."""
    kind = "sphere" if run["kernel"] == "sphere_pt" else "triangle"
    n_obj = c.ref_cfg["sphere_count"]
    n_tri = (n_obj * 2 * c.ref_cfg["disc_lat"] * c.ref_cfg["disc_long"]
             if kind == "triangle" else 0)
    seconds, by = floor.launch_bound(
        counts, kind, c.ref_cfg["rng"], run["samples_per_step"],
        run["pixels_per_step"], floor.scene_bytes(kind, n_obj, n_tri)
        / int(c.mix["steps_per_call"]))
    return {"seconds": seconds, "by": by}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             backend: str = "cuda", overrides: dict | None = None,
             t_start: float | None = None,
             mix_overrides: dict | None = None) -> tuple[dict, list]:
    """One run of the cell: (the result line as a dict, the check's lines
    "<number> <value> limit <limit>")."""
    c = load_cell(name, seed, overrides, mix_overrides)
    run = measure(c, seed, seconds, trace, device, backend, t_start)
    device = run["device"]
    spec = c.cell["check"]
    t_check = time.perf_counter()
    pixels = check.check_pixels(c.ref_cfg, int(spec["pixels"]), seed, device)
    numbers, failed, counts, off_mesh = check.judge(
        c.ref_cfg, run["snaps"], pixels, int(c.mix["steps_per_call"]),
        c.cell["limits"], count_work=trace)
    print(f"[check] {len(run['snaps'])} calls, {pixels.numel()} pixels: "
          f"{time.perf_counter() - t_check!r} s; the sweep's off-mesh rule "
          f"{off_mesh}", file=sys.stderr)
    lines = [f"{k} {v!r} limit {lim!r}" for k, (v, lim) in numbers.items()]
    card = card_line() if device.type == "cuda" else device.type
    print(f"[setup] {run['setup_s']!r} s: " + ", ".join(
        f"{k} {v!r}" for k, v in run["setup_phases"].items())
        + f"; pack_s {run['pack_s']!r}; card {card}", file=sys.stderr)
    run["floor"] = None
    if counts is not None:
        run["floor"] = work_bound(c, run, counts)
        print(f"[floor] {run['kernel']}: {run['floor']['seconds'] * 1e3!r} "
              f"ms per step, bound by {run['floor']['by']}; the checked "
              f"lanes' counts {counts}; card {card}", file=sys.stderr)

    m = manifest()
    metrics = {}
    for spec_m in (m["per_layer"] if trace else m["end_to_end"]):
        if "workloads" in spec_m and name not in spec_m["workloads"]:
            continue
        value = reader(spec_m["name"])(run)
        if value is not None:
            metrics[spec_m["name"]] = {"value": value, "unit": spec_m["unit"]}
    window = run["window"]
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": c.chips, "memory_peak_bytes": int(run["memory_peak"])}
    result = {"correct": check.passes(numbers), "attempted": window.calls,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        prof = run["profile"]
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["card"] = card
    result["window"] = {"seconds": window.seconds, "calls": window.calls,
                        "frames_timed": len(window.frame_ms),
                        "snapshots": len(run["snaps"])}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in numbers.items()}
    return result, lines


def forbidden_modules() -> list:
    """Top-level names of FORBIDDEN that sys.modules holds."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))
