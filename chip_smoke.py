"""On-card smoke test of the l2n_tpu_torch port: builds the CUDA kernels
from this checkout, holds each against its plain torch version and the
JAX package's recorded golden, drives the main path (Application ->
Renderer -> SphereProgram -> render step -> sphere_pt kernel) at the
default 1280x720 config, and times kernel and plain versions.

    python3 chip_smoke.py          # needs one CUDA card; no arguments

Imports neither jax nor any l2n_tpu module other than l2n_tpu.config.
Every phase prints one line; a failed gate raises, so the script exits
nonzero without its last line. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "sphere_pt_256x128_4spp.npz"


def phase(n: int, text: str) -> None:
    print(f"[phase {n}] {text}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"gate failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_calls(fn, warm: int, n: int) -> float:
    """Device ms per call of fn() from CUDA events over n calls."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def timed_steps(step, state, cam, n: int):
    """(device ms/step from CUDA events, host ms/step to a synchronize,
    state) over n steps, after the caller's warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        state = step(state, cam)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    return start.elapsed_time(end) / n, host_ms, state


def profile_steps(step, state, cam, n: int):
    """(sphere_pt kernel device ms per launch, device busy share between
    the first and the last device event, state) from torch.profiler over n
    steps; (None, None, state) where the profiler recorded no device time.
    A short profile first takes the profiler's own start-up cost."""
    from torch.profiler import ProfilerActivity, profile
    for steps in (2, n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                state = step(state, cam)
            torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kern = [e for e in dev if "sphere_pt_kernel" in e.name]
    if not kern:
        return None, None, state
    kernel_ms = sum(e.time_range.elapsed_us() for e in kern) / len(kern) / 1e3
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    busy = sum(e.time_range.elapsed_us() for e in dev) / span
    return kernel_ms, busy, state


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    sys.path.insert(0, str(ROOT))
    from l2n_tpu.config import RenderConfig
    from l2n_tpu_torch.app.application import Application
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.ops.kernels import build
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt, sphere_pt_plain
    from l2n_tpu_torch.ops.kernels.uv_demo import uv_demo, uv_demo_plain
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.step import build_render_step
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    from l2n_tpu_torch.scene.spheres import compute_spheres
    from l2n_tpu_torch.utils.image import write_png

    dev = torch.device("cuda")
    card = card_line()
    # --- 1: card, versions, build ------------------------------------------
    lib_path, build_s = build.build()
    build.load()
    ptxas = [ln.strip() for ln in lib_path.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    phase(1, f"card: {card}; torch {torch.__version__}, CUDA "
             f"{torch.version.cuda}; kernels built in {build_s:.1f} s "
             f"({lib_path.name}); ptxas: {' | '.join(ptxas)}")

    # --- 2: uv_demo kernel vs plain at 720x1280 -----------------------------
    t = torch.tensor([0.7], dtype=torch.float32, device=dev)
    before = launches["uv_demo"]
    got = uv_demo(t, 720, 1280)
    want = uv_demo_plain(t, 720, 1280)
    torch.cuda.synchronize()
    uv_err = float((got - want).abs().max())
    require(launches["uv_demo"] == before + 1, "uv_demo launch counted")
    require(uv_err <= 1e-5, f"uv_demo max abs err {uv_err} <= 1e-5")
    uv_ms = timed_calls(lambda: uv_demo(t, 720, 1280), 5, 200)
    uv_plain_ms = timed_calls(lambda: uv_demo_plain(t, 720, 1280), 5, 200)
    phase(2, f"uv_demo kernel vs plain (3,720,1280): max abs err {uv_err:.3e}"
             f" (gate 1e-5); kernel {uv_ms:.4f} ms/call, plain "
             f"{uv_plain_ms:.4f} ms/call (CUDA events); card: {card}")

    # --- 3: the sphere golden through backend="cuda" ------------------------
    with np.load(GOLDEN) as data:
        gcfg = RenderConfig.from_json(bytes(data["config"]).decode())
        gwant = data["accum"]
    step = build_render_step(gcfg, compute_spheres(
        gcfg.sphere_count, gcfg.world_size, gcfg.scene_seed), backend="cuda")
    st = init_frame_state(gcfg, dev)
    gcam = Camera.from_config(gcfg).packed()
    for _ in range(4):
        st = step(st, gcam)
    torch.cuda.synchronize()
    ggot = st.accum.cpu().numpy()
    require(np.array_equal(ggot[3], gwant[3]), "golden accum[3] equal")
    gd = np.abs(ggot - gwant)
    gflip = float((gd > 1e-3).mean())
    gmean = np.abs(ggot[:3] / np.maximum(ggot[3], 1)
                   - gwant[:3] / np.maximum(gwant[3], 1))
    grmse = float(np.sqrt((gmean ** 2).mean()))
    require(gflip < 0.03, f"golden |d|>1e-3 fraction {gflip} < 0.03")
    require(grmse < 0.03, f"golden mean-image RMSE {grmse} < 0.03")
    phase(3, f"sphere golden 256x128 4 steps via backend=cuda: accum[3] "
             f"equal, |d|>1e-3 fraction {gflip:.3e} (gate 0.03), mean-image "
             f"RMSE {grmse:.3e} (gate 0.03)")

    # --- 4: kernel vs plain at the default config, four full frames ---------
    # (one frame is 1 spp, which lights 2.9% of the default view; at 4 spp,
    # the golden's sample count, 8.3% is lit and the coverage gate bites)
    cfg = RenderConfig().validate()
    scene = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed,
                            device=dev)
    spheres = scene.packed()
    tiles = torch.as_tensor(tile_grid(cfg)).to(dev)
    cam = Camera.from_config(cfg).packed()
    k = cfg.effective_tiles_per_step
    ka = init_frame_state(cfg, dev)
    pa = init_frame_state(cfg, dev)
    frames4 = 4
    steps = frames4 * cfg.tile_count // k
    for i in range(steps):
        sched = scheduled_tiles(tiles, i * k % cfg.tile_count, k)
        sphere_pt(cfg, sched, cam, spheres, ka.accum, ka.output)
        sphere_pt_plain(cfg, sched, cam, spheres, pa.accum, pa.output)
    torch.cuda.synchronize()
    kacc, kout = ka.accum.cpu().numpy(), ka.output.cpu().numpy()
    pacc, pout = pa.accum.cpu().numpy(), pa.output.cpu().numpy()
    require(np.array_equal(kacc[3], pacc[3]), "kernel/plain accum[3] equal")
    require((kacc[3] == frames4 * cfg.spp_per_step).all(),
            f"{frames4} full frames rendered")
    rmse = float(np.sqrt(((kacc - pacc) ** 2).mean()))
    max_err = float(np.abs(kacc - pacc).max())
    flips = float((np.abs(kout - pout) > 1e-3).mean())
    lit = float((pacc[:3, :cfg.height, :cfg.width].max(0) > 0).mean())
    require(rmse < 1e-3, f"kernel/plain accum RMSE {rmse} < 1e-3")
    require(flips < 2e-3, f"kernel/plain output flip fraction {flips} < 2e-3")
    require(lit > 0.05, f"lit coverage {lit} > 0.05")
    phase(4, f"sphere_pt kernel vs plain, default {cfg.width}x{cfg.height}, "
             f"{steps} steps x {k} tiles: accum RMSE {rmse:.3e} (gate 1e-3), "
             f"max abs {max_err:.3e}, output flip fraction {flips:.3e} "
             f"(gate 2e-3), lit {lit:.4f}")

    # --- 5: the main path through Application -------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        app = Application(RenderConfig(), backend="cuda", device="cuda",
                          workdir=tmp)
        frames = app.cfg.tile_count * 10 // app.cfg.effective_tiles_per_step
        reset_launches()
        state = app.run(frames)
        torch.cuda.synchronize()
        path_launches = dict(launches)
        require(path_launches.get("sphere_pt", 0) == frames,
                f"sphere_pt launched {path_launches.get('sphere_pt', 0)} "
                f"times in {frames} main-path steps")
        spp = state.accum[3, :cfg.height, :cfg.width]
        require(bool((spp == 10).all()), "every visible pixel holds 10 "
                                         "samples")
        img = app.renderer.display()
        require(bool(np.isfinite(img).all()), "output finite")
        main_lit = float((img.max(-1) > 0).mean())
        require(main_lit > 0.05, f"main-path lit coverage {main_lit} > 0.05")
        png_size = write_png(Path(tmp) / "frame_main.png", img).stat().st_size
        require(png_size > 1000, "PNG written")
    phase(5, f"main path: Application(RenderConfig(), backend=cuda) ran "
             f"{frames} steps, sphere_pt launches {path_launches}, 10 spp "
             f"everywhere, finite, lit {main_lit:.4f}, PNG "
             f"{png_size} bytes")

    # --- timings: kernel and plain, reference and whole-frame schedules -----
    timings = {}
    for label, tcfg in (("10-tile", cfg),
                        ("whole-frame", cfg.replace(
                            tiles_per_step=cfg.tile_count))):
        samples = (tcfg.effective_tiles_per_step * tcfg.tile_height
                   * tcfg.tile_width * tcfg.spp_per_step)
        for backend, warm, n in (("cuda", 3, 50), ("torch", 1, 3)):
            tstep = build_render_step(tcfg, scene, backend=backend,
                                      device=dev)
            tst = init_frame_state(tcfg, dev)
            for _ in range(warm):
                tst = tstep(tst, cam)
            dev_ms, host_ms, tst = timed_steps(tstep, tst, cam, n)
            timings[(label, backend)] = dev_ms
            if backend == "cuda":
                k_ms, busy, tst = profile_steps(tstep, tst, cam, 20)
                print(f"[profile] {label} backend=cuda: sphere_pt_kernel "
                      + ("not measured (no device time in the profile)"
                         if k_ms is None else
                         f"{k_ms:.4f} ms/launch (torch.profiler), device "
                         f"busy {busy:.3f} of the span from first to last device "
                         f"event")
                      + f"; card: {card}", flush=True)
            print(f"[timing] {label} ({tcfg.effective_tiles_per_step} tiles,"
                  f" {samples} samples/step) backend={backend}: "
                  f"{dev_ms:.4f} ms/step (CUDA events), {host_ms:.4f} ms/step"
                  f" (host clock to sync), {samples / dev_ms / 1e3:.2f} "
                  f"Msamples/s; card: {card}", flush=True)
            del tst, tstep
            torch.cuda.empty_cache()

    print(json.dumps({"kernels": [{
        "name": "sphere_pt", "route": "cuda",
        "source": "l2n_tpu_torch/csrc/sphere_pt.cu",
        "replaces": "l2n_tpu/ops/kernels/sphere_pt.py:214",
        "launches": path_launches.get("sphere_pt", 0),
        "max_abs_err": max_err,
        "tolerance": "accum RMSE < 1e-3, output |d|>1e-3 fraction < 2e-3",
        "ms": timings[("10-tile", "cuda")],
        "plain_ms": timings[("10-tile", "torch")]}]}))
    print(card)  # nvidia-smi name, power.limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
