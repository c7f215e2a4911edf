"""On-card smoke test of the l2n_tpu_torch port: builds the CUDA kernels
from this checkout, holds each against its plain torch version and the
JAX package's recorded goldens, drives both renderers' main paths
(Application -> Renderer -> SphereProgram / TriangleProgram -> render step
-> sphere_pt / triangle_pt kernel) at the default 1280x720 config, and
times kernel and plain versions.

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
TRI_GOLDEN = ROOT / "tests" / "golden" / "triangle_pt_256x128_4spp.npz"


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


def profile_steps(step, state, cam, n: int, kernel: str):
    """(device ms per launch of the kernel named `kernel`, device busy share
    between the first and the last device event, state) from torch.profiler
    over n steps; (None, None, state) where the profiler recorded no device
    time. A short profile first takes the profiler's own start-up cost."""
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
    kern = [e for e in dev if kernel in e.name]
    if not kern:
        return None, None, state
    kernel_ms = sum(e.time_range.elapsed_us() for e in kern) / len(kern) / 1e3
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    busy = sum(e.time_range.elapsed_us() for e in dev) / span
    return kernel_ms, busy, state


def compare(kacc, kout, pacc, pout, cfg):
    """Kernel vs plain gates of a frame: accum[3] equal, accum RMSE < 1e-3,
    output flip fraction < 2e-3, lit coverage > 5%. Returns (rmse, max abs,
    flips, lit)."""
    require(np.array_equal(kacc[3], pacc[3]), "kernel/plain accum[3] equal")
    rmse = float(np.sqrt(((kacc - pacc) ** 2).mean()))
    max_err = float(np.abs(kacc - pacc).max())
    flips = float((np.abs(kout - pout) > 1e-3).mean())
    lit = float((pacc[:3, :cfg.height, :cfg.width].max(0) > 0).mean())
    require(rmse < 1e-3, f"kernel/plain accum RMSE {rmse} < 1e-3")
    require(flips < 2e-3, f"kernel/plain output flip fraction {flips} < 2e-3")
    require(lit > 0.05, f"lit coverage {lit} > 0.05")
    return rmse, max_err, flips, lit


def golden_gates(got, want):
    """tests/test_golden_render.py's cross-implementation gates; returns
    (|d|>1e-3 fraction, mean-image RMSE)."""
    require(np.array_equal(got[3], want[3]), "golden accum[3] equal")
    flip = float((np.abs(got - want) > 1e-3).mean())
    mean = np.abs(got[:3] / np.maximum(got[3], 1)
                  - want[:3] / np.maximum(want[3], 1))
    rmse = float(np.sqrt((mean ** 2).mean()))
    require(flip < 0.03, f"golden |d|>1e-3 fraction {flip} < 0.03")
    require(rmse < 0.03, f"golden mean-image RMSE {rmse} < 0.03")
    return flip, rmse


def kernel_vs_plain(kernel, plain, cfg, buffers, cam, steps):
    """Render `steps` whole-frame steps with the kernel and with its plain
    version from zeroed states; returns the gates of `compare`."""
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    dev = torch.device("cuda")
    tiles = torch.as_tensor(tile_grid(cfg)).to(dev)
    k = cfg.effective_tiles_per_step
    ka = init_frame_state(cfg, dev)
    pa = init_frame_state(cfg, dev)
    for i in range(steps):
        sched = scheduled_tiles(tiles, i * k % cfg.tile_count, k)
        kernel(cfg, sched, cam, buffers, ka.accum, ka.output)
        plain(cfg, sched, cam, buffers, pa.accum, pa.output)
    torch.cuda.synchronize()
    return compare(ka.accum.cpu().numpy(), ka.output.cpu().numpy(),
                   pa.accum.cpu().numpy(), pa.output.cpu().numpy(), cfg)


def run_main_path(app, frames: int, name: str):
    """Drive `frames` steps of `app`'s current renderer with the launch
    counts zeroed just before and read just after; checks 10 spp
    everywhere, a finite lit image and a written PNG. Returns (launches,
    lit, PNG bytes)."""
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.utils.image import write_png
    cfg = app.renderer.cfg
    reset_launches()
    state = app.run(frames, save_camera=False)
    torch.cuda.synchronize()
    path_launches = dict(launches)
    require(path_launches.get(name, 0) == frames,
            f"{name} launched {path_launches.get(name, 0)} times in "
            f"{frames} main-path steps")
    spp = state.accum[3, :cfg.height, :cfg.width]
    require(bool((spp == 10).all()), "every visible pixel holds 10 samples")
    img = app.renderer.display()
    require(bool(np.isfinite(img).all()), "output finite")
    lit = float((img.max(-1) > 0).mean())
    require(lit > 0.05, f"main-path lit coverage {lit} > 0.05")
    png_size = write_png(app.workdir / f"frame_{name}.png", img).stat().st_size
    require(png_size > 1000, "PNG written")
    return path_launches, lit, png_size


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    sys.path.insert(0, str(ROOT))
    from l2n_tpu.config import RenderConfig
    from l2n_tpu_torch.app.application import Application
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.maths.linalg import look_at
    from l2n_tpu_torch.ops.kernels import build
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt, sphere_pt_plain
    from l2n_tpu_torch.ops.kernels.triangle_pt import (
        TriangleBuffers,
        triangle_pt,
        triangle_pt_plain,
    )
    from l2n_tpu_torch.ops.kernels.uv_demo import uv_demo, uv_demo_plain
    from l2n_tpu_torch.render.program import TriangleProgram
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.step import build_render_step
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    from l2n_tpu_torch.scene import (
        build_triangle_scene,
        load_obj,
        torus_field_obj,
    )
    from l2n_tpu_torch.scene.spheres import compute_spheres

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

    # --- 2: uv_demo: its path (one 720x1280 frame), then vs plain -----------
    t = torch.tensor([0.7], dtype=torch.float32, device=dev)
    reset_launches()
    got = uv_demo(t, 720, 1280)
    torch.cuda.synchronize()
    uv_launches = launches["uv_demo"]
    require(uv_launches == 1, "uv_demo launch counted")
    want = uv_demo_plain(t, 720, 1280)
    uv_err = float((got - want).abs().max())
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
    gflip, grmse = golden_gates(st.accum.cpu().numpy(), gwant)
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
    require((ka.accum[3].cpu().numpy() == frames4 * cfg.spp_per_step).all(),
            f"{frames4} full frames rendered")
    rmse, max_err, flips, lit = compare(
        ka.accum.cpu().numpy(), ka.output.cpu().numpy(),
        pa.accum.cpu().numpy(), pa.output.cpu().numpy(), cfg)
    phase(4, f"sphere_pt kernel vs plain, default {cfg.width}x{cfg.height}, "
             f"{steps} steps x {k} tiles: accum RMSE {rmse:.3e} (gate 1e-3), "
             f"max abs {max_err:.3e}, output flip fraction {flips:.3e} "
             f"(gate 2e-3), lit {lit:.4f}")
    del ka, pa

    with tempfile.TemporaryDirectory() as tmp:
        # --- 5: the sphere main path through Application -----------------
        app = Application(RenderConfig(), backend="cuda", device="cuda",
                          workdir=tmp, renderer_names=("spherePT",))
        frames = app.cfg.tile_count * 10 // app.cfg.effective_tiles_per_step
        sphere_launches, main_lit, png_size = run_main_path(app, frames,
                                                            "sphere_pt")
        phase(5, f"main path: Application(RenderConfig(), backend=cuda) ran "
                 f"{frames} steps, launches {sphere_launches}, 10 spp "
                 f"everywhere, finite, lit {main_lit:.4f}, PNG "
                 f"{png_size} bytes")
        del app

        # --- 6: the triangle golden through backend="cuda" ---------------
        with np.load(TRI_GOLDEN) as data:
            tcfg = RenderConfig.from_json(bytes(data["config"]).decode())
            twant, tvm = data["accum"], data["view_matrix"]
        prog = TriangleProgram(tcfg, backend="cuda")
        st = init_frame_state(tcfg, dev)
        tcam = Camera.from_config(tcfg, view_matrix=tvm).packed()
        for _ in range(4):
            st = prog.step(st, tcam)
        torch.cuda.synchronize()
        tflip, trmse = golden_gates(st.accum.cpu().numpy(), twant)
        # The kernel's primary-only AOVs on the golden's scene and camera.
        aov_err = {}
        for aov in ("tex_coords", "param_uv"):
            acfg = tcfg.replace(aov=aov)
            abuf = TriangleBuffers.from_scene(prog.scene, dev)
            ka, pa = init_frame_state(acfg, dev), init_frame_state(acfg, dev)
            sched = scheduled_tiles(torch.as_tensor(tile_grid(acfg)).to(dev),
                                    0, acfg.effective_tiles_per_step)
            triangle_pt(acfg, sched, tcam, abuf, ka.accum, ka.output)
            triangle_pt_plain(acfg, sched, tcam, abuf, pa.accum, pa.output)
            torch.cuda.synchronize()
            d = (ka.accum - pa.accum).abs()
            aov_err[aov] = float(d.max())
            require(float((d > 1e-4).float().mean()) < 1e-3,
                    f"{aov} kernel/plain |d|>1e-4 fraction < 1e-3")
        phase(6, f"triangle golden 256x128 (16 meshes, 1,024 triangles) 4 "
                 f"steps via backend=cuda: accum[3] equal, |d|>1e-3 fraction "
                 f"{tflip:.3e} (gate 0.03), mean-image RMSE {trmse:.3e} "
                 f"(gate 0.03); AOV kernel vs plain, 1 step: max abs "
                 f"{aov_err} (gate |d|>1e-4 fraction < 1e-3)")

        # --- 7: triangle_pt kernel vs plain, default triangle config -----
        # Four whole-frame steps: the same samples as 92 steps of 10 tiles
        # (1 spp lights 2.8% of the default view, 4 spp 8.1%).
        tri_cfg = RenderConfig(scene_kind="triangle").validate()
        whole = tri_cfg.replace(tiles_per_step=tri_cfg.tile_count)
        tri_scene = build_triangle_scene(compute_spheres(
            tri_cfg.sphere_count, tri_cfg.world_size, tri_cfg.scene_seed),
            tri_cfg.disc_lat, tri_cfg.disc_long)
        tri_buf = TriangleBuffers.from_scene(tri_scene, dev)
        rmse, tri_err, flips, lit = kernel_vs_plain(
            triangle_pt, triangle_pt_plain, whole, tri_buf, cam, 4)
        phase(7, f"triangle_pt kernel vs plain, default triangle config "
                 f"{whole.width}x{whole.height}, {tri_scene.total_triangles} "
                 f"triangles in {tri_scene.mesh_count} meshes, 4 whole-frame "
                 f"steps: accum RMSE {rmse:.3e} (gate 1e-3), max abs "
                 f"{tri_err:.3e}, output flip fraction {flips:.3e} (gate "
                 f"2e-3), lit {lit:.4f}")

        # --- 8: kernel vs plain on the multi-slab torus field -------------
        tori = load_obj(torus_field_obj())
        tori_buf = TriangleBuffers.from_scene(tori, dev)
        slabs = tori_buf.slab_count.cpu().numpy()
        require(bool((slabs > 1).all()), "every torus spans several slabs")
        # Aimed: 4 bound radii from the torus nearest the emissive torus 0,
        # on torus 0's side (0.1% of the default view is lit).
        b = tori_buf.mesh_bounds.cpu().numpy().astype(np.float64)
        j = 1 + int(np.argmin(np.linalg.norm(b[1:, :3] - b[0, :3], axis=1)))
        to_e = (b[0, :3] - b[j, :3]) / np.linalg.norm(b[0, :3] - b[j, :3])
        eye = b[j, :3] + to_e * 4.0 * np.sqrt(b[j, 3])
        vm = look_at(eye.astype(np.float32), b[j, :3].astype(np.float32),
                     np.array([0.0, 1.0, 0.0], np.float32))
        tori_cam = Camera.from_config(whole, view_matrix=vm).packed()
        rmse, tori_err, flips, lit = kernel_vs_plain(
            triangle_pt, triangle_pt_plain, whole, tori_buf, tori_cam, 1)
        phase(8, f"triangle_pt kernel vs plain, torus field "
                 f"({tori.total_triangles} triangles, {tori.mesh_count} "
                 f"meshes of {int(slabs.max())} slabs), aimed camera, 1 "
                 f"whole-frame step: accum RMSE {rmse:.3e} (gate 1e-3), max "
                 f"abs {tori_err:.3e}, output flip fraction {flips:.3e} "
                 f"(gate 2e-3), lit {lit:.4f}")
        del tori_buf

        # --- 9: the triangle main path through Application ----------------
        app = Application(RenderConfig(), backend="cuda", device="cuda",
                          workdir=tmp, initial_renderer="trianglePT")
        frames = app.cfg.tile_count * 10 // app.cfg.effective_tiles_per_step
        tri_launches, main_lit, png_size = run_main_path(app, frames,
                                                         "triangle_pt")
        require(tri_launches.get("sphere_pt", 0) == 0,
                "the triangle path launched no sphere kernel")
        phase(9, f"main path: Application(RenderConfig(), initial_renderer="
                 f"trianglePT, backend=cuda) ran {frames} steps, launches "
                 f"{tri_launches}, 10 spp everywhere, finite, lit "
                 f"{main_lit:.4f}, PNG {png_size} bytes")
        del app

    # --- timings: kernel and plain, reference and whole-frame schedules -----
    timings = {}
    families = (
        ("sphere_pt", cfg, scene, ((3, 50), (1, 3), (1, 3))),
        ("triangle_pt", tri_cfg, tri_scene, ((3, 50), (1, 3), (1, 2))))
    for name, fcfg, fscene, ((kw, kn), (pw, pn), (pw_whole, pn_whole)) in families:
        for label, tcfg in (("10-tile", fcfg),
                            ("whole-frame", fcfg.replace(
                                tiles_per_step=fcfg.tile_count))):
            samples = (tcfg.effective_tiles_per_step * tcfg.tile_height
                       * tcfg.tile_width * tcfg.spp_per_step)
            plain_runs = (pw, pn) if label == "10-tile" else (pw_whole,
                                                              pn_whole)
            for backend, (warm, n) in (("cuda", (kw, kn)),
                                       ("torch", plain_runs)):
                tstep = build_render_step(tcfg, fscene, backend=backend,
                                          device=dev)
                tst = init_frame_state(tcfg, dev)
                for _ in range(warm):
                    tst = tstep(tst, cam)
                dev_ms, host_ms, tst = timed_steps(tstep, tst, cam, n)
                timings[(name, label, backend)] = dev_ms
                if backend == "cuda":
                    k_ms, busy, tst = profile_steps(tstep, tst, cam, 20,
                                                    f"{name}_kernel")
                    print(f"[profile] {name} {label} backend=cuda: "
                          f"{name}_kernel "
                          + ("not measured (no device time in the profile)"
                             if k_ms is None else
                             f"{k_ms:.4f} ms/launch (torch.profiler), device "
                             f"busy {busy:.3f} of the span from first to "
                             f"last device event")
                          + f"; card: {card}", flush=True)
                print(f"[timing] {name} {label} "
                      f"({tcfg.effective_tiles_per_step} tiles, {samples} "
                      f"samples/step) backend={backend}: {dev_ms:.4f} "
                      f"ms/step (CUDA events), {host_ms:.4f} ms/step (host "
                      f"clock to sync), {samples / dev_ms / 1e3:.2f} "
                      f"Msamples/s; card: {card}", flush=True)
                del tst, tstep
                torch.cuda.empty_cache()

    def row(name, route, source, replaces, n, err, tol, ms, plain_ms):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "tolerance": tol, "ms": ms, "plain_ms": plain_ms}

    frame_tol = "accum RMSE < 1e-3, output |d|>1e-3 fraction < 2e-3"
    print(json.dumps({"kernels": [
        row("sphere_pt", "cuda", "l2n_tpu_torch/csrc/sphere_pt.cu",
            "l2n_tpu/ops/kernels/sphere_pt.py:214",
            sphere_launches.get("sphere_pt", 0), max_err, frame_tol,
            timings[("sphere_pt", "10-tile", "cuda")],
            timings[("sphere_pt", "10-tile", "torch")]),
        row("uv_demo", "cuda", "l2n_tpu_torch/csrc/uv_demo.cu",
            "l2n_tpu/ops/kernels/uv_demo.py:22", uv_launches, uv_err,
            "max abs err <= 1e-5", uv_ms, uv_plain_ms),
        row("triangle_pt", "cuda", "l2n_tpu_torch/csrc/triangle_pt.cu",
            "l2n_tpu/ops/kernels/triangle_pt.py:811",
            tri_launches.get("triangle_pt", 0), max(tri_err, tori_err),
            frame_tol, timings[("triangle_pt", "10-tile", "cuda")],
            timings[("triangle_pt", "10-tile", "torch")])]}))
    print(card)  # nvidia-smi name, power.limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
