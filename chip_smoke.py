"""On-card smoke test of the l2n_tpu_torch port: builds the CUDA kernels
from this checkout, holds each against its plain torch version and the
JAX package's recorded goldens, drives the main paths (Application ->
Renderer -> SphereProgram / TriangleProgram -> render step -> sphere_pt,
triangle_pt, or the wavefront step's three kernels) at the default
1280x720 config with every rng mode (threefry; tpu_hw, which is Philox on
the card; the stateful tinymt and tauslcg), runs the tpu_hw statistical
gates on the raw-bits kernel philox_bits and on renders, runs the three
probes (l2n_tpu_torch/probes: cond_cost, sweep_variants, onehot_recovery)
through their entry points with their kernels held against the plain
versions, holds sphere_pt and triangle_pt to their plain versions bit for
bit from views that make their per-tile cone cull hard (phase 22), runs
the wavefront step twice from one state to show that its image does not
depend on the order of pass A's survivor slots (phase 23), holds the
wavefront step to sphere_pt bit for bit at the 10-tile schedule, where
pass B splits each ray's sweeps over 8 lanes (phase 24), and times
kernel and plain versions beside the least time the card could take for
the same work.

    python3 chip_smoke.py          # needs one CUDA card; no arguments

Imports neither jax nor anything of the JAX package (l2n_tpu). Every phase
prints one line; a failed gate raises, so the script exits nonzero without
its last line. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()
GOLDEN = ROOT / "tests" / "golden" / "sphere_pt_256x128_4spp.npz"
TRI_GOLDEN = ROOT / "tests" / "golden" / "triangle_pt_256x128_4spp.npz"


def phase(n: int, text: str) -> None:
    print(f"[phase {n}] ({time.perf_counter() - T0:.1f} s) {text}",
          flush=True)


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


def timed_result(fn):
    """(fn(), device ms of that one call from CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def profile_steps(step, state, cam, n: int, kernels):
    """({kernel: device ms per launch}, device busy share between the first
    and the last device event, (device ms per step of every other device
    event, {its name: (events per step, device ms per step)}), state) from
    torch.profiler over n steps; a kernel the profiler recorded no device
    time for maps to None. A short profile first takes the profiler's own
    start-up cost."""
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
    per = {}
    for kernel in kernels:
        kern = [e for e in dev if kernel in e.name]
        per[kernel] = (sum(e.time_range.elapsed_us() for e in kern)
                       / len(kern) / 1e3) if kern else None
        if not kern:
            print(f"[profile] no device event named {kernel}; the window "
                  f"held {collections.Counter(e.name for e in dev)}",
                  flush=True)
    if not dev:
        return per, None, None, state
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    busy = sum(e.time_range.elapsed_us() for e in dev) / span
    rest = collections.defaultdict(list)
    for e in dev:
        if not any(k in e.name for k in kernels):
            rest[e.name[:60]].append(e.time_range.elapsed_us())
    other = (sum(map(sum, rest.values())) / n / 1e3,
             {k: (round(len(v) / n, 2), round(sum(v) / n / 1e3, 5))
              for k, v in rest.items()})
    return per, busy, other, state


def profile_calls(fn, n: int, kernel: str):
    """Device ms per launch of `kernel` over n calls of fn(), from
    torch.profiler; None if it recorded no device time."""
    per, _, _, _ = profile_steps(lambda state, cam: fn(), None, None, n,
                                 (kernel,))
    return per[kernel]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit, NaN included: the 32-bit patterns compared."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


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
    """Render `steps` steps with the kernel and with its plain version from
    fresh states; returns the gates of `compare` and whether the rng state
    planes ended bit-equal (None for the counter-based modes)."""
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    dev = torch.device("cuda")
    tiles = torch.as_tensor(tile_grid(cfg)).to(dev)
    k = cfg.effective_tiles_per_step
    ka = init_frame_state(cfg, dev)
    pa = init_frame_state(cfg, dev)
    for i in range(steps):
        sched = scheduled_tiles(tiles, i * k % cfg.tile_count, k)
        kernel(cfg, sched, cam, buffers, ka.accum, ka.output, ka.rng_state)
        plain(cfg, sched, cam, buffers, pa.accum, pa.output, pa.rng_state)
    torch.cuda.synchronize()
    state_eq = (None if ka.rng_state is None
                else torch.equal(ka.rng_state, pa.rng_state))
    return (*compare(ka.accum.cpu().numpy(), ka.output.cpu().numpy(),
                     pa.accum.cpu().numpy(), pa.output.cpu().numpy(), cfg),
            state_eq)


def pass_b_group(alive: int) -> int:
    """The group of lanes per ray that pass B's kernel picks for `alive`
    survivors on this card: csrc/wavefront.cuh group_size against the
    card's SMs x threads per SM (csrc/wavefront.cu pass_b_grid)."""
    props = torch.cuda.get_device_properties(0)
    threads = props.multi_processor_count * getattr(
        props, "max_threads_per_multi_processor", 2048)
    return 8 if alive * 8 <= threads else 1


def run_main_path(app, frames: int, names):
    """Drive `frames` steps of `app`'s current renderer with the launch
    counts zeroed just before and read just after; each kernel in `names`
    must have launched once per step. Checks 10 spp everywhere, a finite lit
    image and a written PNG. Returns (launches, lit, PNG bytes)."""
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.utils.image import write_png
    cfg = app.renderer.cfg
    reset_launches()
    state = app.run(frames, save_camera=False)
    torch.cuda.synchronize()
    path_launches = dict(launches)
    for name in names:
        require(path_launches.get(name, 0) == frames,
                f"{name} launched {path_launches.get(name, 0)} times in "
                f"{frames} main-path steps")
    spp = state.accum[3, :cfg.height, :cfg.width]
    require(bool((spp == 10).all()), "every visible pixel holds 10 samples")
    img = app.renderer.display()
    require(bool(np.isfinite(img).all()), "output finite")
    lit = float((img.max(-1) > 0).mean())
    require(lit > 0.05, f"main-path lit coverage {lit} > 0.05")
    png_size = write_png(app.workdir / f"frame_{names[0]}.png",
                         img).stat().st_size
    require(png_size > 1000, "PNG written")
    return path_launches, lit, png_size


POPCOUNT = np.array([bin(x).count("1") for x in range(256)], np.int64)


def philox_bit_gates(draw):
    """The five bit-level gates of tests/test_tpu_hw.py (6 sigma or looser)
    on `draw(seed0, seed1)` -> (4, 256, 128) uint32 words; returns their
    statistics."""
    words = draw(0x1234, 0x5678)
    n = words.size
    ones = np.array([(words >> b & 1).sum() for b in range(32)], np.int64)
    mono = float(np.abs(ones - n / 2).max() / (np.sqrt(n) / 2))
    require(mono < 6, f"monobit per bit position {mono} sigma < 6")
    by = draw(0xBEEF, 7).view(np.uint8)
    hist = np.bincount(by.reshape(-1), minlength=256).astype(np.float64)
    chi2 = float(((hist - by.size / 256) ** 2 / (by.size / 256)).sum())
    require(chi2 < 255 + 8 * np.sqrt(2 * 255), f"byte chi-square {chi2}")
    lanes = POPCOUNT[draw(42, 99).view(np.uint8).reshape(4, 256, 128, 4)]
    nl = 4 * 256 * 32
    lane = float(np.abs(lanes.sum(axis=(0, 1, 3)) - nl / 2).max()
                 / (np.sqrt(nl) / 2))
    require(lane < 6, f"per-lane balance {lane} sigma < 6")
    a = draw(1, 2)
    require(np.array_equal(a, draw(1, 2)), "same seeds, same bits")
    nc = a[0].size * 32
    corr = max(abs(POPCOUNT[(~(x ^ y)).view(np.uint8)].sum() - nc / 2)
               / (np.sqrt(nc) / 2)
               for x, y in [(a[0], a[1]), (a[1], a[2]), (a[0], a[3]),
                            (a[0], draw(3, 2)[0]), (a[0], draw(1, 3)[0])])
    require(corr < 6, f"cross-draw/cross-seed correlation {corr} sigma < 6")
    from l2n_tpu_torch.rng.threefry import uniform_oo_from_bits
    u = uniform_oo_from_bits(torch.from_numpy(
        draw(0xABCD, 0x42).astype(np.int64))).numpy()
    mean_sig = float(abs(u.mean() - 0.5) / np.sqrt(1 / 12 / u.size))
    require(u.min() > 0.0 and u.max() < 1.0, "uniform_oo inside (0, 1)")
    require(mean_sig < 6, f"uniform_oo mean {mean_sig} sigma < 6")
    require(abs(u.var() - 1 / 12) < 0.001, "uniform_oo variance 1/12")
    return {"monobit_sigma": round(mono, 3), "byte_chi2": round(chi2, 2),
            "lane_sigma": round(lane, 3), "corr_sigma": round(float(corr), 3),
            "uniform_mean_sigma": round(mean_sig, 3),
            "uniform_var": float(u.var())}


def step_contributions(cfg, scene, steps):
    """Per-step sample-mean images (independent 1-step estimates) of the
    default camera through backend="cuda"; (steps, 3, H, W)."""
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.render.state import init_frame_state, init_rng_state
    from l2n_tpu_torch.render.step import build_render_step
    step = build_render_step(cfg, scene, backend="cuda")
    st = init_frame_state(cfg, torch.device("cuda"))
    cam = Camera.from_config(cfg).packed()
    prev = torch.zeros_like(st.accum[:3])
    out = []
    for _ in range(steps):
        st = step(st, cam)
        out.append((st.accum[:3] - prev) / cfg.spp_per_step)
        prev = st.accum[:3].clone()
    return torch.stack(out)[:, :, :cfg.height, :cfg.width].cpu().numpy()


# ---------------------------------------------------------------------------
# The least time the card could take: bound_ms = max(operations / fp32 peak,
# bytes / memory rate), H100 SXM peaks (NVIDIA's data sheet; for the
# fp32 rate see PEAK_FP32). Bytes: each
# input read once, each output written once. Operations: what the kernels'
# per-thread code executes for this run's data, counted by running the
# plain version with counting scene closures (the plain version is
# bit-equal to the kernels, so its rays are theirs). Every instruction
# counts as one fp32 operation, sqrt/sin/cos/exp/log included: a lower
# bound. What the reference kernels need for these inputs: a primary cast
# tests only its tile's cone-visible spheres or mesh bounds (the plain
# visibility_table's count), plus the per-tile table; a bounce or any-hit
# cast tests every sphere or mesh bound; a sphere candidate pays for its
# square root and roots only where the ray's line meets it (disc >= 0,
# counted per lane); a triangle segment that hits adds
# its winner's slab test, the slab's 8 sub-cluster tests and the 16
# Moller-Trumbore tests of the winner's sub-cluster (a miss needs no
# triangle test).
# Per-item operation counts, read off csrc/pathtrace.cuh, cull.cuh,
# sphere_pt.cuh, triangle_pt.cuh and wavefront.cuh:
OPS = dict(
    threefry=125,      # one threefry-2x32 pair: 20 rounds, 5 key injections
    ray=30,            # primary_direction: NDC, camera transform, normalize
    sphere=24,         # one candidate of SceneView::nearest whose line
                       # meets the ray (disc >= 0): sqrt, roots, selects
    sphere_miss=17,    # one whose line misses: o - c (3), hb (5),
                       # |o - c|^2 - r^2 (6), disc (2), disc >= 0 (1)
    sphere_primary=15,  # the two of nearest_primary: the 9 origin terms
    sphere_primary_miss=8,  # (o - c, |o - c|^2 - r^2) are hoisted
    nearest_fixed=20,  # the winner's hit point and normal
    anyhit=19,         # one candidate tested by SceneView::anyhit
    cone=186,          # tile_cone: 5 rays, 4 dot products and minima, the
                       # relaxed cosine and sine
    cone_test=29,      # cone_keeps for one sphere or mesh bound
    primary_terms=9,   # one visible sphere's hoisted origin terms
    mesh_bound=20,     # one bound test of the triangle walk (bound_enter
                       # up to its enter test)
    bound_entry=7,     # an entered bound's entry distance and margin test
    moller=62,         # one Moller-Trumbore candidate with its valid test
    tri_fixed=27,      # the winner's normal, texcoords and barycentrics
    scatter=70,        # frame, cosine sample, albedo, roulette, cast origin
    emit=10,           # emit_term and its accumulation
    sky_box=8,         # the Mandelbrot direction-box test
    sky_setup=60,      # inside the box: sqrt, two poly_atan2, the plane point
    sky_iter=9,        # one escape iteration
    accumulate=30,     # accumulate_pixel (sum, count, tonemap) per pixel
    sample_sum=3,      # sum += c per sample
)
# One draw pair of each sampler (pathtrace.cuh), as the function needs it:
# a threefry block; half a Philox block (a block, 10 rounds of 2 multiplies
# giving low and high words and 4 XORs with 9 key bumps, is 98 operations
# and yields two pairs; the kernels evaluate a whole block per pair, which
# the bound does not count) and 2 selects; two TinyMT steps with temper and
# float (26 each); two TausLCG steps (three Tausworthe steps of 6, the LCG,
# XORs, the float conversion and scale: 25 each).
PHILOX_BLOCK_OPS = 98
PAIR_OPS = {"threefry": 125, "tpu_hw": PHILOX_BLOCK_OPS / 2 + 2,
            "tinymt": 52, "tauslcg": 50}
# Bytes of state planes a pixel-step reads and writes: TinyMT reads 7
# words and writes 4, TausLCG reads and writes 4.
STATE_BYTES = {"threefry": 0, "tpu_hw": 0, "tinymt": 44, "tauslcg": 32}
# The raw bits: a quarter of a Philox block per output word (a block gives
# four words; csrc/philox_bits.cu evaluates a whole block per word, which
# the bound does not count), plus the word's index arithmetic.
PHILOX_BITS_OPS = PHILOX_BLOCK_OPS / 4 + 4
# fp32 instructions/s outside the tensor cores: 132 SMs x 128 lanes x 1.98
# GHz. The data sheet's 67 TFLOP/s counts an FMA as two operations; the
# kernels build with -fmad=false and the counts above take every
# instruction as one, so the instruction rate is the peak they divide by.
# Integer and SFU work (sqrt, sin, exp) counted at this rate still gives a
# lower bound: the card issues those no faster.
PEAK_FP32 = 33.5e12
PEAK_FP64_TENSOR = 67e12  # FLOP/s, FP64 tensor cores (DMMA), dense
PEAK_BYTES = 3.35e12   # bytes/s, HBM3


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by)."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mandelbrot_iterations(dx, dy, dz):
    """(in the direction box, escape iterations the kernel runs) per
    direction: the loop of csrc/pathtrace.cuh::mandelbrot_le, counted."""
    from l2n_tpu_torch.maths.fastmath import atan2
    from l2n_tpu_torch.maths.sampling import PI, sqrt
    in_box = (dx >= dy.abs()) & (dz * dz <= dx * dx + dy * dy)
    theta = atan2(sqrt(dx * dx + dy * dy), dz)
    px = 8.0 * (atan2(dy, dx) * (1.0 / PI))
    py = 4.0 * (-1.0 + (2.0 / PI) * theta)
    zx, zy, zx2, zy2 = (torch.zeros_like(px) for _ in range(4))
    iters = torch.zeros_like(px)
    running = torch.ones_like(px, dtype=torch.bool)
    for _ in range(64):
        iters = iters + running.to(px.dtype)
        zy = 2.0 * zx * zy + py
        zx = zx2 - zy2 + px
        zx2, zy2 = zx * zx, zy * zy
        running = running & (zx2 + zy2 <= 4.0)
    return in_box, iters


class WorkCount:
    """Scene closures that count, per lane that the kernels would trace,
    the casts, any-hit candidates, scatters, emissive hits and sky
    evaluations of a plain render. Counters prefixed "a_" belong to the
    primary cast (the wavefront's pass A), "b_" to the rest (pass B).
    Lanes whose cast origin is parked at 3e30 are dead and not counted."""

    def __init__(self, cfg, spheres=None, mesh_bounds=None, visible=None):
        self.cfg, self.spheres = cfg, spheres
        self.mesh_bounds = mesh_bounds
        self.visible = visible  # (K, n) bool: the tiles' visible spheres
        self.c = collections.Counter()

    def _meets(self, mask, ox, oy, oz, dx, dy, dz, tag):
        """Sphere candidates whose line meets the masked casts (disc >= 0,
        the sweep's roots; a_meets and b_meets over every sphere), and
        for primaries those among their tile's visible spheres
        (a_meets_vis). Primary lanes are the K tiles' pixels in order."""
        if self.spheres is None:
            return
        lane = torch.nonzero(mask.reshape(-1))[:, 0]
        o = [torch.broadcast_to(a, mask.shape).reshape(-1)
             for a in (ox, oy, oz)]
        d = [torch.broadcast_to(a, mask.shape).reshape(-1)
             for a in (dx, dy, dz)]
        per_tile = self.cfg.tile_height * self.cfg.tile_width
        for i in range(0, lane.numel(), 1 << 16):  # bounded memory
            li = lane[i:i + (1 << 16)]
            ro = [o[k][li, None] - self.spheres[k] for k in range(3)]
            hb = (ro[0] * d[0][li, None] + ro[1] * d[1][li, None]
                  + ro[2] * d[2][li, None])
            cc = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2] - self.spheres[3]
            meet = hb * hb - cc >= 0.0
            self.c[tag + "meets"] += int(meet.sum())
            if tag == "a_" and self.visible is not None:
                vis = self.visible[li // per_tile]
                self.c["a_meets_vis"] += int((meet & vis).sum())

    def _entries(self, mask, ox, oy, oz, dx, dy, dz):
        """Mesh bounds entered by the masked casts (the walk's enter test
        at best = inf: inside, or ahead with a real root)."""
        if self.mesh_bounds is None:
            return
        o = [torch.broadcast_to(a, mask.shape)[mask] for a in (ox, oy, oz)]
        d = [torch.broadcast_to(a, mask.shape)[mask] for a in (dx, dy, dz)]
        for i in range(0, o[0].numel(), 1 << 16):  # bounded memory
            ro = [o[k][i:i + (1 << 16), None] - self.mesh_bounds[:, k]
                  for k in range(3)]
            dd = [d[k][i:i + (1 << 16), None] for k in range(3)]
            hb = ro[0] * dd[0] + ro[1] * dd[1] + ro[2] * dd[2]
            cc = ro[0] ** 2 + ro[1] ** 2 + ro[2] ** 2 - self.mesh_bounds[:, 3]
            enter = (cc < 0) | ((hb < 0) & (hb * hb - cc >= 0))
            self.c["b_mesh_entries"] += int(enter.sum())

    def _sky(self, mask, dx, dy, dz, tag):
        d = [torch.broadcast_to(a, mask.shape)[mask] for a in (dx, dy, dz)]
        self.c[tag + "sky"] += int(mask.sum())
        if self.cfg.env_mode == "mandelbrot" and d[0].numel():
            in_box, iters = mandelbrot_iterations(*d)
            self.c[tag + "sky_in"] += int(in_box.sum())
            self.c[tag + "sky_iters"] += float(iters[in_box].sum())

    def intersect(self, inner):
        def counted(ox, oy, oz, dx, dy, dz):
            h = inner(ox, oy, oz, dx, dy, dz)
            tag = "a_" if ox.dim() == 0 else "b_"  # primaries share an origin
            live = torch.broadcast_to(ox, dx.shape) < 1e30
            self.c[tag + "casts"] += int(live.sum())
            self._sky(live & (h.t == -1.0), dx, dy, dz, tag)
            hit = live & (h.t >= 0.0)
            self.c[tag + "hits"] += int(hit.sum())
            if tag == "b_":
                self._entries(live, ox, oy, oz, dx, dy, dz)
            self._meets(live, ox, oy, oz, dx, dy, dz, tag)
            emissive = hit & (h.index % self.cfg.emissive_every == 0)
            self.c[tag + "emissive"] += int(emissive.sum())
            self.c[tag + "scatters"] += int((hit & ~emissive).sum())
            return h
        return counted

    def anyhit(self, inner):
        def counted(ox, oy, oz, dx, dy, dz):
            hit = inner(ox, oy, oz, dx, dy, dz)
            live = torch.broadcast_to(ox, dx.shape) < 1e30
            self.c["b_anyhit"] += int(live.sum())
            self.c["b_anyhit_hits"] += int((live & hit).sum())
            self._entries(live, ox, oy, oz, dx, dy, dz)
            if self.spheres is not None:  # candidates up to the first hit
                o = [torch.broadcast_to(a, dx.shape)[live] for a in (ox, oy, oz)]
                d = [a[live] for a in (dx, dy, dz)]
                ro = [o[i][:, None] - self.spheres[i] for i in range(3)]
                hb = ro[0] * d[0][:, None] + ro[1] * d[1][:, None] + ro[2] * d[2][:, None]
                cc = ro[0] ** 2 + ro[1] ** 2 + ro[2] ** 2 - self.spheres[3]
                any_mask = (cc < 0) | ((hb < 0) & (hb * hb >= cc))
                first = torch.argmax(any_mask.to(torch.int8), dim=1) + 1
                n = self.spheres.shape[1]
                tested = torch.where(any_mask.any(1), first, n)
                self.c["b_anyhit_tests"] += int(tested.sum())
            self._sky(live & ~hit, dx, dy, dz, "b_")
            return hit
        return counted


def count_work(cfg, sched, cam, accum, scene_closures, spheres=None,
               rng_state=None, cull_bounds=None, mesh_bounds=None):
    """Counters of one plain render of the scheduled tiles (`accum` and
    `rng_state` are copied, not updated). With `cull_bounds` (4, n), the
    tiles' cone-visible counts over those spheres (the plain
    visibility_table): vis_sum and vis_max over the tiles, and
    vis_candidates, the visible candidates of every primary cast; with
    `mesh_bounds` (M, 4), the mesh bounds each bounce and any-hit cast
    enters (b_mesh_entries); with `spheres`, the candidates whose line
    meets the ray (a_meets, a_meets_vis, b_meets)."""
    from l2n_tpu_torch.ops.kernels.common import render_tiles_plain
    from l2n_tpu_torch.ops.kernels.sphere_pt import visibility_table
    intersect, anyhit, albedo = scene_closures
    visible = None
    if cull_bounds is not None:
        table = visibility_table(cfg, cull_bounds, cam, sched).long()
        n_vis = table[:, 0]
        rank = torch.arange(table.shape[1] - 1, device=table.device)
        visible = torch.zeros(table.shape[0], table.shape[1] - 1,
                              dtype=torch.bool, device=table.device)
        visible.scatter_(1, table[:, 1:], rank[None, :] < n_vis[:, None])
    w = WorkCount(cfg, spheres, mesh_bounds, visible)
    if cull_bounds is not None:
        w.c["vis_sum"] = int(n_vis.sum())
        w.c["vis_max"] = int(n_vis.max())
        w.c["vis_candidates"] = (w.c["vis_sum"] * cfg.tile_height
                                 * cfg.tile_width * cfg.spp_per_step)
    acc = accum.clone()
    render_tiles_plain(cfg, sched, cam, w.intersect(intersect),
                       w.anyhit(anyhit), albedo, acc, torch.empty_like(acc[:3]),
                       None if rng_state is None else rng_state.clone())
    c = w.c
    c["pixels"] = sched.shape[0] * cfg.tile_height * cfg.tile_width
    c["samples"] = c["pixels"] * cfg.spp_per_step
    return c


def path_ops(c, cast_cost: float, tags=("a_", "b_"), pair=OPS["threefry"]):
    """Operations of the traced paths in the counters `c` (casts at
    `cast_cost` each, draw pairs at `pair`) for the given parts of the
    path."""
    ops = 0.0
    for t in tags:
        ops += (c[t + "casts"] * cast_cost
                + c[t + "scatters"] * (OPS["scatter"] + pair)
                + c[t + "emissive"] * OPS["emit"]
                + c[t + "sky"] * OPS["sky_box"]
                + c[t + "sky_in"] * OPS["sky_setup"]
                + c[t + "sky_iters"] * OPS["sky_iter"])
    if "a_" in tags:  # jitter pair, primary ray, RR pair of the first vertex
        ops += (c["samples"] * (pair + OPS["ray"]) + c["a_scatters"] * pair)
    return ops


def sphere_bounds(c, n_spheres: int, k: int, alive: int, rng="threefry"):
    """{kernel: (bound_ms, bound_by)} of sphere_pt and the three wavefront
    passes (and of pass A with the JAX layout's bytes) for the counters `c`
    of one step of K tiles with `alive` survivors, with rng mode `rng`'s
    draws and state planes."""
    pair = PAIR_OPS[rng]
    # A cast's candidates at the miss cost, plus the roots of those whose
    # line meets the ray (counted per lane by count_work).
    cast = n_spheres * OPS["sphere_miss"] + OPS["nearest_fixed"]
    roots = OPS["sphere"] - OPS["sphere_miss"]
    b_roots = c["b_meets"] * roots
    any_ops = c["b_anyhit_tests"] * OPS["anyhit"]
    scene_bytes, sched_bytes = 7 * n_spheres * 4, 8 * k
    tonemap = c["pixels"] * OPS["accumulate"] + c["samples"] * OPS["sample_sum"]
    lanes = c["samples"]
    # Primaries sweep their tile's visible spheres (counted by count_work's
    # cull_bounds), after one table per tile: sphere_pt's and the
    # wavefront's pass A's (the JAX pass A reads the per-camera table,
    # cone_cull=True).
    culled = (c["vis_candidates"] * OPS["sphere_primary_miss"]
              + c["a_meets_vis"] * (OPS["sphere_primary"]
                                    - OPS["sphere_primary_miss"])
              + c["a_casts"] * OPS["nearest_fixed"]
              + k * (OPS["cone"] + n_spheres * OPS["cone_test"])
              + c["vis_sum"] * OPS["primary_terms"])
    a_ops = path_ops(c, cast, ("a_",), pair) - c["a_casts"] * cast + culled
    return {
        "sphere_pt": bound(path_ops(c, cast, pair=pair) - c["a_casts"] * cast
                           + culled + b_roots + any_ops + tonemap,
                           c["pixels"] * (44 + STATE_BYTES[rng])
                           + scene_bytes + sched_bytes),
        # the sample counts in; col (12 B) out for every lane, then back = 0
        # (12 B) for a path that ended or 9 ray and 3 meta planes (48 B)
        # for a survivor
        "wavefront_pass_a": bound(a_ops, c["pixels"] * 4 + lanes * 12
                                  + (lanes - alive) * 12 + alive * 48
                                  + scene_bytes + sched_bytes),
        # the yardstick of the JAX layout: 14 planes (56 B) for every lane
        "wavefront_pass_a_jax_layout": bound(a_ops, c["pixels"] * 4
                                             + lanes * 56 + scene_bytes
                                             + sched_bytes),
        # the survivors' 9 ray and 3 meta planes in, 3 planes of back out
        "wavefront_pass_b": bound(path_ops(c, cast, ("b_",), pair) + b_roots
                                  + any_ops + alive * pair,
                                  alive * 60 + scene_bytes + 4),
        "wavefront_pass_c": bound(tonemap + lanes * 6,
                                  lanes * 24 + c["pixels"] * 44 + sched_bytes),
    }


def triangle_bound(c, m: int, k: int, scene_bytes: int):
    """(bound_ms, bound_by) of triangle_pt for the counters `c` of one step
    of K tiles over M meshes (count_work with cull_bounds and mesh_bounds):
    the path's own work, the primaries' visible mesh-bound tests and table,
    every mesh bound for the other casts, the entered ones' entry tests,
    and per hitting segment its slab, sub-cluster and triangle tests."""
    hit_walk = (OPS["mesh_bound"] + OPS["bound_entry"]        # the slab
                + 8 * OPS["mesh_bound"] + OPS["bound_entry"]  # its subs
                + 16 * OPS["moller"])
    hits = c["a_hits"] + c["b_hits"]
    ops = (path_ops(c, 0.0)
           + c["vis_candidates"] * OPS["mesh_bound"]
           + k * (OPS["cone"] + m * OPS["cone_test"])
           + (c["b_casts"] + c["b_anyhit"]) * m * OPS["mesh_bound"]
           + (hits + c["b_mesh_entries"]) * OPS["bound_entry"]
           + (hits + c["b_anyhit_hits"]) * hit_walk
           + hits * OPS["tri_fixed"]
           + c["pixels"] * OPS["accumulate"]
           + c["samples"] * OPS["sample_sum"])
    return bound(ops, c["pixels"] * 44 + scene_bytes + 8 * k)


def kernel_row(name, source, replaces, n, err, tol, profiled, event_ms,
               plain_ms, bound_pair, **extra):
    """One row of the `kernels` line. `ms` is the kernel's device time per
    launch from torch.profiler (`ms_from` says so), or, where the profiler
    recorded none, the CUDA events' time per call or step (`event_ms`,
    host dispatch included)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "tolerance": tol,
            "ms": event_ms if profiled is None else profiled,
            "ms_from": "CUDA events" if profiled is None else "torch.profiler",
            "event_ms": event_ms, "plain_ms": plain_ms,
            "bound_ms": bound_pair[0], "bound_by": bound_pair[1],
            "library_ms": None, **extra}


# ---------------------------------------------------------------------------
# The probes (l2n_tpu_torch/probes): operations per item, read off
# csrc/sweep_probe.cuh, sweep_variants.cu, onehot_recovery.cu and
# cond_cost.cu, each instruction one operation. The sweeps' terms that do
# not depend on the direction count once per (lane, sphere), not once per
# repeat: with the spheres outside and the repeats' winners in registers,
# the same function computes them once.
PROBE_OPS = dict(
    two_root_o=9,    # TwoRoot::t, once per (lane, sphere): o - c, |o - c|^2 - r2
    two_root_d=15,   # per repeat: hb, the discriminant, sqrt, the roots and
                     # their selects, the `t < best` test
    t1_only=21,      # T1Only::t and its test
    vpu_rep=11,      # per lane and repeat: perturb, accumulate
    mma_pair_o=4,    # per (lane, sphere): o.c's conversion, c
    mma_pair_d=14,   # per repeat: d.c's conversion, hb, the roots, the min
    mma_rep=29,      # per lane and repeat: o.d, perturb, 2 shuffle rounds,
                     # the gather and the accumulate
    any=4,           # cond_cost per element and repeat: compare, vote, select, add
    cond=3,          # compare, vote, carry 0
)
SWEEP_SRC = "l2n_tpu_torch/csrc/sweep_variants.cu"
ONEHOT_SRC = "l2n_tpu_torch/csrc/onehot_recovery.cu"


def cond_cost_bound(mode, w, grid, reps):
    """Every program's work (all `grid` programs compute and store it)."""
    per = {"work": 2 * w, "any": PROBE_OPS["any"],
           "cond_taken": PROBE_OPS["cond"] + 2 * w,
           "cond_skipped": PROBE_OPS["cond"]}[mode]
    return bound(grid * reps * 4096 * per, 2 * 4096 * 4)


def sweep_bounds(lanes, n, reps):
    """{kernel: (bound_ms, bound_by)} of the three sweep kernels (the
    carry's 4 selects per candidate, or vpu2's 2 and its gather); the mma
    variant's products at the FP64 tensor rate against its fp32 epilogue
    and its bytes."""
    cand, pairs = lanes * reps * n, lanes * n
    io = lanes * 32
    scalar = pairs * PROBE_OPS["two_root_o"]
    vpu = (scalar + cand * (PROBE_OPS["two_root_d"] + 4)
           + lanes * reps * PROBE_OPS["vpu_rep"])
    vpu2 = (scalar + cand * (PROBE_OPS["two_root_d"] + 2)
            + lanes * reps * (PROBE_OPS["vpu_rep"] + 1))
    mma_ops = (pairs * PROBE_OPS["mma_pair_o"] + cand * PROBE_OPS["mma_pair_d"]
               + lanes * reps * PROBE_OPS["mma_rep"])
    mma_ms, mma_by = bound(mma_ops, io + 32 * n)
    tensor_ms = mma_tensor_ms(lanes, n, reps)
    return {"sweep_vpu": bound(vpu, io + 16 * n),
            "sweep_vpu2": bound(vpu2, io + 16 * n),
            "sweep_mma": ((tensor_ms, "operations (FP64 tensor)")
                          if tensor_ms > mma_ms else (mma_ms, mma_by))}


def mma_tensor_ms(lanes, n, reps):
    """The mma sweep's products at the FP64 tensor rate: a dot product of
    3 multiply-adds (6 FLOP) per lane and sphere for o.c, and one per lane,
    sphere and repeat for d.c."""
    return lanes * n * (reps + 1) * 6 / PEAK_FP64_TENSOR * 1e3


def onehot_bounds(lanes, s):
    cand = lanes * s
    return {"onehot_carry": bound(cand * (PROBE_OPS["t1_only"] + 6)
                                  + lanes * 7, lanes * 48 + 16 * s),
            "onehot_gather": bound(cand * (PROBE_OPS["t1_only"] + 2)
                                   + lanes * 12, lanes * 48 + 48 * s)}


def probe_cond_cost(card):
    """Phase 19: the cond_cost probe's main (every setting, grid 256), each
    setting's kernel against its plain version (bit-equal), and each
    setting's kernel time from torch.profiler; the row is work, w=256 (the
    probe's slope)."""
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.probes import cond_cost as cc
    reset_launches()
    ns = cc.main([])
    torch.cuda.synchronize()
    n = launches["cond_cost"]
    require(n > 0, "the cond_cost probe launched its kernel")
    x = torch.ones((1, 32, 128), dtype=torch.float32, device="cuda")
    firsts, plain_ms = {}, {}
    for s in cc.SETTINGS:
        got = cc.cond_cost(x, *s)
        want, plain_ms[s] = timed_result(lambda: cc.cond_cost_plain(x, *s))
        require(torch.equal(got, want),
                f"cond_cost {s} kernel/plain bit-equal")
        firsts[s[0], s[2]] = float(got.flatten()[0])
    require(firsts["any", 0] == 1.0 and firsts["cond_skipped", 16] == 1.0,
            "any and cond_skipped leave 1.0")
    require(firsts["work", 16] == float(np.float32(1.0000305)),
            "work w=16 gives 1.0000305")
    kernel = {s: profile_calls(lambda s=s: cc.cond_cost(x, *s), 10,
                               "cond_cost_kernel") for s in cc.SETTINGS}
    units = cc.GRID * cc.REPS
    label = lambda s: f"{s[0]} m={s[1]} w={s[2]}"  # noqa: E731
    per_setting = {label(s): {
        "kernel_ns_per_unit": None if kernel[s] is None
        else round(kernel[s] * 1e6 / units, 3),
        "main_ns_per_unit": round(ns[s], 3),
        "bound_ns_per_unit": round(cond_cost_bound(s[0], s[2], cc.GRID,
                                                   cc.REPS)[0] * 1e6 / units,
                                   4)} for s in cc.SETTINGS}
    top = ("work", 0, 256)
    call = (lambda: cc.cond_cost(x, *top))
    event = timed_calls(call, 3, 50)
    b = cond_cost_bound("work", 256, cc.GRID, cc.REPS)
    phase(19, f"cond_cost probe (grid {cc.GRID}, {cc.REPS} repeats, one "
              f"1,024-thread block per program): every setting bit-equal to "
              f"its plain version; ns per unit (program x repeat): kernel "
              f"(torch.profiler, 10 launches each), the probe's main (CUDA "
              f"graph replay) and bound {per_setting}; work w=256: kernel "
              f"{kernel[top]} ms/launch, {event:.4f} ms/call (CUDA events, "
              f"back-to-back calls), plain {plain_ms[top]:.4f} ms/call, "
              f"bound {b[0]:.6f} ms ({b[1]}); card: {card}")
    return [kernel_row("cond_cost", "l2n_tpu_torch/csrc/cond_cost.cu",
                       "benchmarks/cond_cost.py:31", n, 0.0,
                       "bit-equal (every setting)", kernel[top], event,
                       plain_ms[top], b, setting="work, w=256, grid 256")]


def probe_sweep(card):
    """Phase 20: the sweep_variants probe's main (64 blocks, 128 spheres,
    16 repeats), each kernel against its plain version, the probe's own
    check (vpu2 = vpu) and the mma gate."""
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.probes import sweep_variants as sv
    reset_launches()
    res = sv.main([])
    torch.cuda.synchronize()
    names = ("sweep_vpu", "sweep_vpu2", "sweep_mma")
    n_launch = {k: launches[k] for k in names}
    require(all(n_launch.values()), f"every sweep kernel launched {n_launch}")
    dev = torch.device("cuda")
    data = {k: torch.from_numpy(v).to(dev) for k, v in sv.inputs().items()}
    o, d, cmat = data["o"], data["d"], data["cmat"]
    sph = [data[k] for k in ("cx", "cy", "cz", "r2")]
    bias = torch.zeros((o.shape[1], 32, 128), dtype=torch.float32, device=dev)
    reps, n = sv.REPEATS, cmat.shape[1]
    calls = {
        "sweep_vpu": (lambda: sv.sweep_vpu(o, d, *sph, bias),
                      lambda: sv.sweep_vpu_plain(o, d, *sph, bias)),
        "sweep_vpu2": (lambda: sv.sweep_vpu2(o, d, *sph, bias),
                       lambda: sv.sweep_vpu2_plain(o, d, *sph, bias)),
    }
    out, err, plain_ms = {}, {}, {}
    for name, (kern, plain) in calls.items():
        out[name] = kern()
        want, plain_ms[name] = timed_result(plain)
        require(torch.equal(out[name], want), f"{name} kernel/plain bit-equal")
        err[name] = 0.0
    require(torch.equal(out["sweep_vpu2"], out["sweep_vpu"]),
            "vpu2 = vpu bit for bit")
    require(torch.equal(res["vpu"][0], out["sweep_vpu"])
            and torch.equal(res["vpu2carry"][0], out["sweep_vpu2"]),
            "the probe's main computed the same sweeps")
    ik = torch.empty((reps, *bias.shape), dtype=torch.int32, device=dev)
    ip = torch.empty_like(ik)
    mk = sv.sweep_mma(o, d, cmat, bias, reps, ik)
    mp, plain_ms["sweep_mma"] = timed_result(
        lambda: sv.sweep_mma_plain(o, d, cmat, bias, reps, ip))
    same = (ik == ip).all(0)
    agree = float(same.float().mean())
    tol = 1e-4 * mp.abs().clamp(min=1.0)
    within = bool(((mk - mp).abs() <= tol)[same].all())
    bit_equal = float((mk == mp).float().mean())
    require(agree >= 0.999, f"sweep_mma winners agree on {agree} of lanes")
    require(within, "sweep_mma |d acc| <= 1e-4 max(|acc|, 1) where winners "
                    "agree")
    err["sweep_mma"] = float((mk - mp).abs().max())
    # The kernel against the JAX kernel's arithmetic, float32 dot products
    # (reported, not gated: float32 sums of o.c lose the low bits that a
    # grazing ray's discriminant keeps).
    i32 = torch.empty_like(ik)
    m32 = sv.sweep_mma_plain(o, d, cmat, bias, reps, i32, exact_dots=False)
    same32 = (ik == i32).all(0)
    breach = same32 & ((mk - m32).abs() > 1e-4 * m32.abs().clamp(min=1.0))
    fp32 = {"winners_agree": float(same32.float().mean()),
            "breaches": int(breach.sum()),
            "max_breach": float((mk - m32).abs()[breach].max())
            if bool(breach.any()) else 0.0,
            "max_abs": float((mk - m32).abs().max())}
    mma_vpu = float((mk - out["sweep_vpu"]).abs().max())
    kernels = {name: kern for name, (kern, _) in calls.items()}
    kernels["sweep_mma"] = lambda: sv.sweep_mma(o, d, cmat, bias)
    lanes = bias.numel()
    bounds = sweep_bounds(lanes, n, reps)
    rows, times = [], {}
    for name, kern in kernels.items():
        ms = profile_calls(kern, 10, f"{name}_kernel")
        event = timed_calls(kern, 2, 10)
        ps = (event if ms is None else ms) * 1e9 / (lanes * reps * n)
        times[name] = {"kernel_ms": ms, "event_ms": round(event, 4),
                       "plain_ms": round(plain_ms[name], 2),
                       "ps_per_lane_cand": round(ps, 3),
                       "bound_ms": round(bounds[name][0], 5)}
        rows.append(kernel_row(
            name, SWEEP_SRC, f"benchmarks/sweep_variants.py:"
            f"{ {'sweep_vpu': 83, 'sweep_vpu2': 101, 'sweep_mma': 138}[name] }",
            n_launch[name], err[name],
            "bit-equal" if name != "sweep_mma" else
            "winners agree on >= 99.9% of lanes, there |d acc| <= 1e-4 "
            "max(|acc|, 1)", ms, event, plain_ms[name], bounds[name],
            ps_per_lane_candidate=ps))
    phase(20, f"sweep_variants probe ({bias.shape[0]} blocks, {n} spheres, "
              f"{reps} repeats): vpu, vpu2 bit-equal to their plain "
              f"versions and to each other; mma winners agree with its "
              f"plain version on {agree:.6f} of lanes ({bit_equal:.6f} "
              f"bit-equal), max |d acc| "
              f"{err['sweep_mma']:.4g} (gate 1e-4 max(|acc|, 1)); against "
              f"float32 dot products (the JAX kernel's arithmetic; lanes of "
              f"{lanes}: winners agree in every repeat, |d acc| above the "
              f"gate there, largest such, largest overall) {fp32}; max |mma - "
              f"vpu| {mma_vpu:.4g}; mma products at the FP64 tensor rate "
              f"{mma_tensor_ms(lanes, n, reps):.4f} ms; probe main ms/call "
              f"{ {k: round(v[1], 4) for k, v in res.items()} } (device "
              f"time of a CUDA graph of 8 chained calls, best of 3 "
              f"replays); per kernel (ms/launch by torch.profiler, ms/call "
              f"by CUDA events, plain ms/call) {times}; "
              f"card: {card}")
    return rows, times


def probe_onehot(card):
    """Phase 21: the onehot_recovery probe's check and time modes (S =
    128), each kernel against its plain version, gather = carry on hits."""
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.probes import onehot_recovery as oh
    reset_launches()
    require(oh.main(["check"]) is True, "onehot check: gather = carry on hits")
    marginal = oh.main(["time"])
    torch.cuda.synchronize()
    n_launch = {k: launches[k] for k in ("onehot_carry", "onehot_gather")}
    require(all(n_launch.values()), f"both onehot kernels launched {n_launch}")
    dev = torch.device("cuda")
    x = {k: torch.from_numpy(v).to(dev) for k, v in oh.inputs().items()}
    calls = {
        "onehot_carry": (lambda: oh.onehot_carry(x["rays"], x["spheres"]),
                         lambda: oh.onehot_carry_plain(x["rays"],
                                                       x["spheres"])),
        "onehot_gather": (lambda: oh.onehot_gather(x["rays"], x["spheres"],
                                                   x["table"]),
                          lambda: oh.onehot_gather_plain(
                              x["rays"], x["spheres"], x["table"]))}
    got, plain_ms = {}, {}
    for name, (kern, plain) in calls.items():
        got[name] = kern()
        want, plain_ms[name] = timed_result(plain)
        require(torch.equal(got[name], want),
                f"{name} kernel/plain bit-equal (all lanes)")
    hit = got["onehot_carry"][1] >= 0
    require(torch.equal(got["onehot_carry"][:, hit],
                        got["onehot_gather"][:, hit]), "gather = carry on hits")
    require(bool((got["onehot_carry"][5][~hit] == 1).all())
            and bool((got["onehot_gather"][5][~hit] == 0).all()),
            "misses: carry r2 = 1, gather r2 = 0")
    bounds = onehot_bounds(32 * 128, x["spheres"].shape[1])
    rows, times = [], {}
    for name, (kern, _) in calls.items():
        ms = profile_calls(kern, 50, f"{name}_kernel")
        event = timed_calls(kern, 5, 200)
        times[name] = {"kernel_ms": ms, "event_ms": round(event, 5),
                       "plain_ms": round(plain_ms[name], 3),
                       "bound_ms": round(bounds[name][0], 6)}
        rows.append(kernel_row(
            name, ONEHOT_SRC, "benchmarks/onehot_recovery.py:"
            f"{100 if name == 'onehot_carry' else 112}", n_launch[name], 0.0,
            "bit-equal (all lanes)", ms, event, plain_ms[name],
            bounds[name]))
    phase(21, f"onehot_recovery probe (S = {x['spheres'].shape[1]}, one "
              f"32x128 block, hit fraction {float(hit.float().mean()):.3f}): "
              f"check PASS, both kernels bit-equal to their plain versions, "
              f"gather = carry on hits, miss r2 1 / 0; marginal ms/call "
              f"{ {k: round(v, 5) for k, v in marginal.items()} } (host "
              f"clock, (t(800) - t(400)) / 400); per kernel {times}; card: "
              f"{card}")
    return rows


def straddling(cfg, bounds, cam):
    """Spheres (bound spheres) kept by more than one tile's cone, and the
    visible counts per tile (the plain visibility_table)."""
    from l2n_tpu_torch.ops.kernels.sphere_pt import full_visibility_table
    table = full_visibility_table(cfg, bounds, cam).cpu()
    kept = torch.zeros(bounds.shape[1], dtype=torch.int64)
    for row in table:
        kept[row[1:1 + row[0]].long()] += 1
    return int((kept > 1).sum()), table[:, 0]


def orbit_view(cfg, bounds, radius_scale=1.0):
    """The default camera orbited about the scene's centre: of 24 steps of
    15 degrees around the vertical, the view whose tile cones are straddled
    by the most bounds (each kept by more than one tile)."""
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.maths.linalg import look_at
    b = bounds.cpu().numpy().astype(np.float64)
    centre = b[:3].mean(1)
    base = Camera.from_config(cfg).packed()[8, :3].astype(np.float64)
    off = (base - centre) * radius_scale
    best = None
    for i in range(24):
        a = np.radians(15.0 * i)
        rot = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                        [-np.sin(a), 0.0, np.cos(a)]])
        eye = centre + rot @ off
        vm = look_at(eye.astype(np.float32), centre.astype(np.float32),
                     np.array([0.0, 1.0, 0.0], np.float32))
        cam = Camera.from_config(cfg, view_matrix=vm).packed()
        n, _ = straddling(cfg, bounds, cam)
        if best is None or n > best[0]:
            best = (n, 15 * i, cam)
    return best


def inside_view(cfg, bounds, j, toward, fraction):
    """The eye inside bound j, `fraction` of its radius from its centre
    toward bound `toward`, looking at bound `toward`."""
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.maths.linalg import look_at
    b = bounds.cpu().numpy().astype(np.float64)
    to = (b[:3, toward] - b[:3, j]) / np.linalg.norm(b[:3, toward] - b[:3, j])
    eye = b[:3, j] + to * fraction * np.sqrt(b[3, j])
    vm = look_at(eye.astype(np.float32), b[:3, toward].astype(np.float32),
                 np.array([0.0, 1.0, 0.0], np.float32))
    return Camera.from_config(cfg, view_matrix=vm).packed()


def facet_gap_view(cfg, buf, j, toward):
    """The eye between tessellated mesh j and its bound sphere (inside the
    bound, outside the facets), over the facet that faces bound `toward`,
    looking at it."""
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.maths.linalg import look_at
    b = buf.mesh_bounds.cpu().numpy().astype(np.float64)
    soup = {k: v.cpu().numpy().astype(np.float64) for k, v in buf.soup.items()}
    mine = soup["mesh_id"] == j
    cen = np.stack([soup[f"v1{a}"] + (soup[f"e1{a}"] + soup[f"e2{a}"]) / 3.0
                    for a in "xyz"], 1)[mine]
    radial = cen - b[j, :3]
    dist = np.linalg.norm(radial, axis=1)
    out = radial / dist[:, None]
    to = b[toward, :3] - b[j, :3]
    f = int(np.argmax(out @ (to / np.linalg.norm(to))))
    eye = cen[f] + out[f] * 0.5 * (np.sqrt(b[j, 3]) - dist[f])
    require(float(((eye - b[j, :3]) ** 2).sum()) < b[j, 3],
            "the facet-gap eye lies inside its mesh's bound")
    vm = look_at(eye.astype(np.float32), b[toward, :3].astype(np.float32),
                 np.array([0.0, 1.0, 0.0], np.float32))
    return Camera.from_config(cfg, view_matrix=vm).packed()


def hard_culling_phase(cfg, spheres, tri_cfg, tri_buf):
    """Phase 22: sphere_pt and triangle_pt against their plain versions, 4
    whole-frame steps each, from views that make the cone cull hard: the
    default camera orbited until the most bounds straddle tile-cone edges,
    and the eye inside a bound (the d2 <= r2 case): inside the emissive
    sphere 0 for spheres (every primary hits it from inside), in the gap
    between a tessellated sphere and its bound for meshes (a lit view out of
    the bound), that one also as the tex_coords AOV (1 step), which walks
    only the culled meshes. Gates: accum max abs 0, lit > 5%."""
    from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt, sphere_pt_plain
    from l2n_tpu_torch.ops.kernels.triangle_pt import (
        triangle_pt,
        triangle_pt_plain,
    )
    swhole = cfg.replace(tiles_per_step=cfg.tile_count)
    twhole = tri_cfg.replace(tiles_per_step=tri_cfg.tile_count)
    sb = spheres[:4].contiguous()
    mb = tri_buf.mesh_bounds.T.contiguous()
    c = sb.cpu().numpy()
    d = np.linalg.norm(c[:3].T - c[:3, 0], axis=1)
    d[0] = np.inf
    near0 = int(np.argmin(d))
    views = []
    n, deg, cam = orbit_view(swhole, sb)
    views.append(("sphere orbit", sphere_pt, sphere_pt_plain, swhole,
                  spheres, cam, sb, f"{deg} deg, {n} spheres straddle"))
    views.append(("sphere eye inside emissive sphere 0", sphere_pt,
                  sphere_pt_plain, swhole, spheres,
                  inside_view(swhole, sb, 0, near0, 1.0 / 3.0), sb, ""))
    n, deg, cam = orbit_view(twhole, mb)
    views.append(("mesh orbit", triangle_pt, triangle_pt_plain, twhole,
                  tri_buf, cam, mb, f"{deg} deg, {n} bounds straddle"))
    gap = facet_gap_view(twhole, tri_buf, near0, 0)
    views.append((f"mesh eye in mesh {near0}'s bound gap", triangle_pt,
                  triangle_pt_plain, twhole, tri_buf, gap, mb, ""))
    views.append((f"mesh eye in mesh {near0}'s bound gap, tex_coords",
                  triangle_pt, triangle_pt_plain,
                  twhole.replace(aov="tex_coords"), tri_buf, gap, mb, ""))
    out = {}
    for name, kern, plain, vcfg, scene_arg, cam, bounds, note in views:
        n_straddle, counts = straddling(vcfg, bounds, cam)
        steps = 4 if vcfg.aov == "pathtracing" else 1
        _, err, _, lit, _ = kernel_vs_plain(kern, plain, vcfg, scene_arg,
                                            cam, steps)
        require(err == 0.0, f"{name}: kernel/plain accum max abs {err}")
        out[name] = {"max_abs": err, "lit": round(lit, 4),
                     "visible_mean": round(float(counts.float().mean()), 3),
                     "visible_max": int(counts.max()),
                     "straddling": n_straddle, **({"view": note} if note
                                                  else {})}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    sys.path.insert(0, str(ROOT))
    from l2n_tpu_torch.app.application import Application
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.maths.linalg import look_at
    from l2n_tpu_torch.ops.kernels import build
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.ops.kernels.philox_bits import (
        philox_bits,
        philox_bits_plain,
    )
    from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt, sphere_pt_plain
    from l2n_tpu_torch.ops.kernels.triangle_pt import (
        TriangleBuffers,
        triangle_pt,
        triangle_pt_plain,
    )
    from l2n_tpu_torch.ops.kernels.uv_demo import uv_demo, uv_demo_plain
    from l2n_tpu_torch.ops.kernels.wavefront import (
        sphere_wavefront_step,
        wavefront_lanes,
        wavefront_pass_a,
        wavefront_pass_a_plain,
        wavefront_pass_b,
        wavefront_pass_b_plain,
        wavefront_pass_c,
        wavefront_pass_c_plain,
    )
    from l2n_tpu_torch.ops.scenes import (
        sphere_anyhit,
        sphere_intersector,
        triangle_anyhit,
        triangle_intersector,
    )
    from l2n_tpu_torch.render.program import TriangleProgram
    from l2n_tpu_torch.render.state import init_frame_state, init_rng_state
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
    ptxas, kernel = [], "?"
    for ln in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"(sphere_pt|triangle_pt|uv_demo|philox_bits|"
                      r"wavefront_pass_[abc]|cond_cost|sweep_vpu2?|"
                      r"sweep_mma|onehot_carry|onehot_gather)_kernel", ln)
        if "Compiling entry function" in ln and m:
            # one instantiation per sampler, or per cond_cost mode and
            # carry count: name it
            rng = re.search(r"(Threefry|Philox|TinyMT|TausLCG)", ln)
            mode_m = re.search(r"cond_cost_kernelILi(\d+)ELi(\d+)E", ln)
            kernel = m.group(1) + (
                f"<{rng.group(1)}>" if rng else
                f"<mode {mode_m.group(1)}, m {mode_m.group(2)}>" if mode_m
                else "")
        elif "registers" in ln or "spill" in ln:
            ptxas.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
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
    uv_kernel_ms = profile_calls(lambda: uv_demo(t, 720, 1280), 50,
                                 "uv_demo_kernel")
    uv_plain_ms = timed_calls(lambda: uv_demo_plain(t, 720, 1280), 5, 200)
    phase(2, f"uv_demo kernel vs plain (3,720,1280): max abs err {uv_err:.3e}"
             f" (gate 1e-5); wrapper {uv_ms:.4f} ms/call, plain "
             f"{uv_plain_ms:.4f} ms/call (CUDA events over back-to-back "
             f"calls); kernel {uv_kernel_ms} ms/launch (torch.profiler); "
             f"card: {card}")

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
    require(max_err == 0.0, f"sphere_pt kernel/plain accum max abs {max_err}")
    phase(4, f"sphere_pt kernel vs plain, default {cfg.width}x{cfg.height}, "
             f"{steps} steps x {k} tiles: accum RMSE {rmse:.3e} (gate 1e-3), "
             f"max abs {max_err:.3e} (gate 0), output flip fraction "
             f"{flips:.3e} (gate 2e-3), lit {lit:.4f}")
    del ka, pa

    with tempfile.TemporaryDirectory() as tmp:
        # --- 5: the sphere main path through Application -----------------
        app = Application(RenderConfig(), backend="cuda", device="cuda",
                          workdir=tmp, renderer_names=("spherePT",))
        frames = app.cfg.tile_count * 10 // app.cfg.effective_tiles_per_step
        sphere_launches, main_lit, png_size = run_main_path(app, frames,
                                                            ("sphere_pt",))
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
        rmse, tri_err, flips, lit, _ = kernel_vs_plain(
            triangle_pt, triangle_pt_plain, whole, tri_buf, cam, 4)
        require(tri_err == 0.0,
                f"triangle_pt kernel/plain accum max abs {tri_err}")
        phase(7, f"triangle_pt kernel vs plain, default triangle config "
                 f"{whole.width}x{whole.height}, {tri_scene.total_triangles} "
                 f"triangles in {tri_scene.mesh_count} meshes, 4 whole-frame "
                 f"steps: accum RMSE {rmse:.3e} (gate 1e-3), max abs "
                 f"{tri_err:.3e} (gate 0), output flip fraction {flips:.3e} "
                 f"(gate 2e-3), lit {lit:.4f}")

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
        rmse, tori_err, flips, lit, _ = kernel_vs_plain(
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
                                                         ("triangle_pt",))
        require(tri_launches.get("sphere_pt", 0) == 0,
                "the triangle path launched no sphere kernel")
        phase(9, f"main path: Application(RenderConfig(), initial_renderer="
                 f"trianglePT, backend=cuda) ran {frames} steps, launches "
                 f"{tri_launches}, 10 spp everywhere, finite, lit "
                 f"{main_lit:.4f}, PNG {png_size} bytes")
        del app

        # --- 10: the wavefront passes, kernel vs plain, one whole frame ---
        # Each kernel and its plain version get the same inputs: pass B and
        # pass C take what the plain passes before them made. Pass A's
        # survivors land in slots in no fixed order: compared as sets,
        # sorted by their lane plane. Pass B also at the 10-tile schedule,
        # where it splits each ray's sweeps across a group of lanes.
        wcfg = RenderConfig(wavefront=True).validate()
        wwhole = wcfg.replace(tiles_per_step=wcfg.tile_count)
        wsched = scheduled_tiles(tiles, 0, wwhole.tile_count)
        wst = init_frame_state(wwhole, dev)
        ka = wavefront_lanes(wwhole, wwhole.tile_count, dev)
        ka.back.fill_(float("nan"))  # pass A leaves the survivors' lanes
        wavefront_pass_a(wwhole, wsched, cam, spheres, wst.accum, ka)
        pa = wavefront_pass_a_plain(wwhole, wsched, cam, spheres, wst.accum)
        torch.cuda.synchronize()
        na = int(pa.n_alive[0])
        n_lanes = pa.col[0].numel()
        alive_whole = na / n_lanes
        require(int(ka.n_alive[0]) == na,
                f"pass A n_alive {int(ka.n_alive[0])} == plain {na}")
        require(bits_equal(ka.col, pa.col), "pass A col bit-equal")
        require(bits_equal(ka.back, pa.back),
                "pass A back bit-equal (0 at the dead lanes)")
        korder = torch.argsort(ka.meta[2, :na])
        require(torch.equal(ka.meta[:, :na][:, korder], pa.meta[:, :na]),
                "pass A meta equal as sets (sorted by lane)")
        require(bits_equal(ka.rays[:, :na][:, korder], pa.rays[:, :na]),
                "pass A rays equal as sets (sorted by lane)")
        moved = int((ka.meta[2, :na] != pa.meta[2, :na]).sum())
        wave_err = {"wavefront_pass_a": 0.0}

        def lane_gate(name, got, want):
            d = (got - want).double()
            rmse = float(d.pow(2).mean().sqrt())
            require(rmse < 1e-3, f"{name} kernel/plain RMSE {rmse} < 1e-3")
            return float(d.abs().max())

        def pass_b_gate(bcfg, a, label):
            """Kernel pass B vs plain on the plain pass A's outputs `a`:
            every survivor's lane written, RMSE over them < 1e-3, back
            bit-equal; returns (max abs, G the kernel picks)."""
            kb, pb = a.back.clone(), a.back.clone()
            wavefront_pass_b(bcfg, cam, spheres, a.rays, a.meta, a.n_alive,
                             kb)
            wavefront_pass_b_plain(bcfg, cam, spheres, a.rays, a.meta,
                                   a.n_alive, pb)
            torch.cuda.synchronize()
            require(not kb.isnan().any(),
                    f"pass B ({label}) wrote every survivor's lane")
            lanes = a.meta[2, :int(a.n_alive[0])].long()
            err = lane_gate(f"pass B back ({label})",
                            kb.view(3, -1)[:, lanes], pb.view(3, -1)[:, lanes])
            require(bits_equal(kb, pb), f"pass B ({label}) back bit-equal")
            return err, pass_b_group(int(a.n_alive[0])), pb

        b_err, b_group, back = pass_b_gate(wwhole, pa, "whole frame")
        s10 = scheduled_tiles(tiles, 0, wcfg.effective_tiles_per_step)
        p10 = wavefront_pass_a_plain(wcfg, s10, cam, spheres,
                                     init_frame_state(wcfg, dev).accum)
        b10_err, b10_group, _ = pass_b_gate(wcfg, p10, "10 tiles")
        wave_err["wavefront_pass_b"] = max(b_err, b10_err)
        kc, pc = init_frame_state(wwhole, dev), init_frame_state(wwhole, dev)
        wavefront_pass_c(wwhole, wsched, pa.col, back, kc.accum, kc.output)
        wavefront_pass_c_plain(wwhole, wsched, pa.col, back, pc.accum,
                               pc.output)
        torch.cuda.synchronize()
        require(torch.equal(kc.accum[3], pc.accum[3]), "pass C accum[3] equal")
        flips_c = float(((kc.output - pc.output).abs() > 1e-3).float().mean())
        require(flips_c < 2e-3, f"pass C output flips {flips_c} < 2e-3")
        wave_err["wavefront_pass_c"] = max(
            lane_gate("pass C accum", kc.accum, pc.accum),
            float((kc.output - pc.output).abs().max()))
        phase(10, f"wavefront passes kernel vs plain, default config, one "
                  f"whole-frame step ({n_lanes} lanes): pass A n_alive "
                  f"{na} = {alive_whole:.4f} of the lanes, col and back "
                  f"bit-equal, rays and meta equal as sets ({moved} of "
                  f"{na} slots hold another lane than the plain stable "
                  f"order); pass B max abs over the survivors' lanes "
                  f"{b_err:.3e} (G = {b_group}), at 10 tiles "
                  f"({int(p10.n_alive[0])} survivors) {b10_err:.3e} (G = "
                  f"{b10_group}); pass C max abs (accum, output) "
                  f"{wave_err['wavefront_pass_c']:.3e}, output flips "
                  f"{flips_c:.3e} (gates: pass A exact, pass B bit-equal, "
                  f"RMSE < 1e-3, flips < 2e-3)")
        del ka, pa, p10, back, kc, pc

        # --- 11: the wavefront CUDA step vs the sphere_pt CUDA step --------
        rmse, wf_vs_fused, flips, lit, _ = kernel_vs_plain(
            sphere_wavefront_step, sphere_pt, wwhole, spheres, cam, 4)
        require(wf_vs_fused == 0.0, f"wavefront/fused max abs {wf_vs_fused}")
        phase(11, f"wavefront CUDA step vs sphere_pt CUDA step, default "
                  f"config, 4 whole-frame steps: accum RMSE {rmse:.3e} (gate "
                  f"1e-3), max abs {wf_vs_fused:.3e} (bit-equal required), "
                  f"output flip fraction {flips:.3e} (gate 2e-3), lit "
                  f"{lit:.4f}")

        # --- 24: the same at the 10-tile schedule, where pass B splits ----
        # each ray's sweeps over 8 lanes; also with 100 spheres, which 8
        # does not divide, and with tpu_hw. Two passes over the frame (46
        # steps of 10 tiles) per case.
        split = {}
        steps10 = 2 * -(-wcfg.tile_count // wcfg.effective_tiles_per_step)
        for count in (wcfg.sphere_count, 100):
            sc = compute_spheres(count, wcfg.world_size, wcfg.scene_seed,
                                 device=dev).packed()
            for rng in ("threefry", "tpu_hw"):
                scfg = wcfg.replace(sphere_count=count, rng=rng)
                k = scfg.effective_tiles_per_step
                kst, fst = (init_frame_state(scfg, dev) for _ in range(2))
                lanes = wavefront_lanes(scfg, k, dev)
                groups = set()
                for i in range(steps10):
                    ssched = scheduled_tiles(tiles, i * k % scfg.tile_count, k)
                    sphere_wavefront_step(scfg, ssched, cam, sc, kst.accum,
                                          kst.output, lanes=lanes)
                    groups.add(pass_b_group(int(lanes.n_alive[0])))
                    sphere_pt(scfg, ssched, cam, sc, fst.accum, fst.output)
                torch.cuda.synchronize()
                err = float((kst.accum - fst.accum).abs().max())
                lit = float((fst.accum[:3, :scfg.height, :scfg.width]
                             .amax(0) > 0).float().mean())
                label = f"{count} spheres, {rng}"
                require(groups == {8}, f"10 tiles ({label}): pass B split "
                                       f"every step (G {sorted(groups)})")
                require(err == 0.0, f"10-tile wavefront/fused ({label}) max "
                                    f"abs {err}")
                require(lit > 0.02, f"10 tiles ({label}) lit {lit} > 0.02")
                split[label] = {"max_abs": err, "lit": round(lit, 4)}
        phase(24, f"wavefront CUDA step vs sphere_pt CUDA step at 10 tiles, "
                  f"{steps10} steps, pass B at G = 8: {split} (gates: accum "
                  f"max abs 0, lit > 0.02)")

        # --- 23: two runs of the wavefront CUDA step from one state --------
        # The slot order of pass A's append changes from run to run; the
        # image must not. Both schedules: 10 tiles splits pass B's sweeps.
        determinism = {}
        for label, dcfg in (("whole frame", wwhole), ("10 tiles", wcfg)):
            k = dcfg.effective_tiles_per_step
            dsched = scheduled_tiles(tiles, 0, k)
            runs = []
            for _ in range(2):
                st = init_frame_state(dcfg, dev)
                st.accum[3] = 3.0  # a later step's sample index
                lanes = wavefront_lanes(dcfg, k, dev)
                for _ in range(2):
                    sphere_wavefront_step(dcfg, dsched, cam, spheres,
                                          st.accum, st.output, lanes=lanes)
                torch.cuda.synchronize()
                runs.append((st, lanes.meta[2, :int(lanes.n_alive[0])]))
            (s1, m1), (s2, m2) = runs
            require(torch.equal(s1.accum, s2.accum)
                    and torch.equal(s1.output, s2.output),
                    f"two wavefront runs ({label}) give the same image")
            require(torch.equal(torch.sort(m1).values, torch.sort(m2).values),
                    f"two wavefront runs ({label}) keep the same survivors")
            determinism[label] = (int((m1 != m2).sum()), m1.numel())
        phase(23, f"wavefront CUDA step run twice from one state, 2 steps "
                  f"each: accum and output identical (max abs 0); slots "
                  f"holding another lane in the second run: "
                  + ", ".join(f"{lbl} {d} of {n}"
                              for lbl, (d, n) in determinism.items()))

        # --- 12: the wavefront main path through Application --------------
        app = Application(RenderConfig(wavefront=True), backend="cuda",
                          device="cuda", workdir=tmp,
                          renderer_names=("spherePT",))
        frames = app.cfg.tile_count * 10 // app.cfg.effective_tiles_per_step
        wave_names = ("wavefront_pass_a", "wavefront_pass_b",
                      "wavefront_pass_c")
        wave_launches, main_lit, png_size = run_main_path(app, frames,
                                                          wave_names)
        require(wave_launches.get("sphere_pt", 0) == 0,
                "the wavefront path launched no sphere_pt kernel")
        phase(12, f"main path: Application(RenderConfig(wavefront=True), "
                  f"backend=cuda) ran {frames} steps, launches "
                  f"{wave_launches}, 10 spp everywhere, finite, lit "
                  f"{main_lit:.4f}, PNG {png_size} bytes")
        del app

        # --- 13: philox_bits, the tpu_hw raw bits, and their gates --------
        # (4, 256, 128) is the gates' draw; 4 x 7,360 x 128 words are four
        # draws for every pixel of the padded 1280x736 frame.
        bits_seeds = torch.tensor([0x1234, 0x5678], dtype=torch.int32,
                                  device=dev)
        whole_h = cfg.padded_height * cfg.padded_width // 128
        for shape in ((4, 256), (4, whole_h)):
            got_bits = philox_bits(bits_seeds, *shape)
            want_bits = philox_bits_plain(bits_seeds, *shape)
            torch.cuda.synchronize()
            require(torch.equal(got_bits, want_bits),
                    f"philox_bits {shape} kernel/plain bit-equal")
        del got_bits, want_bits

        def card_bits(s0: int, s1: int) -> np.ndarray:
            seeds = torch.tensor([s0, s1], dtype=torch.int32, device=dev)
            return philox_bits(seeds, 4, 256).cpu().numpy().view(np.uint32)

        reset_launches()
        bit_stats = philox_bit_gates(card_bits)
        bits_launches = launches["philox_bits"]
        require(bits_launches > 0, "the bit gates drew through philox_bits")
        # Per shape: the kernel's device time per launch (torch.profiler),
        # the wrapper's time per call over back-to-back calls (CUDA events;
        # host dispatch included), the plain version's, and the bound.
        bits_t = {}
        for h, (n_kernel, n_plain) in ((256, (200, 20)), (whole_h, (100, 5))):
            call = (lambda h=h: philox_bits(bits_seeds, 4, h))
            wrapper_ms = timed_calls(call, 5, n_kernel)
            bits_t[h] = {
                "kernel_ms": profile_calls(call, 50, "philox_bits_kernel"),
                "wrapper_ms": wrapper_ms,
                "plain_ms": timed_calls(
                    lambda h=h: philox_bits_plain(bits_seeds, 4, h), 1,
                    n_plain),
                "bound": bound(4 * h * 128 * PHILOX_BITS_OPS,
                               4 * h * 128 * 4 + 8)}
        phase(13, f"philox_bits kernel vs plain bit-equal at (4, 256, 128) "
                  f"and (4, {whole_h}, 128); the five bit gates of "
                  f"tests/test_tpu_hw.py on the card's bits pass: "
                  f"{bit_stats} ({bits_launches} launches); per h of "
                  f"(4, h, 128): kernel ms/launch (torch.profiler), wrapper "
                  f"ms/call (CUDA events over back-to-back calls), plain "
                  f"ms/call, bound (ms, by): {bits_t}; card: {card}")

        # --- 14: sphere_pt with the other rng modes, kernel vs plain ------
        swhole = cfg.replace(tiles_per_step=cfg.tile_count)
        mode_err = {}
        for rng in ("tpu_hw", "tinymt", "tauslcg"):
            _, err, _, lit, state_eq = kernel_vs_plain(
                sphere_pt, sphere_pt_plain, swhole.replace(rng=rng), spheres,
                cam, 4)
            require(err == 0.0, f"sphere_pt rng={rng} accum max abs {err}")
            require(state_eq in (None, True),
                    f"sphere_pt rng={rng} rng_state bit-equal")
            mode_err[rng] = {"max_abs": err, "rng_state_equal": state_eq,
                             "lit": round(lit, 4)}
        phase(14, f"sphere_pt kernel vs plain, default config, 4 whole-frame "
                  f"steps per rng mode: {mode_err}")

        # --- 15: triangle_pt with tinymt and tpu_hw at the golden's size ---
        tg_buf = TriangleBuffers.from_scene(prog.scene, dev)
        tri_mode_err = {}
        for rng in ("tinymt", "tpu_hw"):
            _, err, _, lit, state_eq = kernel_vs_plain(
                triangle_pt, triangle_pt_plain, tcfg.replace(rng=rng), tg_buf,
                tcam, 4)
            require(err == 0.0, f"triangle_pt rng={rng} accum max abs {err}")
            require(state_eq in (None, True),
                    f"triangle_pt rng={rng} rng_state bit-equal")
            tri_mode_err[rng] = {"max_abs": err, "rng_state_equal": state_eq,
                                 "lit": round(lit, 4)}
        phase(15, f"triangle_pt kernel vs plain at the triangle golden's "
                  f"config and view ({tcfg.width}x{tcfg.height}, "
                  f"{prog.scene.mesh_count} meshes), 4 steps: "
                  f"{tri_mode_err}")
        del tg_buf

        # --- 16: the wavefront CUDA step vs sphere_pt, both tpu_hw --------
        _, wf_hw_err, _, wf_hw_lit, _ = kernel_vs_plain(
            sphere_wavefront_step, sphere_pt, wwhole.replace(rng="tpu_hw"),
            spheres, cam, 4)
        require(wf_hw_err == 0.0, f"wavefront/fused tpu_hw max abs {wf_hw_err}")
        phase(16, f"wavefront CUDA step vs sphere_pt CUDA step, rng=tpu_hw, "
                  f"4 whole-frame steps: accum max abs {wf_hw_err} (bit-equal"
                  f" required), lit {wf_hw_lit:.4f}")

        # --- 17: the tpu_hw estimator gates against threefry --------------
        # tests/test_tpu_hw.py's configuration and thresholds: 32 steps of 4
        # spp for the mean gates; the variance gate reads the first 24.
        est = RenderConfig(width=256, height=128, tile_height=32,
                           tile_width=128, tiles_per_step=8,
                           spp_per_step=4).validate()
        est_scene = compute_spheres(est.sphere_count, est.world_size,
                                    est.scene_seed, device=dev)
        est_tf = step_contributions(est, est_scene, 32)
        est_hw = step_contributions(est.replace(rng="tpu_hw"), est_scene, 32)
        img_tf, img_hw = est_tf.mean(0), est_hw.mean(0)
        mean_d = abs(float(img_hw.mean() - img_tf.mean()))
        med_d = float(np.median(np.abs(img_hw - img_tf)))
        var_tf, var_hw = est_tf[:24].var(0), est_hw[:24].var(0)
        var_ratio = (float(np.median(var_hw[var_hw > 1e-6]))
                     / float(np.median(var_tf[var_tf > 1e-6])))
        require(mean_d < 0.02, f"tpu_hw/threefry mean image diff {mean_d}")
        require(med_d < 0.05, f"tpu_hw/threefry median |diff| {med_d}")
        require(0.8 < var_ratio < 1.25, f"tpu_hw/threefry variance ratio "
                                        f"{var_ratio}")
        require(not np.array_equal(img_hw, img_tf), "tpu_hw is not threefry")
        phase(17, f"tpu_hw estimator gates vs threefry on the card "
                  f"(256x128, 4 spp/step): mean-image diff {mean_d:.3e} (gate"
                  f" 0.02, 32 steps), median |diff| {med_d:.3e} (gate 0.05), "
                  f"variance ratio {var_ratio:.4f} (gate 0.8-1.25, 24 steps)")
        del est_tf, est_hw

        # --- 18: the main paths with every rng mode -----------------------
        init_s = {}
        for rng in ("tinymt", "tauslcg"):
            t0 = time.perf_counter()
            init_rng_state(RenderConfig(rng=rng), dev)
            torch.cuda.synchronize()
            init_s[rng] = round(time.perf_counter() - t0, 3)
        mode_paths = {}
        for rng in ("tinymt", "tauslcg", "tpu_hw"):
            for renderer, name in (("spherePT", "sphere_pt"),
                                   ("trianglePT", "triangle_pt")):
                app = Application(RenderConfig(rng=rng), backend="cuda",
                                  device="cuda", workdir=tmp,
                                  renderer_names=(renderer,))
                frames = (app.cfg.tile_count * 10
                          // app.cfg.effective_tiles_per_step)
                got, lit, _ = run_main_path(app, frames, (name,))
                mode_paths[f"{renderer}/{rng}"] = (got, round(lit, 4))
                del app
        app = Application(RenderConfig(wavefront=True, rng="tpu_hw"),
                          backend="cuda", device="cuda", workdir=tmp,
                          renderer_names=("spherePT",))
        got, lit, _ = run_main_path(app, frames, wave_names)
        require(got.get("sphere_pt", 0) == 0,
                "the wavefront tpu_hw path launched no sphere_pt kernel")
        mode_paths["spherePT/wavefront/tpu_hw"] = (got, round(lit, 4))
        del app
        phase(18, f"main paths: Application(RenderConfig(rng=m), "
                  f"backend=cuda) ran {frames} steps each, 10 spp "
                  f"everywhere, finite: launches and lit {mode_paths}; host "
                  f"state init at {cfg.padded_width}x{cfg.padded_height} "
                  f"(seconds): {init_s}")

        # --- 22: both kernels vs plain where culling is hard ------------
        hard = hard_culling_phase(cfg, spheres, tri_cfg, tri_buf)
        phase(22, f"hard culling, 4 whole-frame steps per view (1 for the "
                  f"AOV), kernel vs plain (gates: accum max abs 0, lit > "
                  f"0.05): {hard}")

    # --- 19-21: the probes through their entry points ----------------------
    probe_rows = probe_cond_cost(card)
    sweep_rows, sweep_times = probe_sweep(card)
    probe_rows += sweep_rows + probe_onehot(card)

    # --- timings: kernel and plain, reference and whole-frame schedules -----
    timings, kernel_ms = {}, {}
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
                    per, busy, _, tst = profile_steps(
                        tstep, tst, cam, 20, (f"{name}_kernel",))
                    k_ms = kernel_ms[(name, label)] = per[f"{name}_kernel"]
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

    # --- every rng mode: step and kernel times beside threefry's ----------
    rng_modes = ("threefry", "tpu_hw", "tinymt", "tauslcg")
    mode_times = {}
    for name, fcfg, fscene in (("sphere_pt", cfg, scene),
                               ("triangle_pt", tri_cfg, tri_scene)):
        for label, lcfg in (("10-tile", fcfg), ("whole-frame", fcfg.replace(
                tiles_per_step=fcfg.tile_count))):
            for rng in rng_modes:
                mcfg = lcfg.replace(rng=rng)
                tstep = build_render_step(mcfg, fscene, backend="cuda",
                                          device=dev)
                tst = init_frame_state(mcfg, dev)
                for _ in range(3):
                    tst = tstep(tst, cam)
                dev_ms, host_ms, tst = timed_steps(tstep, tst, cam, 50)
                per, busy, _, tst = profile_steps(tstep, tst, cam, 20,
                                                  (f"{name}_kernel",))
                k_ms = per[f"{name}_kernel"]
                mode_times[(name, label, rng)] = (dev_ms, k_ms)
                print(f"[timing] {name} {label} rng={rng} backend=cuda: step "
                      f"{dev_ms:.4f} ms (CUDA events), {host_ms:.4f} ms "
                      f"(host clock to sync); {name}_kernel "
                      + ("not measured" if k_ms is None else
                         f"{k_ms:.4f} ms/launch (torch.profiler), device "
                         f"busy {busy:.3f}")
                      + f"; card: {card}", flush=True)
                del tst, tstep
    for rng in rng_modes[1:]:  # the plain sphere step, 10 tiles
        mcfg = cfg.replace(rng=rng)
        tstep = build_render_step(mcfg, scene, backend="torch", device=dev)
        tst = tstep(init_frame_state(mcfg, dev), cam)
        dev_ms, host_ms, tst = timed_steps(tstep, tst, cam, 3)
        mode_times[("sphere_pt", "10-tile plain", rng)] = (dev_ms, None)
        print(f"[timing] sphere_pt 10-tile rng={rng} backend=torch: "
              f"{dev_ms:.4f} ms/step (CUDA events); card: {card}",
              flush=True)
        del tst, tstep

    # --- the wavefront step: device and host time, each pass, the rest ---
    # Since pass A appends the survivors and pass B writes back by lane, the
    # only other device work of the step is the counter's memset and the
    # step's schedule gather (render/tiles.scheduled_tiles).
    wave = {}
    kernel_names = {n: f"{n}_kernel" for n in wave_names}
    for label, tcfg in (("10-tile", wcfg), ("whole-frame", wwhole)):
        k = tcfg.effective_tiles_per_step
        samples = k * tcfg.tile_height * tcfg.tile_width * tcfg.spp_per_step
        for backend, (warm, n) in (("cuda", (3, 50)), ("torch", (1, 3))):
            tstep = build_render_step(tcfg, scene, backend=backend,
                                      device=dev)
            tst = init_frame_state(tcfg, dev)
            for _ in range(warm):
                tst = tstep(tst, cam)
            dev_ms, host_ms, tst = timed_steps(tstep, tst, cam, n)
            wave[(label, backend)] = dev_ms
            if backend == "cuda":
                per, busy, other, tst = profile_steps(
                    tstep, tst, cam, 20, tuple(kernel_names.values()))
                wave[(label, "passes")] = per
                wave[(label, "busy")] = busy
                print(f"[profile] wavefront {label} backend=cuda: "
                      + ", ".join(
                          f"{n} " + ("not measured" if per[kn] is None else
                                     f"{per[kn]:.4f} ms/launch")
                          for n, kn in kernel_names.items())
                      + ("" if other is None else
                         f"; the rest of the step's device work "
                         f"{other[0]:.4f} ms/step, by name (events, ms) per "
                         f"step {other[1]}; device busy {busy:.3f} of the span "
                         f"from first to last device event")
                      + f" (torch.profiler); card: {card}", flush=True)
            print(f"[timing] wavefront {label} ({k} tiles, {samples} "
                  f"samples/step) backend={backend}: {dev_ms:.4f} ms/step "
                  f"(CUDA events), {host_ms:.4f} ms/step (host clock to "
                  f"sync), {samples / dev_ms / 1e3:.2f} Msamples/s; card: "
                  f"{card}", flush=True)
            del tst, tstep
        torch.cuda.empty_cache()

    # --- each pass alone at the main path's 10-tile shape -----------------
    k = wcfg.effective_tiles_per_step
    a10 = init_frame_state(wcfg, dev)
    p10 = wavefront_pass_a_plain(wcfg, s10, cam, spheres, a10.accum)
    alive10 = int(p10.n_alive[0])
    lanes10 = p10.col[0].numel()
    back10 = p10.back.clone()
    wavefront_pass_b_plain(wcfg, cam, spheres, p10.rays, p10.meta,
                           p10.n_alive, back10)
    k10 = wavefront_lanes(wcfg, k, dev)
    bk10 = p10.back.clone()
    scratch = init_frame_state(wcfg, dev)
    pass_calls = {
        "wavefront_pass_a": (
            lambda: wavefront_pass_a(wcfg, s10, cam, spheres, a10.accum, k10),
            lambda: wavefront_pass_a_plain(wcfg, s10, cam, spheres,
                                           a10.accum)),
        "wavefront_pass_b": (
            lambda: wavefront_pass_b(wcfg, cam, spheres, p10.rays, p10.meta,
                                     p10.n_alive, bk10),
            lambda: wavefront_pass_b_plain(wcfg, cam, spheres, p10.rays,
                                           p10.meta, p10.n_alive, bk10)),
        "wavefront_pass_c": (
            lambda: wavefront_pass_c(wcfg, s10, p10.col, back10,
                                     scratch.accum, scratch.output),
            lambda: wavefront_pass_c_plain(wcfg, s10, p10.col, back10,
                                           scratch.accum, scratch.output))}
    pass_ms, pass_plain_ms = {}, {}
    for name, (kernel_call, plain_call) in pass_calls.items():
        pass_ms[name] = timed_calls(kernel_call, 3, 50)
        pass_plain_ms[name] = timed_calls(plain_call, 1, 5)
        profiled = wave[("10-tile", "passes")][kernel_names[name]]
        print(f"[timing] {name} alone, 10-tile inputs ({alive10} of "
              f"{lanes10} lanes alive, {alive10 / lanes10:.4f}):"
              f" kernel {pass_ms[name]:.4f} ms/call (CUDA events), "
              + ("" if profiled is None else
                 f"{profiled:.4f} ms/launch (torch.profiler, in the step), ")
              + f"plain {pass_plain_ms[name]:.4f} ms/call; card: {card}",
              flush=True)

    # --- work counts and bounds ------------------------------------------
    sphere_scene = (sphere_intersector(*spheres[:4]),
                    sphere_anyhit(*spheres[:4]), spheres[4:7].T)
    sphere_cull = spheres[:4].contiguous()
    work10 = count_work(wcfg, s10, cam, a10.accum, sphere_scene, spheres,
                        cull_bounds=sphere_cull)
    bounds = sphere_bounds(work10, scene.count, k, alive10)
    work_whole = count_work(wwhole, wsched, cam,
                            init_frame_state(wwhole, dev).accum,
                            sphere_scene, spheres, cull_bounds=sphere_cull)
    bounds_whole = sphere_bounds(work_whole, scene.count,
                                 wwhole.tile_count, na)
    for label, w in (("10-tile", work10), ("whole-frame", work_whole)):
        segs = (w["a_casts"] + w["b_casts"] + w["b_anyhit"]) / w["samples"]
        iters = (w["a_sky_iters"] + w["b_sky_iters"]) / w["samples"]
        print(f"[work] sphere default config, {label} step from zero state:"
              f" {dict(w)}; mean path segments per sample {segs:.4f}, "
              f"Mandelbrot iterations per sample {iters:.4f} (counted on "
              f"the plain path)", flush=True)
    tri_intersect = triangle_intersector(tri_buf.soup)
    tri_closures = (tri_intersect, triangle_anyhit(tri_intersect),
                    tri_buf.albedo.T)
    m = tri_buf.mesh_bounds.shape[0]
    tri_bytes = sum(getattr(tri_buf, f).numel() * 4 for f in (
        "albedo", "mesh_bounds", "slab_count", "slab_bounds", "sub_bounds",
        "tris", "attrs"))
    mesh_cull = tri_buf.mesh_bounds.T.contiguous()
    tri_work = {}
    for label, lcfg in (("10-tile", tri_cfg), ("whole-frame", whole)):
        lsched = scheduled_tiles(tiles, 0, lcfg.effective_tiles_per_step)
        w = tri_work[label] = count_work(
            lcfg, lsched, cam, init_frame_state(lcfg, dev).accum,
            tri_closures, cull_bounds=mesh_cull,
            mesh_bounds=tri_buf.mesh_bounds)
        (bounds if label == "10-tile" else bounds_whole)["triangle_pt"] = (
            triangle_bound(w, m, lsched.shape[0], tri_bytes))
        print(f"[work] triangle default config, {label} step from zero "
              f"state: {dict(w)} (counted on the plain path)", flush=True)
    # The culled lists: visible spheres and mesh bounds per tile of the
    # default views (whole frame), and the mesh bounds a bounce or any-hit
    # cast enters.
    tw = tri_work["whole-frame"]
    print(f"[cull] visible per tile, default view, whole frame: spheres mean "
          f"{work_whole['vis_sum'] / wwhole.tile_count:.3f} max "
          f"{work_whole['vis_max']} of {scene.count}; meshes mean "
          f"{tw['vis_sum'] / whole.tile_count:.3f} max {tw['vis_max']} of "
          f"{m}; mesh bounds entered per bounce or any-hit ray "
          f"{tw['b_mesh_entries'] / max(tw['b_casts'] + tw['b_anyhit'], 1):.4f}"
          f" ({tw['b_casts'] + tw['b_anyhit']} rays; counted on the plain "
          f"path)", flush=True)
    bounds["uv_demo"] = bound(720 * 1280 * 12, 720 * 1280 * 12 + 4)
    bounds["philox_bits"] = bits_t[256]["bound"]
    mode_bounds = {}
    for rng in rng_modes:
        for label, lcfg, lsched in (("10-tile", cfg, s10),
                                    ("whole-frame", swhole, wsched)):
            mcfg = lcfg.replace(rng=rng)
            st0 = init_frame_state(mcfg, dev)
            w = count_work(mcfg, lsched, cam, st0.accum, sphere_scene,
                           spheres, st0.rng_state, cull_bounds=sphere_cull)
            mode_bounds[f"{rng} {label}"] = sphere_bounds(
                w, scene.count, lsched.shape[0], 0, rng)["sphere_pt"]
    print(f"[bound] sphere_pt per rng mode (ms, by): "
          f"{ {n: (round(b, 6), by) for n, (b, by) in mode_bounds.items()} }"
          f"; card: {card}", flush=True)
    print(f"[bound] 10-tile step: { {n: (round(b, 6), by) for n, (b, by) in bounds.items()} }; "
          f"whole-frame: { {n: (round(b, 6), by) for n, (b, by) in bounds_whole.items()} } "
          f"(ms; fp32 {PEAK_FP32:.3g} op/s, {PEAK_BYTES:.3g} B/s); card: "
          f"{card}", flush=True)
    # sphere_pt's in-kernel sweep rate beside the probes': kernel time per
    # nearest-hit candidate (the primaries' visible spheres, every sphere of
    # a bounce cast), and per candidate with the
    # shadow rays' any-hit tests counted too. The whole-frame step renders
    # the frame its work was counted on; the 10-tile step's kernel time is
    # the mean over rotating schedules, its count that of tiles 0-9.
    rates = {}
    for label, w in (("10-tile", work10), ("whole-frame", work_whole)):
        k_ms = kernel_ms[("sphere_pt", label)]
        cand = w["vis_candidates"] + w["b_casts"] * scene.count
        rates[label] = None if k_ms is None else {
            "nearest": round(k_ms * 1e9 / cand, 4),
            "with_anyhit": round(k_ms * 1e9 / (cand + w["b_anyhit_tests"]),
                                 4)}
    print(f"[rate] ps per (lane x candidate): sphere_pt (torch.profiler "
          f"kernel time) {rates}; the sweep probe "
          f"{ {k: v['ps_per_lane_cand'] for k, v in sweep_times.items()} }; "
          f"card: {card}", flush=True)

    def row(name, *args, **extra):
        return kernel_row(name, *args, bounds[name], **extra)

    def whole_frame(name):
        """The whole-frame step's kernel time (torch.profiler), plain step
        time and bound, beside the row's 10-tile figures."""
        return {"whole_frame_ms": kernel_ms[(name, "whole-frame")],
                "whole_frame_plain_ms": timings[(name, "whole-frame",
                                                 "torch")],
                "whole_frame_bound_ms": bounds_whole[name][0],
                "whole_frame_bound_by": bounds_whole[name][1]}

    frame_tol = "accum RMSE < 1e-3, output |d|>1e-3 fraction < 2e-3"
    wave_src = "l2n_tpu_torch/csrc/wavefront.cu"
    wave_rows = []
    wave_tol = {
        "wavefront_pass_a": "n_alive, col, back bit-equal; rays and meta "
                            "equal as sets",
        "wavefront_pass_b": "back bit-equal; RMSE < 1e-3 over the "
                            "survivors' lanes",
        "wavefront_pass_c": "RMSE < 1e-3, output flips < 2e-3"}
    for name, line in zip(wave_names, (113, 194, 247)):
        wave_rows.append(row(
            name, wave_src, f"l2n_tpu/ops/kernels/wavefront.py:{line}",
            wave_launches.get(name, 0), wave_err[name], wave_tol[name],
            wave[("10-tile", "passes")][kernel_names[name]], pass_ms[name],
            pass_plain_ms[name],
            whole_frame_ms=wave[("whole-frame", "passes")][kernel_names[name]],
            whole_frame_bound_ms=bounds_whole[name][0],
            whole_frame_bound_by=bounds_whole[name][1]))
    print(f"[time] {time.perf_counter() - T0:.1f} s from the start of the "
          f"script to the kernels line", flush=True)
    print(json.dumps({"kernels": [
        row("sphere_pt", "l2n_tpu_torch/csrc/sphere_pt.cu",
            "l2n_tpu/ops/kernels/sphere_pt.py:214",
            sphere_launches.get("sphere_pt", 0), max_err, frame_tol,
            kernel_ms[("sphere_pt", "10-tile")],
            timings[("sphere_pt", "10-tile", "cuda")],
            timings[("sphere_pt", "10-tile", "torch")],
            **whole_frame("sphere_pt")),
        row("uv_demo", "l2n_tpu_torch/csrc/uv_demo.cu",
            "l2n_tpu/ops/kernels/uv_demo.py:22", uv_launches, uv_err,
            "max abs err <= 1e-5", uv_kernel_ms, uv_ms, uv_plain_ms),
        row("triangle_pt", "l2n_tpu_torch/csrc/triangle_pt.cu",
            "l2n_tpu/ops/kernels/triangle_pt.py:811",
            tri_launches.get("triangle_pt", 0), max(tri_err, tori_err),
            frame_tol, kernel_ms[("triangle_pt", "10-tile")],
            timings[("triangle_pt", "10-tile", "cuda")],
            timings[("triangle_pt", "10-tile", "torch")],
            **whole_frame("triangle_pt")),
        *wave_rows,
        row("philox_bits", "l2n_tpu_torch/csrc/philox_bits.cu",
            "tests/test_tpu_hw.py:44", bits_launches, 0.0, "bit-equal",
            bits_t[256]["kernel_ms"], bits_t[256]["wrapper_ms"],
            bits_t[256]["plain_ms"]),
        *probe_rows]}))
    print(card)  # nvidia-smi name, power.limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
