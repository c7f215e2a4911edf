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
versions (the onehot pair also at 100 and 16 spheres), holds sphere_pt and triangle_pt to their plain versions bit for
bit from views that make their per-tile cone cull hard (phase 22), runs
the wavefront step twice from one state to show that its image does not
depend on the order of pass A's survivor slots (phase 23), holds the
wavefront step to sphere_pt bit for bit at the 10-tile schedule, where
pass B splits each ray's sweeps over 8 lanes (phase 24), holds sphere_pt,
triangle_pt and wavefront passes A/B to their plain versions with the
primary-only AOVs (normal, hit, ambient occlusion), the sun sky, the
viewproj camera and fast_math in every rng mode, with a view whose misses
see the sun (phases 25-28), drives their main paths (phase 29), holds the
material modes, the bump and the explicit lights the same way (phases
30-32), holds next event estimation and MIS (nee, nee+mis, nee+mis with
microfacet and the bump, nee+mis with the explicit lights) through
sphere_pt, triangle_pt and the wavefront passes to their plain versions in
threefry and tpu_hw, gates the NEE estimator against its closed form
through sphere_pt and drives the NEE main paths (phases 33-37), holds
homogeneous fog (alone, with NEE, MIS, microfacet and the bump, the
explicit lights, one bounce, the AO AOV's budget) through sphere_pt and
triangle_pt to their plain versions in threefry and tpu_hw with a
collision-share gate, Beer-Lambert attenuation through sphere_pt to its
closed form, and drives the fog main paths (phases 38-40), holds
`steps_per_call` as CUDA-graph replay to eager single steps bit for bit
(sphere_pt and triangle_pt in threefry, tpu_hw and tinymt, the wavefront
step, fog+nee+mis; from an odd tile offset, across a camera change, after
clear_accumulation and after load_session) and drives the graph-replayed
main paths (phase 41), resumes a session saved on the card bit for bit
(42), runs rmse_vs_oracle, debug_mode and the interactive viewer on
scripted keys (43), times ms per scheduler step eager against
steps_per_call (44), holds a slab of a sharded frame (its row offset and
stream) to its plain version and to the whole frame's rows (45), drives
the sharded renderer (l2n_tpu_torch.parallel) on 4 ranks spawned on the
card over gloo, each gathered slab bit-equal to its kernel render here
(46), and its stateful tile axis to one single-card step (47), holds
triangle_pt to its plain version on the 70,144-triangle trefoil knot of
the JAX bench's bigobj stage, one mesh of 548 slabs that takes the walk's
slab-group level, and times it (48), holds a call's steps rendered in
groups (one launch for the 32 steps of portbench's tri32k.rows schedule)
to one launch per step bit for bit (50), and times
kernel and plain versions beside the least time the card could take for
the same work.

    python3 chip_smoke.py          # needs one CUDA card
    python3 chip_smoke.py fused    # phase 50 alone

Imports neither jax nor anything of the JAX package (l2n_tpu). Every phase
prints one line; a failed gate raises, so the script exits nonzero without
its last line. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import collections
import dataclasses
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


# The serial lane body the scalar sweep kernels ran before the chunked one
# (csrc/sweep_probe.cuh `sweep_lane`: repeats outside, spheres inside, the
# sphere rows in shared memory), built on its own beside the kernels for
# its registers and SASS.
SERIAL_SWEEP_CU = r"""
#include "sweep_probe.cuh"
template <bool kCarry>
__device__ void serial(const float* o, const float* d, const float* sph,
                       int n, int lanes, int repeats, const float* bias,
                       float* out) {
  extern __shared__ float rows[];
  for (int j = threadIdx.x; j < 4 * n; j += blockDim.x) rows[j] = sph[j];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= lanes) return;
  out[p] = l2n_probe::sweep_lane<kCarry>(
      l2n_probe::Spheres{rows, n}, repeats, o[p], o[lanes + p],
      o[2 * lanes + p], d[p], d[lanes + p], d[2 * lanes + p], bias[p]);
}
extern "C" __global__ void serial_sweep_vpu(
    const float* o, const float* d, const float* sph, int n, int lanes,
    int repeats, const float* bias, float* out) {
  serial<true>(o, d, sph, n, lanes, repeats, bias, out);
}
extern "C" __global__ void serial_sweep_vpu2(
    const float* o, const float* d, const float* sph, int n, int lanes,
    int repeats, const float* bias, float* out) {
  serial<false>(o, d, sph, n, lanes, repeats, bias, out);
}
"""


# The tensor-core sweep kernel before its redesign (FP64 mma.sync m8n8k4 for
# o.c and d.c in every repeat, sqrtf on every candidate), built on its own
# beside the kernels for its registers and SASS.
OLD_MMA_CU = r"""
#include "sweep_probe.cuh"
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%4, %5};\n"
      : "=d"(d0), "=d"(d1) : "d"(a), "d"(b), "d"(0.0), "d"(0.0));
}
__device__ __forceinline__ float root_t(float oo, float od, float oc,
                                        float cd, float ccr) {
  const float c = oo - (oc + oc) + ccr;
  const float hb = od - cd;
  const float sq = sqrtf(hb * hb - c);
  const float t1 = -hb - sq, t2 = -hb + sq;
  const float t = t1 >= 0.0f ? t1 : t2;
  return t >= 0.0f ? t : l2n_probe::kBig;
}
extern "C" __global__ void old_sweep_mma(
    const float* o, const float* d, const float* cmat, int n, int lanes,
    int repeats, const float* bias, float* out, int* index) {
  extern __shared__ double smem[];
  double* bfrag = smem;
  float* ccr = reinterpret_cast<float*>(smem + 4 * n);
  float* wcx = ccr + n;
  float* wr2 = wcx + n;
  for (int e = threadIdx.x; e < 4 * n; e += blockDim.x) {
    const int j = (e >> 5) * 8 + ((e & 31) >> 2), k = e & 3;
    bfrag[e] = k < 3 ? static_cast<double>(cmat[k * n + j]) : 0.0;
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    ccr[j] = cmat[4 * n + j];
    wcx[j] = cmat[j];
    wr2[j] = cmat[3 * n + j];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, q = lane & 3, warps = blockDim.x / 32;
  for (int tile = blockIdx.x * warps + (threadIdx.x >> 5); tile < lanes / 8;
       tile += gridDim.x * warps) {
    const int p = tile * 8 + (lane >> 2);
    const float ox = o[p], oy = o[lanes + p], oz = o[2 * lanes + p];
    const float dx0 = d[p], dy = d[lanes + p], dz = d[2 * lanes + p];
    const double a_o = q == 0 ? ox : q == 1 ? oy : q == 2 ? oz : 0.0;
    const float oo = ox * ox + oy * oy + oz * oz;
    float acc = bias[p];
    for (int r = 0; r < repeats; ++r) {
      const float dx = dx0 * l2n_probe::perturb_scale(r);
      const double a_d = q == 0 ? dx : q == 1 ? dy : q == 2 ? dz : 0.0;
      const float od = ox * dx + oy * dy + oz * dz;
      float best = l2n_probe::kBig;
      int bi = n;
      for (int st = 0; st < n / 8; ++st) {
        const double b = bfrag[st * 32 + lane];
        double cd0, cd1, oc0, oc1;
        dmma(cd0, cd1, a_d, b);
        dmma(oc0, oc1, a_o, b);
        const int j = st * 8 + 2 * q;
        const float t0 = root_t(oo, od, static_cast<float>(oc0),
                                static_cast<float>(cd0), ccr[j]);
        const float t1 = root_t(oo, od, static_cast<float>(oc1),
                                static_cast<float>(cd1), ccr[j + 1]);
        if (t0 < best) { best = t0; bi = j; }
        if (t1 < best) { best = t1; bi = j + 1; }
      }
      for (int m = 1; m <= 2; m <<= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, best, m);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, m);
        if (ot < best || (ot == best && oi < bi)) { best = ot; bi = oi; }
      }
      const bool hit = best < l2n_probe::kBig;
      const int idx = hit ? bi : -1;
      acc = acc + ((hit ? best : 0.0f) + (hit ? wcx[bi] : 0.0f) * 1e-6f +
                   (hit ? wr2[bi] : 0.0f) * 1e-9f +
                   static_cast<float>(idx) * 1e-3f);
      if (index != nullptr && q == 0) index[r * lanes + p] = idx;
    }
    if (q == 0) out[p] = acc;
  }
}
"""


def start_cubin(build, tmp: Path, stem: str, source: str) -> subprocess.Popen:
    """nvcc of `source` into tmp/<stem>.cubin, with the kernels' flags,
    started in the background."""
    src = tmp / f"{stem}.cu"
    src.write_text(source)
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-cubin", f"-I{build.CSRC}",
         str(src), "-o", str(tmp / f"{stem}.cubin")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_lines(log: str, pattern: str) -> list:
    """`name: registers / spill` lines of ptxas -v output for the entry
    functions whose names match `pattern`."""
    lines, kernel = [], "?"
    for ln in log.splitlines():
        m = re.search(pattern, ln)
        if "Compiling entry function" in ln:
            kernel = m.group(0) if m else None
        elif kernel and ("registers" in ln or "spill" in ln):
            lines.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
    return lines


def sass_calls(cuobjdump: str, path: Path, pattern: str) -> dict:
    """{kernel: CALL instructions in its SASS} for the kernels of `path`
    whose (mangled) names match `pattern`, from cuobjdump -sass."""
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            m = re.search(pattern, ln)
            current = m.group(0) if m else None
            if current:
                counts.setdefault(current, 0)
        elif current and re.search(r"\bCALL\b", ln):
            counts[current] += 1
    return counts


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


def kernel_vs_plain(kernel, plain, cfg, buffers, cam, steps, lights=None):
    """Render `steps` steps with the kernel and with its plain version from
    fresh states (with explicit `lights`, ops/lights.ExplicitLights, where
    given); returns the gates of `compare` and whether the rng state planes
    ended bit-equal (None for the counter-based modes)."""
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    dev = torch.device("cuda")
    tiles = torch.as_tensor(tile_grid(cfg)).to(dev)
    k = cfg.effective_tiles_per_step
    ka = init_frame_state(cfg, dev)
    pa = init_frame_state(cfg, dev)
    kw = {} if lights is None else {"lights": lights}
    for i in range(steps):
        sched = scheduled_tiles(tiles, i * k % cfg.tile_count, k)
        kernel(cfg, sched, cam, buffers, ka.accum, ka.output, ka.rng_state,
               **kw)
        plain(cfg, sched, cam, buffers, pa.accum, pa.output, pa.rng_state,
              **kw)
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
    """Drive `frames` calls of `app`'s current renderer with the launch
    counts zeroed just before and read just after; each kernel in `names`
    must have launched once per group of scheduler steps (a call runs the
    program's `steps_per_call` in groups of the step's `group`, on the
    card as a CUDA-graph replay whose launches count per replay). Checks
    10 spp everywhere, a finite lit image and a written PNG. Returns
    (launches, lit, PNG bytes)."""
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.utils.image import write_png
    cfg = app.renderer.cfg
    program = app.renderer.program
    steps = frames * program.steps_per_call
    want = frames * -(-program.steps_per_call
                      // getattr(program.step, "group", 1))
    reset_launches()
    state = app.run(frames, save_camera=False)
    torch.cuda.synchronize()
    path_launches = dict(launches)
    for name in names:
        require(path_launches.get(name, 0) == want,
                f"{name} launched {path_launches.get(name, 0)} times in "
                f"{steps} main-path steps (want {want})")
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
# four words, and csrc/philox_bits.cu evaluates each block once), plus the
# word's index arithmetic.
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
    Lanes whose cast origin is parked at 3e30 are dead and not counted.
    With `tri_buffers` (a TriangleBuffers), the nearest-hit casts that
    triangle_pt seeds with a certain hit ("seeded") and those that find
    nothing under the seed and walk again ("fallbacks", the plain
    counter: ops/kernels/triangle_pt.py takes_fallback), and in `won` the
    soup triangles that win a nearest-hit cast."""

    def __init__(self, cfg, spheres=None, mesh_bounds=None, visible=None,
                 tri_buffers=None):
        self.cfg, self.spheres = cfg, spheres
        self.mesh_bounds = mesh_bounds
        self.visible = visible  # (K, n) bool: the tiles' visible spheres
        self.tri_buffers = tri_buffers
        self.won = (None if tri_buffers is None else torch.zeros(
            tri_buffers.attrs.shape[0], dtype=torch.bool,
            device=tri_buffers.attrs.device))
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
            if self.tri_buffers is not None:
                from l2n_tpu_torch.ops.kernels.triangle_pt import (
                    certain_hit_seed,
                    takes_fallback,
                )
                self.won[torch.broadcast_to(h.tri, hit.shape)[hit]] = True
                seed = certain_hit_seed(self.tri_buffers, ox, oy, oz, dx,
                                        dy, dz)
                self.c[tag + "seeded"] += int(
                    (live & (seed < float("inf"))).sum())
                self.c[tag + "fallbacks"] += int(
                    (live & takes_fallback(seed, h.t)).sum())
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
               rng_state=None, cull_bounds=None, mesh_bounds=None,
               tri_buffers=None):
    """Counters of one plain render of the scheduled tiles (`accum` and
    `rng_state` are copied, not updated). With `cull_bounds` (4, n), the
    tiles' cone-visible counts over those spheres (the plain
    visibility_table): vis_sum and vis_max over the tiles, and
    vis_candidates, the visible candidates of every primary cast; with
    `mesh_bounds` (M, 4), the mesh bounds each bounce and any-hit cast
    enters (b_mesh_entries); with `spheres`, the candidates whose line
    meets the ray (a_meets, a_meets_vis, b_meets); with `tri_buffers`,
    the certain-hit seeds and fallbacks (WorkCount), and the distinct
    triangles that win a nearest-hit cast (hit_tris) and the sub-clusters
    of 16 slots that hold one (hit_subs)."""
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
    w = WorkCount(cfg, spheres, mesh_bounds, visible, tri_buffers)
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
    if tri_buffers is not None:
        c["hit_tris"] = int(w.won.sum())
        from l2n_tpu_torch.ops.kernels.triangle_pack import SUBSIZE
        slot = tri_buffers.tris.view(torch.int32)[:, 9]
        won = (slot >= 0) & w.won[slot.clamp(min=0)]
        c["hit_subs"] = int(won.reshape(-1, SUBSIZE).any(1).sum())
    c["pixels"] = sched.shape[0] * cfg.tile_height * cfg.tile_width
    c["samples"] = c["pixels"] * cfg.spp_per_step
    return c


def seed_share(c) -> str:
    """The certain-hit seeds and fallbacks of count_work's nearest-hit casts
    (tri_buffers), as text."""
    casts = c["a_casts"] + c["b_casts"]
    seeded = c["a_seeded"] + c["b_seeded"]
    falls = c["a_fallbacks"] + c["b_fallbacks"]
    return (f"{seeded} of {casts} nearest-hit casts seeded "
            f"({seeded / max(casts, 1):.4f}), {falls} walk again "
            f"({falls / max(casts, 1):.6f} of the casts; primaries "
            f"{c['a_fallbacks']}, the rest {c['b_fallbacks']})")


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
               plain_ms, bound_pair, graph_ms=None, **extra):
    """One row of the `kernels` line. `ms` is the kernel's device time per
    launch from torch.profiler (`ms_from` says so), or, where the profiler
    recorded none, the device time per call by CUDA-graph replay
    (`graph_ms`, where the row has one), else the CUDA events' time per
    call or step (`event_ms`, host dispatch included)."""
    ms, ms_from = ((profiled, "torch.profiler") if profiled is not None
                   else (graph_ms, "CUDA graph replay")
                   if graph_ms is not None else (event_ms, "CUDA events"))
    if graph_ms is not None:
        extra["graph_ms"] = graph_ms
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "tolerance": tol, "ms": ms, "ms_from": ms_from,
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
    two_root_o=11,   # the two-root form once per (lane, sphere): o - c (3),
                     # c = |o - c|^2 - r2 (6), and hb's products roy dy,
                     # roz dz (2), which the repeats share (dx alone moves)
    two_root_miss=6,  # per repeat, a candidate whose line misses: hb on
                      # those products (3), the discriminant (2), its test (1)
    two_root_d=14,   # one whose line meets: those 6, sqrt, the roots (2)
                     # and their selects (4), the `t < best` test (1)
    t1_only=22,      # a t1-only candidate whose line meets the ray: co =
                     # c - o (3), nhb (5), c (6), disc (2), disc >= 0 (1),
                     # sqrt, t1, t1 >= 0 and its select (4), t < best (1)
    t1_only_miss=17,  # one whose line misses: up to disc >= 0
    vpu_rep=11,      # per lane and repeat: perturb, accumulate
    mma_pair=3,      # the mma algebra once per (lane, sphere): c = |o|^2 -
                     # (o.c + o.c) + (|c|^2 - r^2) (o.c: the tensor rate)
    mma_miss=4,      # per repeat, a candidate whose line misses: hb = o.d -
                     # c.d, hb^2, the discriminant, its test
    mma_meet=12,     # one whose line meets: those 4, sqrt, the roots (2)
                     # and their selects (4), the `t < best` test (1)
    mma_rep=19,      # per lane and repeat: o.d (5), the perturbation (3),
                     # the gather (2), the row and its accumulation (9)
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


def sweep_bounds(lanes, n, reps, meets, meets_mma):
    """{kernel: (bound_ms, bound_by)} of the three sweep kernels. A
    candidate pays for its sqrt, roots and update (the carry's 4 selects,
    or vpu2's 2 and its gather) only where its line meets the sphere:
    `meets` of lanes x reps x n for the scalar pair's algebra
    (`sweep_meets`), `meets_mma` for the mma sweep's (`mma_meets`), as the
    renderers' and the onehot pair's sweeps are counted. The mma sweep's
    dot products count at the FP64 tensor rate (the exact products its
    plain version defines, whatever computes them), against its fp32 work
    and its bytes."""
    cand, pairs = lanes * reps * n, lanes * n
    io = lanes * 32
    scalar = (pairs * PROBE_OPS["two_root_o"]
              + (cand - meets) * PROBE_OPS["two_root_miss"])
    vpu = (scalar + meets * (PROBE_OPS["two_root_d"] + 4)
           + lanes * reps * PROBE_OPS["vpu_rep"])
    vpu2 = (scalar + meets * (PROBE_OPS["two_root_d"] + 2)
            + lanes * reps * (PROBE_OPS["vpu_rep"] + 1))
    mma_ops = (pairs * PROBE_OPS["mma_pair"]
               + (cand - meets_mma) * PROBE_OPS["mma_miss"]
               + meets_mma * PROBE_OPS["mma_meet"]
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


def sweep_meets(o, d, spheres, repeats, chunks=()):
    """(candidates (lane, sphere, repeat) of the two-root sweep whose line
    meets the sphere, hb^2 - c >= 0, in float32 as the kernels compute
    them, over every repeat's perturbed direction; {R: (the share of (lane,
    sphere, chunk of R repeats) that the scalar kernels' pass 1 marks, and
    their pass 2's rounds per warp and chunk: the most marked spheres of a
    lane of the warp in each block of 32 spheres, summed over the blocks)}
    for each R of `chunks`)."""
    ox, oy, oz = (t.reshape(-1, 1) for t in o)
    dx, dy, dz = (t.reshape(-1, 1) for t in d)
    cx, cy, cz, r2 = spheres
    rox, roy, roz = ox - cx, oy - cy, oz - cz
    py, pz = roy * dy, roz * dz
    c = rox * rox + roy * roy + roz * roz - r2
    one, step = (torch.tensor(v, dtype=torch.float32, device=ox.device)
                 for v in (1.0, 1e-4))
    meets, per_repeat = 0, []
    for r in range(repeats):
        hb = rox * (dx * (one + step * float(r))) + py + pz
        per_repeat.append(hb * hb - c >= 0)
        meets += int(per_repeat[-1].sum())
    n = c.shape[1]
    pad = -n % 32
    passes = {}
    for k in chunks:
        marked, rounds = [], []
        for r0 in range(0, repeats, k):
            mk = torch.stack(per_repeat[r0:r0 + k]).any(0).to(torch.int32)
            marked.append(float(mk.float().mean()))
            blocks = torch.nn.functional.pad(mk, (0, pad)).reshape(
                -1, 32, (n + pad) // 32, 32).sum(3).amax(1)
            rounds.append(float(blocks.sum(1).float().mean()))
        passes[k] = (round(sum(marked) / len(marked), 6),
                     round(sum(rounds) / len(rounds), 4))
    return meets, passes


def mma_meets(o, d, cmat, repeats) -> int:
    """Candidates (lane, sphere, repeat) of the mma sweep's algebra whose
    line meets the sphere, hb^2 - c >= 0 in its plain version's arithmetic
    (probes/sweep_variants.py sweep_mma_plain: the dot products exact and
    rounded once), over every repeat's perturbed direction."""
    from l2n_tpu_torch.probes import sweep_variants as sv
    n = cmat.shape[1]
    centre = tuple(cmat[k].view(n, 1) for k in range(3))
    ox, oy, oz = (t.reshape(1, -1) for t in o)
    dy, dz = (t.reshape(1, -1) for t in d[1:])
    oc = sv._dot(centre, ox, oy, oz, True)
    c = ox * ox + oy * oy + oz * oz - (oc + oc) + cmat[4].view(n, 1)
    meets = 0
    for r in range(repeats):
        dx = d[0].reshape(1, -1) * sv._scale(r, ox.device)
        hb = (ox * dx + oy * dy + oz * dz) - sv._dot(centre, dx, dy, dz, True)
        meets += int((hb * hb - c >= 0).sum())
    return meets


def onehot_meets(rays, spheres) -> int:
    """Candidates (lane, sphere) of the t1-only sweep whose line meets the
    ray (nhb^2 - c >= 0), in float32 as the kernels compute them."""
    ox, oy, oz, dx, dy, dz = (r.reshape(-1, 1) for r in rays)
    cx, cy, cz, r2 = spheres
    cox, coy, coz = cx - ox, cy - oy, cz - oz
    nhb = cox * dx + coy * dy + coz * dz
    c = (cox * cox - r2) + coy * coy + coz * coz
    return int((nhb * nhb - c >= 0).sum())


def onehot_bounds(lanes, s, meets):
    """The pair's bounds: a candidate pays for its sqrt, root and update
    (the carry's 4 attribute selects and 2 more, the gather's 2) only where
    the ray's line meets the sphere (`meets` of lanes x s), as the renderers'
    sweeps are counted."""
    miss = (lanes * s - meets) * PROBE_OPS["t1_only_miss"]
    return {"onehot_carry": bound(miss + meets * (PROBE_OPS["t1_only"] + 6)
                                  + lanes * 7, lanes * 48 + 16 * s),
            "onehot_gather": bound(miss + meets * (PROBE_OPS["t1_only"] + 2)
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
    16 repeats), each kernel against its plain version (bit-equal) and the
    probe's own check (vpu2 = vpu); the scalar pair also at (n, repeats) =
    (100, 5) and (13, 3), the mma sweep at (8, 1), (24, 3) and (120, 5),
    on 4 blocks; all three timed by CUDA-graph replay beside
    torch.profiler."""
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.probes import elapsed_ms
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
    scalar = {"sweep_vpu": (sv.sweep_vpu, sv.sweep_vpu_plain),
              "sweep_vpu2": (sv.sweep_vpu2, sv.sweep_vpu2_plain)}
    calls = {name: (lambda k=k: k(o, d, *sph, bias),
                    lambda p=p: p(o, d, *sph, bias))
             for name, (k, p) in scalar.items()}
    out, err, plain_ms = {}, {}, {}
    for name, (kern, plain) in calls.items():
        out[name] = kern()
        want, plain_ms[name] = timed_result(plain)
        require(bits_equal(out[name], want), f"{name} kernel/plain bit-equal")
        err[name] = 0.0
    require(bits_equal(out["sweep_vpu2"], out["sweep_vpu"]),
            "vpu2 = vpu bit for bit")
    require(torch.equal(res["vpu"][0], out["sweep_vpu"])
            and torch.equal(res["vpu2carry"][0], out["sweep_vpu2"]),
            "the probe's main computed the same sweeps")
    # Fewer spheres and repeats than the chunk and the sphere loop's unroll
    # divide: remainder chunks and the remainder loop, 4 blocks.
    small = {}
    for sn, sreps in ((100, 5), (13, 3)):
        x = {k: torch.from_numpy(v[:sn] if v.ndim == 1 else v).to(dev)
             for k, v in sv.inputs(blocks=4).items() if k != "cmat"}
        xs = [x[k] for k in ("cx", "cy", "cz", "r2")]
        b = torch.zeros((4, 32, 128), dtype=torch.float32, device=dev)
        got = {}
        for name, (kern, plain) in scalar.items():
            got[name] = kern(x["o"], x["d"], *xs, b, sreps)
            require(bits_equal(got[name], plain(x["o"], x["d"], *xs, b, sreps)),
                    f"{name} kernel/plain bit-equal at n = {sn}, "
                    f"{sreps} repeats")
        require(bits_equal(got["sweep_vpu2"], got["sweep_vpu"]),
                f"vpu2 = vpu at n = {sn}, {sreps} repeats")
        small[f"n={sn},repeats={sreps}"] = round(
            float((got["sweep_vpu"] > b).float().mean()), 4)
    # The mma sweep, bit-equal to its plain version (acc and every
    # repeat's index) at the probe's size and, on 4 blocks, at (n, repeats)
    # that are not multiples of the sphere tile (16) or the chunk (16); its
    # counts of the miss test's passes and the resolve's rounds.
    ik = torch.empty((reps, *bias.shape), dtype=torch.int32, device=dev)
    ip = torch.empty_like(ik)
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    mk = sv.sweep_mma(o, d, cmat, bias, reps, ik, stats)
    mp, plain_ms["sweep_mma"] = timed_result(
        lambda: sv.sweep_mma_plain(o, d, cmat, bias, reps, ip))
    require(bits_equal(mk, mp) and torch.equal(ik, ip),
            "sweep_mma kernel/plain bit-equal, acc and index")
    err["sweep_mma"] = 0.0
    mma_small = {}
    x4 = {k: torch.from_numpy(v).to(dev)
          for k, v in sv.inputs(blocks=4).items()}
    b4 = torch.zeros((4, 32, 128), dtype=torch.float32, device=dev)
    for sn, sreps in ((8, 1), (24, 3), (120, 5)):
        sc = x4["cmat"][:, :sn].contiguous()
        i_k = torch.empty((sreps, 4, 32, 128), dtype=torch.int32, device=dev)
        i_p = torch.empty_like(i_k)
        got = sv.sweep_mma(x4["o"], x4["d"], sc, b4, sreps, i_k)
        want = sv.sweep_mma_plain(x4["o"], x4["d"], sc, b4, sreps, i_p)
        require(bits_equal(got, want) and torch.equal(i_k, i_p),
                f"sweep_mma kernel/plain bit-equal at n = {sn}, {sreps} "
                f"repeats")
        mma_small[f"n={sn},repeats={sreps}"] = round(
            float((i_k >= 0).float().mean()), 4)
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
    shape = {name: sv.launch_shape(name, lanes, n) for name in names}
    meets, passes = sweep_meets(o.reshape(3, -1), d.reshape(3, -1), sph,
                                reps, sorted({shape[k][0] for k in scalar}))
    meets_mma = mma_meets(o, d, cmat, reps)
    st = [int(v) for v in stats.tolist()]
    chunks = -(-reps // shape["sweep_mma"][0])
    mma_test = {"meets": meets_mma,
                "meets_share": meets_mma / (lanes * reps * n),
                "pairs_passed": st[0],
                "pair_share": st[0] / (lanes * n * chunks),
                "resolved": st[1],
                "resolved_share": st[1] / (lanes * reps * n),
                "rounds_per_warp_chunk": st[2] / st[3]}
    bounds = sweep_bounds(lanes, n, reps, meets, meets_mma)
    rows, times = [], {}
    for name, kern in kernels.items():
        ms = profile_calls(kern, 10, f"{name}_kernel")
        graph = elapsed_ms(kern, 20, dev, rounds=3)
        event = timed_calls(kern, 2, 10)
        ps = (graph if ms is None else ms) * 1e9 / (lanes * reps * n)
        times[name] = {"kernel_ms": ms, "graph_ms": round(graph, 5),
                       "event_ms": round(event, 4),
                       "plain_ms": round(plain_ms[name], 2),
                       "ps_per_lane_cand": round(ps, 3),
                       "bound_ms": round(bounds[name][0], 5),
                       "share_of_bound": round(
                           bounds[name][0] / (graph if ms is None else ms),
                           4)}
        extra = {}
        if name in shape:
            extra = dict(zip(("repeats_per_chunk", "threads", "grid",
                              "blocks_per_sm"), shape[name]))
        rows.append(kernel_row(
            name, SWEEP_SRC, f"benchmarks/sweep_variants.py:"
            f"{ {'sweep_vpu': 83, 'sweep_vpu2': 101, 'sweep_mma': 138}[name] }",
            n_launch[name], err[name],
            "bit-equal (also at n = 100 and 13)" if name != "sweep_mma" else
            "bit-equal, acc and index (also at (n, repeats) = (8, 1), "
            "(24, 3), (120, 5))", ms, event, plain_ms[name], bounds[name],
            graph_ms=graph, ps_per_lane_candidate=ps, **extra))
    cand = lanes * reps * n
    phase(20, f"sweep_variants probe ({bias.shape[0]} blocks, {n} spheres, "
              f"{reps} repeats): vpu, vpu2 bit-equal to their plain "
              f"versions and to each other, also at (n, repeats) = (100, 5) "
              f"and (13, 3) on 4 blocks (lanes that hit {small}); launch "
              f"(repeats per chunk, threads, grid, blocks per SM) {shape}; "
              f"{meets} of {cand} candidates ({meets / cand:.5f}) meet their "
              f"sphere; by repeats per chunk, the share of (lane, sphere, "
              f"chunk) that pass 1 marks and pass 2's rounds per warp and "
              f"chunk {passes}; sweep_mma bit-equal to its plain version "
              f"(acc and index), also at (n, repeats) = (8, 1), (24, 3), "
              f"(120, 5) on 4 blocks (lanes that hit in a repeat "
              f"{mma_small}); its algebra's meeting candidates, the (lane, "
              f"sphere) pairs whose miss test passed in a chunk of "
              f"{shape['sweep_mma'][0]} repeats (true meets and margin "
              f"passes), the candidates resolved exactly and the resolve's "
              f"rounds per (warp, chunk) {mma_test}; against "
              f"float32 dot products (the JAX kernel's arithmetic; lanes of "
              f"{lanes}: winners agree in every repeat, |d acc| above 1e-4 "
              f"max(|acc|, 1) there, largest such, largest overall) {fp32}; "
              f"max |mma - "
              f"vpu| {mma_vpu:.4g}; mma products at the FP64 tensor rate "
              f"{mma_tensor_ms(lanes, n, reps):.4f} ms; probe main ms/call "
              f"{ {k: round(v[1], 4) for k, v in res.items()} } (device "
              f"time of a CUDA graph of 8 chained calls, best of 3 "
              f"replays); per kernel (ms/launch by torch.profiler over 10, "
              f"ms/call by CUDA-graph replay of 20, best of 3, and by CUDA "
              f"events, plain ms/call) {times}; card: {card}")
    return rows, times


def onehot_calls(oh, x):
    """{kernel: (the wrapper's call, its plain version's)} on inputs x."""
    r, sp, tb = x["rays"], x["spheres"], x["table"]
    return {"onehot_carry": (lambda: oh.onehot_carry(r, sp),
                             lambda: oh.onehot_carry_plain(r, sp)),
            "onehot_gather": (lambda: oh.onehot_gather(r, sp, tb),
                              lambda: oh.onehot_gather_plain(r, sp, tb))}


def probe_onehot(card):
    """Phase 21: the onehot_recovery probe's check and time modes (S =
    128), then each kernel against its plain version at S = 128, 100 and
    16 (all six planes bit-equal, gather = carry on hits, miss r2 1 / 0),
    and each kernel's time by torch.profiler, CUDA-graph replay and CUDA
    events."""
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.probes import elapsed_ms
    from l2n_tpu_torch.probes import onehot_recovery as oh
    reset_launches()
    require(oh.main(["check"]) is True, "onehot check: gather = carry on hits")
    marginal = oh.main(["time"])
    torch.cuda.synchronize()
    n_launch = {k: launches[k] for k in ("onehot_carry", "onehot_gather")}
    require(all(n_launch.values()), f"both onehot kernels launched {n_launch}")
    dev = torch.device("cuda")
    hits, plain_ms = {}, {}
    for s in (oh.S, 100, 16):
        x = {k: torch.from_numpy(v).to(dev) for k, v in oh.inputs(s).items()}
        calls = onehot_calls(oh, x)
        got = {}
        for name, (kern, plain) in calls.items():
            got[name] = kern()
            want, ms = timed_result(plain)
            if s == oh.S:
                plain_ms[name] = ms
            require(bits_equal(got[name], want),
                    f"{name} kernel/plain bit-equal (all lanes, S = {s})")
        hit = got["onehot_carry"][1] >= 0
        require(torch.equal(got["onehot_carry"][:, hit],
                            got["onehot_gather"][:, hit]),
                f"gather = carry on hits (S = {s})")
        require(bool((got["onehot_carry"][5][~hit] == 1).all())
                and bool((got["onehot_gather"][5][~hit] == 0).all()),
                f"misses: carry r2 = 1, gather r2 = 0 (S = {s})")
        hits[s] = round(float(hit.float().mean()), 4)
        if s == oh.S:
            main_calls, main_x = calls, x
    lanes, s = oh.TH * oh.TW, oh.S
    meets = onehot_meets(main_x["rays"].reshape(6, -1), main_x["spheres"])
    bounds = onehot_bounds(lanes, s, meets)
    group, threads, blocks = oh.launch_shape(lanes)
    rows, times = [], {}
    for name, (kern, _) in main_calls.items():
        ms = profile_calls(kern, 50, f"{name}_kernel")
        graph = elapsed_ms(kern, 200, dev, rounds=3)
        event = timed_calls(kern, 5, 200)
        times[name] = {"kernel_ms": ms, "graph_ms": round(graph, 5),
                       "event_ms": round(event, 5),
                       "plain_ms": round(plain_ms[name], 3),
                       "bound_ms": round(bounds[name][0], 6),
                       "share_of_bound": round(
                           bounds[name][0] / (graph if ms is None else ms),
                           4)}
        rows.append(kernel_row(
            name, ONEHOT_SRC, "benchmarks/onehot_recovery.py:"
            f"{100 if name == 'onehot_carry' else 112}", n_launch[name], 0.0,
            "bit-equal (all six planes, all lanes; S = 128, 100, 16)", ms,
            event, plain_ms[name], bounds[name], graph_ms=graph,
            lanes_per_ray=group, grid=blocks))
    phase(21, f"onehot_recovery probe (one 32x128 block; {group} lanes per "
              f"ray, {threads}-thread blocks, grid {blocks}): check PASS, "
              f"both kernels bit-equal to their plain versions on all six "
              f"planes at S = 128, 100, 16 (hit fraction {hits}), gather = "
              f"carry on hits, miss r2 1 / 0; {meets} of {lanes * s} "
              f"candidates meet their ray at S = {s}; launches {n_launch}; "
              f"marginal ms/call "
              f"{ {k: round(v, 5) for k, v in marginal.items()} } (host "
              f"clock, (t(800) - t(400)) / 400); per kernel (ms/launch by "
              f"torch.profiler over 50, ms/call by CUDA-graph replay of 200, "
              f"best of 3, and by CUDA events over 200) {times}; card: "
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
    only the culled meshes; and the four path views again with the
    viewproj camera, whose cones come from its own corner rays. Gates:
    accum max abs 0, lit > 5%; for the meshes with viewproj, bit-equal but
    at the pixels where the plain sweep kept a hit outside its mesh's
    bound (triangle_vs_watched)."""
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
    # The same four views with the viewproj camera, whose tile cones come
    # from its own corner rays (csrc/cull.cuh camera_direction).
    views += [(f"{name}, viewproj", kern, plain,
               vcfg.replace(ray_gen="viewproj"), scene_arg, cam, bounds, note)
              for name, kern, plain, vcfg, scene_arg, cam, bounds, note
              in views[:4]]
    out = {}
    for name, kern, plain, vcfg, scene_arg, cam, bounds, note in views:
        n_straddle, counts = straddling(vcfg, bounds, cam)
        steps = 4 if vcfg.aov == "pathtracing" else 1
        if kern is triangle_pt and vcfg.ray_gen == "viewproj":
            res = triangle_vs_watched(vcfg, scene_arg, cam, steps, 0.05)
            err, lit = res["max_abs"], res["lit"]
            extra = {k: res[k] for k in ("pixels_differing",
                                         "pixels_sliver_hit")}
        else:
            _, err, _, lit, _ = kernel_vs_plain(kern, plain, vcfg, scene_arg,
                                                cam, steps)
            require(err == 0.0, f"{name}: kernel/plain accum max abs {err}")
            extra = {}
        out[name] = {"max_abs": err, "lit": round(lit, 4),
                     "visible_mean": round(float(counts.float().mean()), 3),
                     "visible_max": int(counts.max()),
                     "straddling": n_straddle, **extra,
                     **({"view": note} if note else {})}
    return out


# ---------------------------------------------------------------------------
# The primary-only AOVs, the sun sky, viewproj and fast_math (phases 25-28)
# ---------------------------------------------------------------------------
SUN_CFG = dict(env_mode="sun", ray_gen="viewproj")
SUN_FAST_CFG = dict(SUN_CFG, fast_math=True)
RNG_MODES = ("threefry", "tpu_hw", "tinymt", "tauslcg")


def sun_view(cfg, spheres):
    """The camera one world size from the scene's centre against the sun's
    direction normalize(1, 1, -1), looking at the centre: the misses near
    the view's axis see the sun lobe (pow 128, lit within ~25 degrees)."""
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.maths.linalg import look_at
    centre = spheres[:3].cpu().numpy().astype(np.float64).mean(1)
    sun = np.array([1.0, 1.0, -1.0]) / np.sqrt(3.0)
    eye = centre - sun * cfg.world_size
    vm = look_at(eye.astype(np.float32), centre.astype(np.float32),
                 np.array([0.0, 1.0, 0.0], np.float32))
    return Camera.from_config(cfg, view_matrix=vm).packed()


def sun_lanes(cfg, spheres, cam) -> torch.Tensor:
    """(Hp, Wp) bool: the visible pixels whose zero-jitter primary ray
    misses every sphere (so every mesh inside one) with sun_le > 0, from the
    plain functions on the card."""
    from l2n_tpu_torch.ops.envlight import sun_le
    from l2n_tpu_torch.ops.intersect import intersect_sphere_scene
    from l2n_tpu_torch.ops.pathtrace import generate_rays
    dev = spheres.device
    py, px = torch.meshgrid(
        torch.arange(cfg.height, dtype=torch.float32, device=dev),
        torch.arange(cfg.width, dtype=torch.float32, device=dev),
        indexing="ij")
    zero = torch.zeros_like(px)
    rays = generate_rays(cfg, torch.as_tensor(cam).to(dev), px, py, zero,
                         zero)
    t = intersect_sphere_scene(*rays, *spheres[:4], cfg.fast_math)[0]
    lit = (t < 0.0) & (sun_le(*rays[3:]) > 0.0)
    out = torch.zeros((cfg.padded_height, cfg.padded_width), dtype=torch.bool,
                      device=dev)
    out[:cfg.height, :cfg.width] = lit
    return out


def watched_triangle_plain(flags):
    """triangle_pt_plain (NEE's light sampler too) with its nearest-hit
    sweep watched: `flags` (Hp * Wp,) bool gets, IN PLACE, every pixel one
    of whose rays (NEE's shadow rays too) the brute-force
    sweep hit outside the hit mesh's bound sphere (r^2 grown by 1e-3). No
    triangle lies there: such a hit is Moller-Trumbore's on a pole sliver
    whose |det| is just over its epsilon, and a t far from the triangle
    that the oracle (the JAX package's too) keeps and no bound hierarchy
    can find."""
    from l2n_tpu_torch.ops.kernels.common import (
        render_tiles_plain,
        tile_pixel_coords,
    )
    from l2n_tpu_torch.ops.nee import mesh_light_sampler
    from l2n_tpu_torch.ops.scenes import (
        TRIANGLE_MISS_COLOR,
        triangle_anyhit,
        triangle_intersector,
    )

    def plain(cfg, sched, cam, buf, accum, output, rng_state=None,
              lights=None):
        inner = triangle_intersector(
            buf.soup, buf.mesh_bounds[:, 3] if cfg.nee else None)
        mb = buf.mesh_bounds
        row, col = tile_pixel_coords(cfg, sched)
        flat = (row * cfg.padded_width + col).reshape(-1)

        def intersect(ox, oy, oz, dx, dy, dz):
            h = inner(ox, oy, oz, dx, dy, dz)
            m = h.index.clamp(min=0)
            d2 = sum((o + h.t * d - mb[m, i]) ** 2 for i, (o, d) in
                     enumerate(((ox, dx), (oy, dy), (oz, dz))))
            out = (h.t >= 0.0) & (d2 > mb[m, 3] * 1.001)
            flags[flat] |= out.reshape(-1)
            return h

        render_tiles_plain(cfg, sched, cam, intersect,
                           triangle_anyhit(intersect), buf.table(), accum,
                           output, rng_state, TRIANGLE_MISS_COLOR, lights,
                           mesh_light_sampler(cfg, buf.mesh_bounds)
                           if cfg.nee else None)

    return plain


def triangle_vs_watched(cfg, buf, cam, steps, min_lit=0.02, lights=None,
                        label="triangle"):
    """triangle_pt against its watched plain version for `steps` steps
    (with explicit `lights` where given): accum[3] and the state planes
    equal, accum bit-equal at every pixel but those where the plain sweep
    kept a hit outside its mesh's bound (watched_triangle_plain; shadow
    casts included), and more than `min_lit` of the rendered pixels lit;
    returns the counts, the max abs and that share."""
    from l2n_tpu_torch.ops.kernels.triangle_pt import triangle_pt
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    dev = torch.device("cuda")
    tiles = torch.as_tensor(tile_grid(cfg)).to(dev)
    k = cfg.effective_tiles_per_step
    ka, pa = init_frame_state(cfg, dev), init_frame_state(cfg, dev)
    flags = torch.zeros(cfg.padded_height * cfg.padded_width,
                        dtype=torch.bool, device=dev)
    plain = watched_triangle_plain(flags)
    for i in range(steps):
        sched = scheduled_tiles(tiles, i * k % cfg.tile_count, k)
        triangle_pt(cfg, sched, cam, buf, ka.accum, ka.output, ka.rng_state,
                    lights)
        plain(cfg, sched, cam, buf, pa.accum, pa.output, pa.rng_state, lights)
    torch.cuda.synchronize()
    require(torch.equal(ka.accum[3], pa.accum[3]), f"{label} accum[3] equal")
    if ka.rng_state is not None:
        require(torch.equal(ka.rng_state, pa.rng_state),
                f"{label} rng_state bit-equal")
    diff = (ka.accum.view(torch.int32) != pa.accum.view(torch.int32)).any(0)
    diff = diff.view(-1)
    unexplained = torch.nonzero(diff & ~flags).squeeze(1)
    shown = [(p // cfg.padded_width, p % cfg.padded_width,
              ka.accum.view(4, -1)[:, p].tolist(),
              pa.accum.view(4, -1)[:, p].tolist())
             for p in unexplained[:4].tolist()]
    require(unexplained.numel() == 0,
            f"{label} kernel/plain: {unexplained.numel()} pixels differ "
            f"where the plain sweep kept no hit outside its mesh's bound "
            f"((row, col, kernel accum, plain accum): {shown})")
    shown = pa.accum[:, :cfg.height, :cfg.width]
    lit = float(((shown[:3].abs().amax(0) > 0) & (shown[3] > 0)).sum()
                / (shown[3] > 0).sum())
    require(lit > min_lit, f"{label} lit {lit} > {min_lit} of the rendered "
                           f"pixels")
    return {"max_abs": float((ka.accum - pa.accum).abs().max()),
            "pixels_differing": int(diff.sum()),
            "pixels_sliver_hit": int(flags.sum()), "lit": lit}


def wavefront_passes_vs_plain(wcfg, sched, cam, spheres):
    """Pass A and pass B, kernel vs plain on the same inputs (pass B on the
    plain pass A's outputs): pass A's n_alive, col and back bit-equal, its
    rays and meta equal as sets (sorted by lane); pass B's back and col
    (which it zeroes at the survivors' lanes under NEE) bit-equal. Returns
    (n_alive, lanes)."""
    from l2n_tpu_torch.ops.kernels.wavefront import (
        wavefront_lanes,
        wavefront_pass_a,
        wavefront_pass_a_plain,
        wavefront_pass_b,
        wavefront_pass_b_plain,
    )
    from l2n_tpu_torch.render.state import init_frame_state
    dev = torch.device("cuda")
    accum = init_frame_state(wcfg, dev).accum
    ka = wavefront_lanes(wcfg, sched.shape[0], dev)
    ka.back.fill_(float("nan"))  # pass A leaves the survivors' lanes
    ka = wavefront_pass_a(wcfg, sched, cam, spheres, accum, ka)
    pa = wavefront_pass_a_plain(wcfg, sched, cam, spheres, accum)
    torch.cuda.synchronize()
    na = int(pa.n_alive[0])
    require(int(ka.n_alive[0]) == na, "pass A n_alive equal")
    require(bits_equal(ka.col, pa.col) and bits_equal(ka.back, pa.back),
            "pass A col and back bit-equal")
    order = torch.argsort(ka.meta[2, :na])
    require(torch.equal(ka.meta[:, :na][:, order], pa.meta[:, :na])
            and bits_equal(ka.rays[:, :na][:, order], pa.rays[:, :na]),
            "pass A rays and meta equal as sets")
    kb, pb = pa.back.clone(), pa.back.clone()
    kc, pc = pa.col.clone(), pa.col.clone()
    wavefront_pass_b(wcfg, cam, spheres, pa.rays, pa.meta, pa.n_alive, kb,
                     kc)
    wavefront_pass_b_plain(wcfg, cam, spheres, pa.rays, pa.meta, pa.n_alive,
                           pb, pc)
    torch.cuda.synchronize()
    require(not kb.isnan().any() and bits_equal(kb, pb),
            "pass B back bit-equal")
    require(bits_equal(kc, pc), "pass B col bit-equal (NEE: 0 at survivors)")
    return na, pa.col[0].numel()


def settings_timing(card, dev, cfg, scene, tri_cfg, tri_scene, cam):
    """Device time of the built step (CUDA events over back-to-back steps)
    and of its kernels per launch (torch.profiler) for each setting of the
    slices beside the default config's, at the main path's 10 tiles and at
    whole frames, in one process on one card. Returns {(family, label,
    setting): {kernel: ms per launch, "step": ms per step}}."""
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.step import build_render_step
    wave = ("wavefront_pass_a_kernel", "wavefront_pass_b_kernel",
            "wavefront_pass_c_kernel")
    from l2n_tpu_torch.ops.lights import ExplicitLights
    microfacet = {"material_mode": "microfacet"}
    materials = {"microfacet": microfacet,
                 "disney": {"material_mode": "disney"},
                 "normal_map": {"normal_map": 0.8},
                 "microfacet+normal_map": dict(microfacet, normal_map=0.8),
                 "lights": {"lights": True},
                 "lights+microfacet": dict(microfacet, lights=True)}
    nee = {"nee": NEE_SETTINGS["nee"], "nee+mis": NEE_SETTINGS["nee+mis"]}
    fog = {"fog": FOG, "fog+nee+mis": dict(FOG, nee=True, mis=True),
           "fog+nee+mis, tpu_hw": dict(FOG, nee=True, mis=True,
                                       rng="tpu_hw")}
    families = [
        ("sphere_pt", cfg, scene, ("sphere_pt_kernel",),
         {"default": {}, "normal": {"aov": "normal"}, "hit": {"aov": "hit"},
          "ambient_occlusion": {"aov": "ambient_occlusion"},
          "sun+viewproj": SUN_CFG, "sun+viewproj+fast_math": SUN_FAST_CFG,
          **materials, **nee,
          "nee+mis+microfacet+normal_map":
              NEE_SETTINGS["nee+mis+microfacet+normal_map"],
          "nee+mis+lights": dict(NEE_SETTINGS["nee+mis"], lights=True),
          **fog}),
        ("triangle_pt", tri_cfg, tri_scene, ("triangle_pt_kernel",),
         {"default": {}, "normal": {"aov": "normal"},
          "ambient_occlusion": {"aov": "ambient_occlusion"},
          "sun+viewproj": SUN_CFG, "sun+viewproj+fast_math": SUN_FAST_CFG,
          **materials, **nee, **fog}),
        ("wavefront", cfg.replace(wavefront=True), scene, wave,
         {"default": {}, "sun+viewproj": SUN_CFG,
          "sun+viewproj+fast_math": SUN_FAST_CFG,
          "microfacet": microfacet,
          "disney+normal_map": {"material_mode": "disney",
                                "normal_map": 0.8}, **nee})]
    results = {}
    for family, fcfg, fscene, kernels, settings in families:
        for label, lcfg in (("10-tile", fcfg), ("whole-frame", fcfg.replace(
                tiles_per_step=fcfg.tile_count))):
            for name, kw in settings.items():
                kw = dict(kw)
                lights = (ExplicitLights(*light_containers())
                          if kw.pop("lights", False) else None)
                scfg = lcfg.replace(**kw)
                step = build_render_step(scfg, fscene, backend="cuda",
                                         device=dev, lights=lights)
                st = init_frame_state(scfg, dev)
                for _ in range(3):
                    st = step(st, cam)
                n = 50 if label == "10-tile" else 10
                dev_ms, _, st = timed_steps(step, st, cam, n)
                per, _, _, st = profile_steps(step, st, cam, 10, kernels)
                results[(family, label, name)] = dict(per, step=dev_ms)
                print(f"[settings] {family} {label} {name}: step {dev_ms:.4f} "
                      f"ms (CUDA events); per launch (torch.profiler) "
                      + ", ".join(f"{k} " + ("not measured" if v is None
                                             else f"{v:.4f} ms")
                                  for k, v in per.items())
                      + f"; card: {card}", flush=True)
                del st, step
        torch.cuda.empty_cache()
    return results


def slice_phases(card, tmp, cfg, spheres, tri_cfg, tri_buf, cam):
    """Phases 25-28: the primary-only AOVs, the sun sky, viewproj and
    fast_math through sphere_pt, triangle_pt and the wavefront passes:
    kernel vs plain at the default 1280x720 config, whole frame for the
    sphere family and 10-tile steps for meshes, in every rng mode, then the
    main paths through Application."""
    from l2n_tpu_torch.app.application import Application
    from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt, sphere_pt_plain
    from l2n_tpu_torch.ops.kernels.wavefront import sphere_wavefront_step
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    dev = torch.device("cuda")
    swhole = cfg.replace(tiles_per_step=cfg.tile_count)

    # --- 25: sphere_pt, every new setting and rng mode, 2 whole frames ---
    settings = {"normal": {"aov": "normal"}, "hit": {"aov": "hit"},
                "ambient_occlusion": {"aov": "ambient_occlusion"},
                "sun+viewproj": SUN_CFG,
                "sun+viewproj+fast_math": SUN_FAST_CFG,
                "fast_math": {"fast_math": True}}
    fused = {}
    for name, kw in settings.items():
        for rng in RNG_MODES:
            scfg = swhole.replace(rng=rng, **kw)
            # 1 spp lights 2.9% of the default view; the Mandelbrot sky
            # needs 4 to pass the lit gate, the sun and the AOVs 2
            steps = 4 if name == "fast_math" else 2
            _, err, _, lit, state_eq = kernel_vs_plain(
                sphere_pt, sphere_pt_plain, scfg, spheres, cam, steps)
            require(err == 0.0, f"sphere_pt {name} rng={rng} max abs {err}")
            require(state_eq in (None, True),
                    f"sphere_pt {name} rng={rng} rng_state bit-equal")
            fused[f"{name}/{rng}"] = round(lit, 4)
    for aov in ("tex_coords", "param_uv"):
        _, err, _, lit, _ = kernel_vs_plain(
            sphere_pt, sphere_pt_plain, swhole.replace(aov=aov), spheres,
            cam, 1)
        require(err == 0.0, f"sphere_pt {aov} max abs {err}")
        fused[f"{aov}/threefry"] = round(lit, 4)
    phase(25, f"sphere_pt kernel vs plain, default {cfg.width}x{cfg.height} "
              f"config, 2 whole-frame steps per setting and rng mode (4 for "
              f"fast_math alone, 1 for tex_coords / param_uv): accum max abs "
              f"0, rng_state "
              f"bit-equal (fast_math too: torch.rsqrt on the card is "
              f"rsqrtf); lit: {fused}")

    # --- 26: the wavefront passes with the sun, viewproj, fast_math -----
    wave = {}
    s10 = scheduled_tiles(torch.as_tensor(tile_grid(cfg)).to(dev), 0,
                          cfg.effective_tiles_per_step)
    sall = scheduled_tiles(torch.as_tensor(tile_grid(cfg)).to(dev), 0,
                           cfg.tile_count)
    for name, kw in (("sun+viewproj", SUN_CFG),
                     ("sun+viewproj+fast_math", SUN_FAST_CFG)):
        for rng in ("threefry", "tpu_hw"):
            wcfg = cfg.replace(wavefront=True, rng=rng, **kw)
            whole = wcfg.replace(tiles_per_step=wcfg.tile_count)
            na, n = wavefront_passes_vs_plain(whole, sall, cam, spheres)
            na10, _ = wavefront_passes_vs_plain(wcfg, s10, cam, spheres)
            _, err, _, lit, _ = kernel_vs_plain(
                sphere_wavefront_step, sphere_pt, whole, spheres, cam, 2)
            require(err == 0.0, f"wavefront/fused {name} {rng} max abs {err}")
            wave[f"{name}/{rng}"] = {"alive": round(na / n, 4),
                                     "alive_10_tiles": na10,
                                     "lit": round(lit, 4)}
    phase(26, f"wavefront passes A and B kernel vs plain (pass A n_alive, "
              f"col, back bit-equal, rays and meta equal as sets; pass B "
              f"back bit-equal) at one whole frame and at 10 tiles, and the "
              f"wavefront CUDA step vs sphere_pt's, 2 whole-frame steps, "
              f"max abs 0: {wave}")

    # --- 27: the sun in view: misses along normalize(1, 1, -1) -----------
    vcam = sun_view(cfg, spheres)
    sun = {}
    for name, kw in (("sun+viewproj", SUN_CFG),
                     ("sun+viewproj+fast_math", SUN_FAST_CFG)):
        scfg = swhole.replace(**kw)
        lanes = sun_lanes(scfg, spheres, vcam)
        n_sun = int(lanes.sum())
        require(n_sun > 1000, f"{name}: {n_sun} primary misses see the sun")
        ka_pa = {}
        for label, kern, kcfg in (
                ("sphere_pt", sphere_pt, scfg),
                ("wavefront", sphere_wavefront_step,
                 scfg.replace(wavefront=True))):
            plain = sphere_pt_plain if label == "sphere_pt" else sphere_pt
            k_st, p_st = (init_frame_state(kcfg, dev) for _ in range(2))
            kern(kcfg, sall, vcam, spheres, k_st.accum, k_st.output)
            plain(kcfg, sall, vcam, spheres, p_st.accum, p_st.output)
            torch.cuda.synchronize()
            err = float((k_st.accum - p_st.accum).abs().max())
            require(err == 0.0, f"sun view {name} {label} max abs {err}")
            sky = k_st.accum[:3].amax(0)[lanes]
            lit_sun = float((sky > 0).float().mean())
            require(lit_sun > 0.9, f"sun view {name} {label}: {lit_sun} of "
                                   f"the sun lanes lit")
            ka_pa[label] = {"max_abs": err, "sun_lanes_lit": round(lit_sun, 4),
                            "sky_max": float(sky.max())}
        tcfg = tri_cfg.replace(**kw)
        ka_pa["triangle_pt 10 tiles"] = triangle_vs_watched(tcfg, tri_buf,
                                                            vcam, 2)
        sun[name] = {"sun_lanes": n_sun, **ka_pa}
    phase(27, f"the sun in view (camera along normalize(1,1,-1) at the "
              f"scene's centre), 1 whole-frame step, kernel vs plain (the "
              f"wavefront step vs sphere_pt's), 2 steps of 10 tiles for "
              f"meshes: {sun}")

    # --- 28: triangle_pt, 10-tile steps, every new setting ---------------
    tri = {}
    tri_settings = dict(settings)
    tri_settings.pop("fast_math")
    for name, kw in tri_settings.items():
        for rng in (RNG_MODES if name == "ambient_occlusion"
                    else ("threefry",)):
            tri[f"{name}/{rng}"] = triangle_vs_watched(
                tri_cfg.replace(rng=rng, **kw), tri_buf, cam, 2)
    phase(28, f"triangle_pt kernel vs plain, default triangle config, 2 "
              f"steps of 10 tiles per setting (every rng mode for the AO): "
              f"bit-equal (and rng_state) but at pixels whose plain "
              f"brute-force sweep kept a hit outside its mesh's bound: {tri}")

    # --- 29: the main paths ----------------------------------------------
    paths = {}
    for label, kw, renderer, names in (
            ("normal", {"aov": "normal"}, "spherePT", ("sphere_pt",)),
            ("hit", {"aov": "hit"}, "spherePT", ("sphere_pt",)),
            ("ambient_occlusion", {"aov": "ambient_occlusion"}, "spherePT",
             ("sphere_pt",)),
            ("sun+viewproj+fast_math", SUN_FAST_CFG, "spherePT",
             ("sphere_pt",)),
            ("sun+viewproj+fast_math, wavefront",
             dict(SUN_FAST_CFG, wavefront=True), "spherePT",
             ("wavefront_pass_a", "wavefront_pass_b", "wavefront_pass_c")),
            ("normal, meshes", {"aov": "normal"}, "trianglePT",
             ("triangle_pt",)),
            ("ambient_occlusion, meshes", {"aov": "ambient_occlusion"},
             "trianglePT", ("triangle_pt",)),
            ("sun+viewproj+fast_math, meshes", SUN_FAST_CFG, "trianglePT",
             ("triangle_pt",))):
        app = Application(RenderConfig(**kw), backend="cuda", device="cuda",
                          workdir=tmp, initial_renderer=renderer)
        frames = app.cfg.tile_count * 10 // app.cfg.effective_tiles_per_step
        got, lit, _ = run_main_path(app, frames, names)
        paths[label] = (got, round(lit, 4))
        del app
    phase(29, f"main paths through Application(RenderConfig(...), "
              f"backend=cuda), {frames} steps each, 10 spp everywhere, "
              f"finite: launches and lit {paths}; card: {card}")



# ---------------------------------------------------------------------------
# The material modes, the bump and the explicit lights (phases 30-33)
# ---------------------------------------------------------------------------

MATERIAL_SETTINGS = {
    "microfacet": {"material_mode": "microfacet"},
    "disney": {"material_mode": "disney"},
    "normal_map": {"normal_map": 0.8},
    "microfacet+normal_map": {"material_mode": "microfacet",
                              "normal_map": 0.8},
    "normal AOV+normal_map": {"aov": "normal", "normal_map": 0.8},
    "microfacet+fast_math": {"material_mode": "microfacet",
                             "fast_math": True}}


def light_containers():
    """tests/test_tpu_hw.py:256's buffers (materials, point_lights,
    directional_lights): two Phong albedos, a point light at the origin with
    intensity (5e7, 4e7, 3e7), a directional light (0.3, -1, 0.2) of
    radiance (0.5, 0.5, 0.6)."""
    from l2n_tpu_torch.scene.materials import (
        DirectionalLights,
        PhongMaterials,
        PointLights,
    )
    return (
        PhongMaterials.from_arrays(
            np.array([[0.9, 0.2, 0.1, 1.0], [0.1, 0.8, 0.3, 1.0]],
                     np.float32), np.zeros((2, 3), np.float32),
            np.zeros(2, np.float32)),
        PointLights.from_arrays(np.zeros((1, 3), np.float32),
                                np.array([[5e7, 4e7, 3e7]], np.float32)),
        DirectionalLights.from_arrays(
            np.array([[0.3, -1.0, 0.2]], np.float32),
            np.array([[0.5, 0.5, 0.6]], np.float32)))


def cluster_view(cfg, spheres):
    """The camera 0.6 world sizes from the scene's centre along
    normalize(1, 0.5, 1), looking at the centre: the spheres (or their
    meshes) fill most of the frame, so most primaries reach a material."""
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.maths.linalg import look_at
    centre = spheres[:3].cpu().numpy().astype(np.float64).mean(1)
    away = np.array([1.0, 0.5, 1.0]) / 1.5
    eye = centre + away * 0.6 * cfg.world_size
    vm = look_at(eye.astype(np.float32), centre.astype(np.float32),
                 np.array([0.0, 1.0, 0.0], np.float32))
    return Camera.from_config(cfg, view_matrix=vm).packed()


def materials_phases(card, tmp, cfg, scene, tri_cfg, tri_buf, cam):
    """Phases 30-32: the material modes, the bump and the explicit lights
    through sphere_pt, triangle_pt and the wavefront passes, kernel vs
    plain at max abs 0 from a view into the cluster (cluster_view; spheres
    at whole frames, meshes at 10-tile steps: the plain brute-force
    triangle step takes ~5.8 s a whole frame), then the main paths through
    Application and the programs from the default camera `cam`."""
    from l2n_tpu_torch.app.application import Application
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt, sphere_pt_plain
    from l2n_tpu_torch.ops.kernels.wavefront import sphere_wavefront_step
    from l2n_tpu_torch.ops.pathtrace import wavefront_draw_position
    from l2n_tpu_torch.render.program import SphereProgram, TriangleProgram
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    dev = torch.device("cuda")
    spheres = scene.packed().to(dev)
    swhole = cfg.replace(tiles_per_step=cfg.tile_count)
    view = cluster_view(cfg, spheres)

    # --- 30: kernel vs plain per setting and rng mode ---------------------
    fused, tri = {}, {}
    for name, kw in MATERIAL_SETTINGS.items():
        modes = RNG_MODES if name in ("microfacet", "disney") else (
            "threefry",)
        for rng in modes:
            scfg = swhole.replace(rng=rng, **kw)
            _, err, _, lit, state_eq = kernel_vs_plain(
                sphere_pt, sphere_pt_plain, scfg, spheres, view, 4)
            require(err == 0.0, f"sphere_pt {name} rng={rng} max abs {err}")
            require(state_eq in (None, True),
                    f"sphere_pt {name} rng={rng} rng_state bit-equal")
            fused[f"{name}/{rng}"] = round(lit, 4)
            tri[f"{name}/{rng}"] = triangle_vs_watched(
                tri_cfg.replace(rng=rng, **kw), tri_buf, view, 4)
    wave = {}
    s10 = scheduled_tiles(torch.as_tensor(tile_grid(cfg)).to(dev), 0,
                          cfg.effective_tiles_per_step)
    sall = scheduled_tiles(torch.as_tensor(tile_grid(cfg)).to(dev), 0,
                           cfg.tile_count)
    for name in ("microfacet", "disney"):
        for rng in ("threefry", "tpu_hw"):
            wcfg = cfg.replace(wavefront=True, rng=rng, normal_map=0.8,
                               **MATERIAL_SETTINGS[name])
            require(wavefront_draw_position(wcfg) == (3, False),
                    "pass B resumes at pair 3 with no spare pending")
            whole = wcfg.replace(tiles_per_step=wcfg.tile_count)
            na, n = wavefront_passes_vs_plain(whole, sall, view, spheres)
            na10, _ = wavefront_passes_vs_plain(wcfg, s10, view, spheres)
            _, err, _, lit, _ = kernel_vs_plain(
                sphere_wavefront_step, sphere_pt, whole, spheres, view, 4)
            require(err == 0.0, f"wavefront/fused {name} {rng} max abs {err}")
            wave[f"{name}+normal_map/{rng}"] = {
                "alive": round(na / n, 4), "alive_10_tiles": na10,
                "lit": round(lit, 4)}
    phase(30, f"material modes and the bump, kernel vs plain from a view "
              f"into the cluster: sphere_pt 4 "
              f"whole-frame steps per setting and rng mode, accum max abs 0, "
              f"rng_state bit-equal, lit {fused}; triangle_pt 4 steps of 10 "
              f"tiles, bit-equal but at pixels whose plain sweep kept a hit "
              f"outside its mesh's bound: {tri}; wavefront passes A/B vs "
              f"plain (one whole frame and 10 tiles) and the wavefront CUDA "
              f"step vs sphere_pt's, 4 whole-frame steps, max abs 0: {wave}")

    # --- 31: the explicit lights through the fused kernels ----------------
    from l2n_tpu_torch.ops.lights import ExplicitLights
    lights = ExplicitLights(*light_containers())
    lit_spheres = scene.with_tables(
        albedo=lights.override_albedo(scene.albedo)).packed().to(dev)
    lit_tri = tri_buf.with_tables(
        albedo=lights.override_albedo(tri_buf.albedo.T))
    got = {}
    for mode in ("procedural", "microfacet"):
        lcfg = swhole.replace(material_mode=mode)
        _, err, _, lit, _ = kernel_vs_plain(
            sphere_pt, sphere_pt_plain, lcfg, lit_spheres, view, 4, lights)
        require(err == 0.0, f"sphere_pt lights {mode} max abs {err}")
        energy = []
        for lt in (lights, None):
            st = init_frame_state(lcfg, dev)
            sphere_pt(lcfg, sall, view, lit_spheres, st.accum, st.output,
                      lights=lt)
            energy.append(float(st.accum[:3].sum()))
        require(energy[0] > 1.05 * energy[1],
                f"the lights add light: {energy[0]} > 1.05 x {energy[1]}")
        got[f"spheres/{mode}"] = {"lit": round(lit, 4),
                                  "energy_with_without": energy}
        got[f"meshes/{mode}"] = triangle_vs_watched(
            tri_cfg.replace(material_mode=mode), lit_tri, view, 4,
            lights=lights)
    phase(31, f"explicit lights (two Phong albedos, a point light at the "
              f"origin, a directional light), kernel vs plain: sphere_pt 4 "
              f"whole-frame steps, accum max abs 0; triangle_pt 4 steps of "
              f"10 tiles with the pole-sliver gate: {got}")

    # --- 32: the main paths -----------------------------------------------
    paths = {}
    for label, kw, renderer, names in (
            ("microfacet+normal_map", {"material_mode": "microfacet",
                                       "normal_map": 0.8}, "spherePT",
             ("sphere_pt",)),
            ("microfacet+normal_map, meshes", {"material_mode": "microfacet",
                                               "normal_map": 0.8},
             "trianglePT", ("triangle_pt",)),
            ("disney+normal_map, wavefront", {"material_mode": "disney",
                                              "normal_map": 0.8,
                                              "wavefront": True},
             "spherePT", ("wavefront_pass_a", "wavefront_pass_b",
                          "wavefront_pass_c"))):
        app = Application(RenderConfig(**kw), backend="cuda", device="cuda",
                          workdir=tmp, initial_renderer=renderer)
        frames = app.cfg.tile_count * 10 // app.cfg.effective_tiles_per_step
        got_l, lit, _ = run_main_path(app, frames, names)
        paths[label] = (got_l, round(lit, 4))
        del app
    buffers = dict(zip(("materials", "point_lights", "directional_lights"),
                       light_containers()))
    for label, program, name in (("lights, SphereProgram", SphereProgram,
                                  "sphere_pt"),
                                 ("lights, TriangleProgram", TriangleProgram,
                                  "triangle_pt")):
        pcfg = RenderConfig(material_mode="microfacet")
        prog = program(pcfg, backend="cuda", device=dev, **buffers)
        st = init_frame_state(prog.cfg, dev)
        frames = pcfg.tile_count * 10 // pcfg.effective_tiles_per_step
        reset_launches()
        for _ in range(frames):
            st = prog.step(st, cam)
        torch.cuda.synchronize()
        n_launch = launches.get(name, 0)
        require(n_launch == frames, f"{label}: {name} launched {n_launch} "
                                    f"times in {frames} steps")
        shown = st.accum[:, :pcfg.height, :pcfg.width]
        require(bool((shown[3] == 10).all()), f"{label}: 10 spp")
        require(bool(torch.isfinite(shown).all()), f"{label}: finite")
        lit = float((shown[:3].amax(0) > 0).float().mean())
        require(lit > 0.05, f"{label}: lit {lit} > 0.05")
        paths[label] = ({name: n_launch}, round(lit, 4))
        del prog, st
    phase(32, f"main paths, {frames} steps each through Application("
              f"RenderConfig(...), backend=cuda) and the programs with "
              f"explicit lights: launches and lit {paths}; card: {card}")


NEE_SETTINGS = {
    "nee": {"nee": True},
    "nee+mis": {"nee": True, "mis": True},
    "nee+mis+microfacet+normal_map": {"nee": True, "mis": True,
                                      "material_mode": "microfacet",
                                      "normal_map": 0.8}}


def nee_gallery(dev):
    """tests/test_nee.py's analytic scene: the light (sphere 0, r = 2) at z
    = 10 over a big sphere (r = 99) whose top sits at z = -1."""
    from l2n_tpu_torch.scene.spheres import SphereScene
    return SphereScene.from_numpy(
        np.zeros(2, np.float32), np.zeros(2, np.float32),
        np.array([10.0, -100.0], np.float32),
        np.array([4.0, 99.0 ** 2], np.float32), device=dev)


def nee_estimate(dev, **kw):
    """The mean red radiance per sample of 2 whole frames of sphere_pt over
    the analytic scene, the camera at (0, 0, 3) looking straight down with a
    4 degree field, so every primary reaches the big sphere within 0.25 of
    its top: (mean, samples, the red albedo kd of sphere 1)."""
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.maths.linalg import look_at
    from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    scene = nee_gallery(dev)
    cfg = RenderConfig(env_mode="none", fovy_deg=4.0, **kw)
    cfg = cfg.replace(tiles_per_step=cfg.tile_count).validate()
    vm = look_at(np.array([0.0, 0.0, 3.0], np.float32),
                 np.array([0.0, 0.0, -1.0], np.float32),
                 np.array([0.0, 1.0, 0.0], np.float32))
    cam = Camera.from_config(cfg, view_matrix=vm).packed()
    st = init_frame_state(cfg, dev)
    sched = scheduled_tiles(torch.as_tensor(tile_grid(cfg)).to(dev), 0,
                            cfg.tile_count)
    spheres = scene.packed()
    for _ in range(2):
        sphere_pt(cfg, sched, cam, spheres, st.accum, st.output)
    torch.cuda.synchronize()
    shown = st.accum[:, :cfg.height, :cfg.width].double()
    return (float(shown[0].sum() / shown[3].sum()), int(shown[3].sum()),
            float(scene.albedo[1, 0]))


def nee_phases(card, tmp, cfg, scene, tri_cfg, tri_buf):
    """Phases 33-37: next event estimation and MIS through sphere_pt,
    triangle_pt and the wavefront passes, kernel vs plain at max abs 0 from
    the view into the cluster (spheres at whole frames, meshes at 10-tile
    steps with the pole-sliver gate), in threefry and tpu_hw; the analytic
    NEE gate through sphere_pt; the main paths through Application."""
    from l2n_tpu_torch.app.application import Application
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt, sphere_pt_plain
    from l2n_tpu_torch.ops.kernels.wavefront import sphere_wavefront_step
    from l2n_tpu_torch.ops.lights import ExplicitLights
    from l2n_tpu_torch.ops.pathtrace import wavefront_draw_position
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    dev = torch.device("cuda")
    spheres = scene.packed().to(dev)
    swhole = cfg.replace(tiles_per_step=cfg.tile_count)
    view = cluster_view(cfg, spheres)

    # --- 33: sphere_pt, each NEE setting in threefry and tpu_hw ----------
    fused = {}
    for name, kw in NEE_SETTINGS.items():
        for rng in ("threefry", "tpu_hw"):
            _, err, _, lit, _ = kernel_vs_plain(
                sphere_pt, sphere_pt_plain, swhole.replace(rng=rng, **kw),
                spheres, view, 4)
            require(err == 0.0, f"sphere_pt {name} rng={rng} max abs {err}")
            fused[f"{name}/{rng}"] = round(lit, 4)
    lights = ExplicitLights(*light_containers())
    lit_spheres = scene.with_tables(
        albedo=lights.override_albedo(scene.albedo)).packed().to(dev)
    _, err, _, lit, _ = kernel_vs_plain(
        sphere_pt, sphere_pt_plain, swhole.replace(**NEE_SETTINGS["nee+mis"]),
        lit_spheres, view, 4, lights)
    require(err == 0.0, f"sphere_pt nee+mis+lights max abs {err}")
    fused["nee+mis+lights/threefry"] = round(lit, 4)
    phase(33, f"NEE: sphere_pt kernel vs plain from the view into the "
              f"cluster, 4 whole-frame steps per setting (area sampling of "
              f"the 8 emissive spheres, a shadow ray over all 128): accum "
              f"max abs 0, lit {fused}")

    # --- 34: triangle_pt, 4 steps of 10 tiles per setting ----------------
    tri = {}
    for name, kw in NEE_SETTINGS.items():
        for rng in ("threefry", "tpu_hw"):
            tri[f"{name}/{rng}"] = triangle_vs_watched(
                tri_cfg.replace(rng=rng, **kw), tri_buf, view, 4)
    lit_tri = tri_buf.with_tables(
        albedo=lights.override_albedo(tri_buf.albedo.T))
    tri["nee+mis+lights/threefry"] = triangle_vs_watched(
        tri_cfg.replace(**NEE_SETTINGS["nee+mis"]), lit_tri, view, 4,
        lights=lights)
    phase(34, f"NEE: triangle_pt kernel vs plain from the view into the "
              f"cluster, 4 steps of 10 tiles per setting (cone sampling of "
              f"the 8 emissive meshes' bounds, traced through the walk): "
              f"bit-equal but at pixels whose plain sweep kept a hit "
              f"outside its mesh's bound: {tri}")

    # --- 35: the wavefront passes and step -------------------------------
    wave = {}
    s10 = scheduled_tiles(torch.as_tensor(tile_grid(cfg)).to(dev), 0,
                          cfg.effective_tiles_per_step)
    sall = scheduled_tiles(torch.as_tensor(tile_grid(cfg)).to(dev), 0,
                           cfg.tile_count)
    for name in ("nee", "nee+mis", "nee+mis+microfacet+normal_map"):
        for rng in ("threefry", "tpu_hw"):
            wcfg = cfg.replace(wavefront=True, rng=rng, **NEE_SETTINGS[name])
            want = (5, True) if wcfg.material_mode != "procedural" else (
                4, False)
            require(wavefront_draw_position(wcfg) == want,
                    f"pass B resumes at {want} ({name})")
            whole = wcfg.replace(tiles_per_step=wcfg.tile_count)
            na, n = wavefront_passes_vs_plain(whole, sall, view, spheres)
            na10, _ = wavefront_passes_vs_plain(wcfg, s10, view, spheres)
            _, err, _, lit, _ = kernel_vs_plain(
                sphere_wavefront_step, sphere_pt, whole, spheres, view, 4)
            require(err == 0.0, f"wavefront/fused {name} {rng} max abs {err}")
            wave[f"{name}/{rng}"] = {"alive": round(na / n, 4),
                                     "alive_10_tiles": na10,
                                     "lit": round(lit, 4)}
    phase(35, f"NEE: wavefront passes A/B vs plain (one whole frame and 10 "
              f"tiles; 10 ray planes under MIS; pass B resumed at (4, "
              f"False), (5, True) in the material modes) and the wavefront "
              f"CUDA step vs sphere_pt's, 4 whole-frame steps, max abs 0: "
              f"{wave}")

    # --- 36: the analytic NEE gate through sphere_pt ---------------------
    got, samples, kd = nee_estimate(dev, nee=True, max_bounces=1)
    want = kd * 8192.0 / (4.0 * np.pi * 4.0) * (4.0 / 121.0)
    require(samples >= 10 ** 6, f"{samples} samples >= 1e6")
    require(abs(got / want - 1.0) < 0.02,
            f"sphere_pt NEE {got} vs kd Le (r/d)^2 {want} within 2%")
    plain_nee, _, _ = nee_estimate(dev, nee=True, max_bounces=2)
    with_mis, _, _ = nee_estimate(dev, nee=True, mis=True, max_bounces=2)
    require(abs(with_mis / plain_nee - 1.0) < 0.05,
            f"NEE+MIS {with_mis} vs NEE {plain_nee} within 5%")
    phase(36, f"NEE estimator gate through sphere_pt ({samples} samples, "
              f"the light r = 2 at z = 10 over the big sphere's top at z = "
              f"-1, one bounce): {got:.6f} vs kd Le (r/d)^2 = {want:.6f} "
              f"(ratio {got / want:.5f}, gate 2%); two bounces, NEE+MIS "
              f"{with_mis:.6f} vs NEE {plain_nee:.6f} (ratio "
              f"{with_mis / plain_nee:.5f}, gate 5%)")

    # --- 37: the main paths ----------------------------------------------
    paths = {}
    for label, kw, renderer, names in (
            ("nee+mis", {"nee": True, "mis": True}, "spherePT",
             ("sphere_pt",)),
            ("nee+mis, meshes", {"nee": True, "mis": True}, "trianglePT",
             ("triangle_pt",)),
            ("nee+mis, wavefront", {"nee": True, "mis": True,
                                    "wavefront": True}, "spherePT",
             ("wavefront_pass_a", "wavefront_pass_b", "wavefront_pass_c"))):
        app = Application(RenderConfig(**kw), backend="cuda", device="cuda",
                          workdir=tmp, initial_renderer=renderer)
        frames = app.cfg.tile_count * 10 // app.cfg.effective_tiles_per_step
        got_l, lit, _ = run_main_path(app, frames, names)
        paths[label] = (got_l, round(lit, 4))
        del app
    phase(37, f"NEE main paths, {frames} steps each through Application("
              f"RenderConfig(nee=True, mis=True, ...), backend=cuda): "
              f"launches and lit {paths}; card: {card}")
    return {name: n for got_l, _ in paths.values()
            for name, n in got_l.items()}


# ---------------------------------------------------------------------------
# Homogeneous fog (phases 38-40)
# ---------------------------------------------------------------------------

# The fog of tests/test_fog.py's kernel gates (density 0.002, albedo 0.8),
# with the compositions the fog body reads at run time (csrc/pathtrace.cuh
# trace_fog). Phase 38 takes every other sphere or mesh as a light, as
# tests/test_tpu_hw.py's fog gate does, so that the view into the cluster
# stays lit through the fog, whose sky shell no miss reaches.
FOG = {"fog_density": 0.002, "fog_albedo": 0.8}
FOG_SETTINGS = {
    "fog": {},
    "fog+nee": {"nee": True},
    "fog+nee+mis": {"nee": True, "mis": True},
    "fog+nee+mis+microfacet+normal_map": {"nee": True, "mis": True,
                                          "material_mode": "microfacet",
                                          "normal_map": 0.8},
    "fog+lights": {"lights": True},
    # one bounce, the pending last segment; NEE lights the fogged view
    "fog+nee, max_bounces 1": {"max_bounces": 1, "nee": True},
    "fog, ambient_occlusion AOV": {"aov": "ambient_occlusion"}}


def fog_beer_lambert(dev, sigma: float):
    """tests/test_fog.py::TestBeerLambert through sphere_pt: an emissive
    sphere (r = 80, 310 from the camera down -z, a 1 degree field so every
    primary meets its front within 0.01 of t = 230), absorbing fog
    (fog_albedo 0): the mean radiance of 2 whole frames with and without
    fog. Returns (foggy, clear, t_hit, samples)."""
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.maths.linalg import look_at
    from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    from l2n_tpu_torch.scene.spheres import SphereScene
    scene = SphereScene.from_numpy(
        np.array([0.0, 1e5], np.float32), np.zeros(2, np.float32),
        np.array([-300.0, 0.0], np.float32),
        np.array([80.0 ** 2, 1.0], np.float32), device=dev)
    means = []
    for fog in (sigma, 0.0):
        cfg = RenderConfig(env_mode="none", fovy_deg=1.0, max_bounces=2,
                           world_size=1024.0, fog_density=fog,
                           fog_albedo=0.0)
        cfg = cfg.replace(tiles_per_step=cfg.tile_count).validate()
        vm = look_at(np.array([0.0, 0.0, 10.0], np.float32),
                     np.array([0.0, 0.0, -300.0], np.float32),
                     np.array([0.0, 1.0, 0.0], np.float32))
        cam = Camera.from_config(cfg, view_matrix=vm).packed()
        st = init_frame_state(cfg, dev)
        sched = scheduled_tiles(torch.as_tensor(tile_grid(cfg)).to(dev), 0,
                                cfg.tile_count)
        for _ in range(2):
            sphere_pt(cfg, sched, cam, scene.packed(), st.accum, st.output)
        torch.cuda.synchronize()
        shown = st.accum[:, :cfg.height, :cfg.width].double()
        means.append(float(shown[0].sum() / shown[3].sum()))
    return means[0], means[1], 310.0 - 80.0, int(shown[3].sum())


def fog_phases(card, tmp, cfg, scene, tri_cfg, tri_buf, cam):
    """Phases 38-40: homogeneous fog through sphere_pt and triangle_pt,
    kernel vs plain at max abs 0 from the view into the cluster (spheres
    at whole frames, meshes at 10-tile steps with the pole-sliver gate) in
    threefry and tpu_hw, each setting with a lit-coverage gate and a
    collision share of at least 5% of the samples (counted on the plain
    path), fog_density 0 bit-identical to no fog; Beer-Lambert through
    sphere_pt; the main paths through Application. The AO AOV, whose only
    change is its draw budget, is checked from the default camera `cam`
    (the view into the cluster occludes most AO rays). Returns the main
    paths' launches."""
    from l2n_tpu_torch.app.application import Application
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt, sphere_pt_plain
    from l2n_tpu_torch.ops.lights import ExplicitLights
    from l2n_tpu_torch.ops.pathtrace import count_fog_collisions
    dev = torch.device("cuda")
    spheres = scene.packed().to(dev)
    swhole = cfg.replace(tiles_per_step=cfg.tile_count)
    view = cluster_view(cfg, spheres)
    lights = ExplicitLights(*light_containers())
    lit_spheres = scene.with_tables(
        albedo=lights.override_albedo(scene.albedo)).packed().to(dev)
    lit_tri = tri_buf.with_tables(
        albedo=lights.override_albedo(tri_buf.albedo.T))

    def collided(counts, what):
        if not counts["samples"]:  # an AOV draws no collision
            return None
        share = counts["collided"] / counts["samples"]
        require(share >= 0.05, f"{what}: {share} of the samples collided "
                               f">= 0.05")
        return round(share, 4)

    # --- 38: kernel vs plain per setting, threefry and tpu_hw ------------
    fused, tri = {}, {}
    for name, kw in FOG_SETTINGS.items():
        kw = dict(kw, emissive_every=2, **FOG)
        with_lights = kw.pop("lights", False)
        fview = cam if "aov" in kw else view
        for rng in ("threefry", "tpu_hw"):
            with count_fog_collisions() as counts:
                _, err, _, lit, _ = kernel_vs_plain(
                    sphere_pt, sphere_pt_plain, swhole.replace(rng=rng, **kw),
                    lit_spheres if with_lights else spheres, fview, 4,
                    lights if with_lights else None)
            require(err == 0.0, f"sphere_pt {name} rng={rng} max abs {err}")
            fused[f"{name}/{rng}"] = {
                "lit": round(lit, 4),
                "collided": collided(counts, f"sphere_pt {name} {rng}")}
            with count_fog_collisions() as counts:
                got = triangle_vs_watched(
                    tri_cfg.replace(rng=rng, **kw),
                    lit_tri if with_lights else tri_buf, fview, 4,
                    lights=lights if with_lights else None,
                    label=f"{name} {rng}")
            got["collided"] = collided(counts, f"triangle_pt {name} {rng}")
            tri[f"{name}/{rng}"] = got
    # fog_density 0 is no fog, whatever fog_albedo
    off = []
    for kcfg in (swhole, swhole.replace(fog_albedo=0.33)):
        from l2n_tpu_torch.render.state import init_frame_state
        from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
        st = init_frame_state(kcfg, dev)
        sall = scheduled_tiles(torch.as_tensor(tile_grid(kcfg)).to(dev), 0,
                               kcfg.tile_count)
        for _ in range(2):
            sphere_pt(kcfg, sall, view, spheres, st.accum, st.output)
        off.append(st.accum)
    torch.cuda.synchronize()
    require(bits_equal(off[0], off[1]), "fog_density 0 bit-identical")
    phase(38, f"fog (density {FOG['fog_density']}, albedo "
              f"{FOG['fog_albedo']}, every other object a light) kernel vs "
              f"plain from the view into the cluster, threefry and tpu_hw: "
              f"sphere_pt 4 whole-frame steps "
              f"per setting, accum max abs 0, lit and the share of samples "
              f"that collided (plain path, gate >= 0.05) {fused}; "
              f"triangle_pt 4 steps of 10 tiles, bit-equal but at pixels "
              f"whose plain sweep kept a hit outside its mesh's bound: {tri}; "
              f"fog_density 0 (fog_albedo 0.33) bit-equal to no fog")

    # --- 39: Beer-Lambert through sphere_pt ------------------------------
    beer = {}
    for sigma in (0.002, 0.01):
        foggy, clear, t_hit, samples = fog_beer_lambert(dev, sigma)
        want = clear * np.exp(-sigma * t_hit)
        require(samples >= 10 ** 6, f"{samples} samples >= 1e6")
        require(abs(foggy / want - 1.0) < 0.02,
                f"sigma {sigma}: {foggy} vs exp(-sigma t) clear {want} "
                f"within 2%")
        beer[sigma] = {"foggy": round(foggy, 6), "want": round(float(want), 6),
                       "ratio": round(float(foggy / want), 5)}
    phase(39, f"Beer-Lambert through sphere_pt ({samples} samples per "
              f"render; an emissive sphere at t = {t_hit} through absorbing "
              f"fog): mean vs exp(-sigma t) times the clear mean, gate 2%: "
              f"{beer}")

    # --- 40: the main paths ----------------------------------------------
    paths = {}
    main = dict(fog_density=0.0008, fog_albedo=0.8, nee=True, mis=True,
                emissive_every=2)
    for label, renderer, names in (("spheres", "spherePT", ("sphere_pt",)),
                                   ("meshes", "trianglePT",
                                    ("triangle_pt",))):
        app = Application(RenderConfig(**main), backend="cuda",
                          device="cuda", workdir=tmp,
                          initial_renderer=renderer)
        frames = app.cfg.tile_count * 10 // app.cfg.effective_tiles_per_step
        got_l, lit, _ = run_main_path(app, frames, names)
        paths[label] = (got_l, round(lit, 4))
        del app
    phase(40, f"fog main paths, {frames} steps each through Application("
              f"RenderConfig({', '.join(f'{k}={v}' for k, v in main.items())}"
              f"), backend=cuda): launches and lit {paths}; card: {card}")
    return {name: n for got_l, _ in paths.values()
            for name, n in got_l.items()}


# ---------------------------------------------------------------------------
# The program and app layer (phases 41-44)
# ---------------------------------------------------------------------------

def same_state(a, b) -> bool:
    """Bit-equal frame states: planes and counters."""
    return ((a.tile_offset, a.iteration) == (b.tile_offset, b.iteration)
            and bits_equal(a.accum, b.accum)
            and bits_equal(a.output, b.output)
            and (a.rng_state is None) == (b.rng_state is None)
            and (a.rng_state is None or torch.equal(a.rng_state,
                                                    b.rng_state)))


def graph_vs_eager(cfg, scene, cams, names, n: int, tmp):
    """Phase 41's sequence for one config: a steps_per_call=n step against
    n eager single steps from tile_offset 7, call by call, max abs 0 on
    accum, output and the state planes: the first call of camera A (eager),
    its capture and replay, a replay; camera B (eager, then a recapture);
    clear_accumulation (replay); a session saved, one more call, the
    session loaded into both live states (replay from the loaded tile
    offset and planes) and into new buffers (eager, then a recapture).
    Every call's launches must equal ceil(n / G) per kernel of `names`
    for the step's group of G steps a kernel call, replays included.
    Returns the calls compared."""
    import dataclasses as dc

    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.render.state import (
        clear_accumulation,
        init_frame_state,
        load_state,
    )
    from l2n_tpu_torch.render.step import build_render_step
    from l2n_tpu_torch.utils.checkpoint import load_session, save_session
    dev = torch.device("cuda")
    one = build_render_step(cfg, scene, backend="cuda", device=dev)
    many = build_render_step(cfg, scene, backend="cuda", device=dev,
                             steps_per_call=n)
    e = dc.replace(init_frame_state(cfg, dev), tile_offset=7)
    g = dc.replace(init_frame_state(cfg, dev), tile_offset=7)
    calls = 0
    want = -(-n // many.group)

    def call(cam, what):
        nonlocal e, g, calls
        reset_launches()
        g = many(g, cam)
        torch.cuda.synchronize()
        got = dict(launches)
        for _ in range(n):
            e = one(e, cam)
        torch.cuda.synchronize()
        for name in names:
            require(got.get(name, 0) == want,
                    f"{cfg.scene_kind} {what}: {name} launched "
                    f"{got.get(name, 0)} times in one call of {n} steps "
                    f"(want {want})")
        require(same_state(e, g), f"{cfg.scene_kind} rng={cfg.rng} "
                                  f"{what}: graph replay != eager steps")
        calls += 1

    for what in ("eager", "capture", "replay"):
        call(cams[0], what)
    for what in ("new camera, eager", "new camera, capture"):
        call(cams[1], what)
    e, g = clear_accumulation(e), clear_accumulation(g)
    call(cams[1], "after clear_accumulation")
    path = save_session(Path(tmp) / "graph.npz", cfg, g, np.eye(4))
    call(cams[1], "before load_session")
    _, saved, _ = load_session(path, device=dev)
    e, g = load_state(e, saved), load_state(g, saved)
    call(cams[1], "after load_session")
    g = load_session(path, device=dev)[1]  # new buffers: a new key
    e = load_state(e, saved)
    for what in ("new buffers, eager", "new buffers, capture",
                 "new buffers, replay"):
        call(cams[1], what)
    return calls


def program_phases(card, tmp, cfg, scene, tri_cfg, tri_buf, cam):
    """Phases 41-44: steps_per_call as CUDA-graph replay against eager
    single steps (sphere_pt, triangle_pt in three rng modes, the wavefront
    step, fog+nee+mis), the graph-replayed main paths, a session resumed on
    the card, rmse_vs_oracle, debug_mode and the interactive viewer, and
    ms per scheduler step eager against steps_per_call."""
    import contextlib
    import io

    from l2n_tpu_torch.app.application import Application
    from l2n_tpu_torch.app.display import AnsiDisplay
    from l2n_tpu_torch.app.interactive import InteractiveApp
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.render.program import SphereProgram, TriangleProgram
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.step import build_render_step
    from l2n_tpu_torch.scene.spheres import compute_spheres
    from l2n_tpu_torch.utils.validate import debug_mode, rmse_vs_oracle
    dev = torch.device("cuda")
    spheres = scene.packed().to(dev)
    view = cluster_view(cfg, spheres)
    wave = ("wavefront_pass_a", "wavefront_pass_b", "wavefront_pass_c")

    # --- 41: graph replay vs eager single steps ---------------------------
    cases = {}
    for rng in ("threefry", "tpu_hw", "tinymt"):
        cases[f"sphere_pt {rng}"] = (cfg.replace(rng=rng), scene,
                                     (cam, view), ("sphere_pt",))
        cases[f"triangle_pt {rng}"] = (tri_cfg.replace(rng=rng), tri_buf,
                                       (cam, view), ("triangle_pt",))
    cases["wavefront"] = (cfg.replace(wavefront=True), scene, (cam, view),
                          wave)
    cases["sphere_pt fog+nee+mis"] = (
        cfg.replace(emissive_every=2, nee=True, mis=True, **FOG), scene,
        (view, cam), ("sphere_pt",))
    compared = {}
    for label, (ccfg, cscene, cams, names) in cases.items():
        compared[label] = graph_vs_eager(ccfg, cscene, cams, names, 3, tmp)
    paths = {}
    for label, pcfg, cls, names in (
            ("spherePT", cfg, SphereProgram, ("sphere_pt",)),
            ("trianglePT", tri_cfg, TriangleProgram, ("triangle_pt",)),
            ("spherePT/wavefront", cfg.replace(wavefront=True),
             SphereProgram, wave)):
        app = Application(pcfg, backend="cuda", device="cuda", workdir=tmp,
                          renderer_names=(cls.name,))
        n = pcfg.tile_count // pcfg.effective_tiles_per_step
        program = cls(pcfg, scene=tri_buf if cls is TriangleProgram
                      else scene, backend="cuda", steps_per_call=n)
        app.renderer.programs[cls.name] = program
        got_l, lit, _ = run_main_path(app, 10, names)
        paths[label] = (n, got_l, round(lit, 4))
        del app, program
    phase(41, f"steps_per_call as CUDA-graph replay vs eager single steps, "
              f"10-tile steps, 3 per call, from tile_offset 7 (gate: max "
              f"abs 0 on accum, output and state planes, equal counters, "
              f"launches per call = ceil(steps / group), replays counted): "
              f"calls "
              f"compared per case {compared}; graph-replayed main paths "
              f"(10 calls of steps_per_call = one frame through "
              f"Application): (steps per call, launches, lit) {paths}; "
              f"card: {card}")

    # --- 42: a session saved on the card resumes in a fresh Application --
    scfg = cfg.replace(rng="tinymt")
    first = Application(scfg, backend="cuda", device="cuda", workdir=tmp,
                        renderer_names=("spherePT",))
    first.run(30, save_camera=False)
    path = first.save_session(Path(tmp) / "card_session.npz")
    second = Application(scfg, backend="cuda", device="cuda", workdir=tmp,
                         renderer_names=("spherePT",))
    second.renderer.programs["spherePT"] = SphereProgram(
        scfg, scene=scene, backend="cuda", steps_per_call=10)
    second.load_session(path)
    resumed = second.run(3, save_camera=False)
    uninterrupted = first.run(30, save_camera=False)
    torch.cuda.synchronize()
    require(same_state(resumed, uninterrupted),
            "a session resumed on the card (graph-replayed, 3 calls of 10 "
            "steps) != the uninterrupted render")
    phase(42, f"session: Application(RenderConfig(rng=tinymt)) 30 steps, "
              f"saved ({path.stat().st_size} bytes), loaded into a fresh "
              f"Application whose spherePT runs steps_per_call=10 (eager, "
              f"capture, replay), 30 more steps: bit-equal to 60 "
              f"uninterrupted steps (accum, output, rng_state, "
              f"counters); card: {card}")
    del first, second

    # --- 43: rmse_vs_oracle, debug_mode, the interactive viewer ----------
    small = RenderConfig(width=256, height=128, emissive_every=2).validate()
    small_scene = compute_spheres(small.sphere_count, small.world_size,
                                  small.scene_seed)
    oracle = {
        "spherePT": rmse_vs_oracle(small, small_scene, steps=4,
                                   backend="cuda"),
        "spherePT wavefront": rmse_vs_oracle(
            small.replace(wavefront=True), small_scene, steps=4,
            backend="cuda")}
    for label, stats in oracle.items():
        require(stats["max_abs"] == 0.0 and stats["coverage_match"],
                f"rmse_vs_oracle {label}: {stats}")
    reset_launches()
    with debug_mode():
        for dcfg, n in ((cfg, 1), (cfg, 3), (cfg.replace(wavefront=True), 1),
                        (tri_cfg, 1)):
            dscene = tri_buf if dcfg.scene_kind == "triangle" else scene
            dstep = build_render_step(dcfg, dscene, backend="cuda",
                                      device=dev, steps_per_call=n)
            dst = init_frame_state(dcfg, dev)
            for _ in range(2):
                dst = dstep(dst, cam)
    debug_launches = dict(launches)
    require(debug_launches.get("sphere_pt", 0) == 8
            and debug_launches.get("triangle_pt", 0) == 2
            and debug_launches.get("wavefront_pass_b", 0) == 2,
            f"debug_mode launches {debug_launches}")
    script = iter([b"", b"+", b"t", b"", b"x"])
    ansi, status = io.StringIO(), io.StringIO()
    viewer = InteractiveApp(RenderConfig(), workdir=tmp, backend="cuda")
    k0 = viewer.tiles_per_step
    reset_launches()
    with contextlib.redirect_stdout(status):
        frames = viewer.run(AnsiDisplay(stream=ansi),
                            lambda: next(script, b"x"), max_frames=20)
    torch.cuda.synchronize()
    view_launches = dict(launches)
    require(frames == 4 and viewer.tiles_per_step == 2 * k0
            and viewer.renderer.current == "trianglePT"
            and ansi.getvalue().count("\x1b[H\x1b[2J frame") == 5
            and status.getvalue().count("tiles/step") == 5
            and view_launches == {"sphere_pt": 3, "triangle_pt": 2},
            f"interactive viewer: frames {frames}, tiles per step "
            f"{viewer.tiles_per_step}, {viewer.renderer.current}, launches "
            f"{view_launches}")
    phase(43, f"rmse_vs_oracle(backend=cuda) at 256x128, 4 steps (gate "
              f"max abs 0, equal coverage): {oracle}; debug_mode (every "
              f"launch synchronized and checked, every step audited): "
              f"sphere_pt 1 and 3 steps per call, the wavefront step and "
              f"triangle_pt, 2 calls each, clean, launches "
              f"{debug_launches}; InteractiveApp.run on scripted bytes "
              f"['', '+', 't', '', 'x'] into an AnsiDisplay: {frames + 1} "
              f"frames ({len(ansi.getvalue())} bytes of ANSI), tiles per "
              f"step {k0} -> {2 * k0}, spherePT -> trianglePT, launches "
              f"{view_launches}; last status line "
              f"{status.getvalue().splitlines()[-1][:60]!r}; card: {card}")
    del viewer

    # --- 44: ms per scheduler step, eager against steps_per_call ----------
    timing = {}
    for name, fcfg, fscene, kernels in (
            ("sphere_pt", cfg, scene, ("sphere_pt_kernel",)),
            ("triangle_pt", tri_cfg, tri_buf, ("triangle_pt_kernel",)),
            ("wavefront", cfg.replace(wavefront=True), scene,
             tuple(f"{w}_kernel" for w in wave))):
        for label, tcfg in (("10-tile", fcfg), ("whole-frame", fcfg.replace(
                tiles_per_step=fcfg.tile_count))):
            n = 23 if label == "10-tile" else 4
            steps = {1: build_render_step(tcfg, fscene, backend="cuda",
                                          device=dev),
                     n: build_render_step(tcfg, fscene, backend="cuda",
                                          device=dev, steps_per_call=n)}
            st = init_frame_state(tcfg, dev)
            for per in (1, n, n, 1):  # in turns
                step = steps[per]
                # 10 frames timed, 3 calls (or 20 steps) profiled
                calls = 10 * tcfg.tile_count // (
                    tcfg.effective_tiles_per_step * per)
                for _ in range(2):  # warm: eager call, capture
                    st = step(st, cam)
                dev_ms, host_ms, st = timed_steps(step, st, cam, calls)
                _, busy, _, st = profile_steps(step, st, cam,
                                               3 if per > 1 else 20, kernels)
                timing.setdefault((name, label, per), []).append(
                    (dev_ms / per, host_ms / per, busy))
            for per in (1, n):
                runs = timing[(name, label, per)]
                print(f"[timing] {name} {label} steps_per_call={per}: "
                      + " / ".join(f"{d:.4f}" for d, _, _ in runs)
                      + " ms per scheduler step (CUDA events), "
                      + " / ".join(f"{h:.4f}" for _, h, _ in runs)
                      + f" ms (host clock to sync), in turns; card: {card}",
                      flush=True)
                print(f"[busy] {name} {label} steps_per_call={per}: "
                      + " / ".join("not measured" if b is None else
                                   f"{b:.3f}" for _, _, b in runs)
                      + " of the span from first to last device event "
                      f"(torch.profiler); card: {card}", flush=True)
            del steps, st
            torch.cuda.empty_cache()
    phase(44, f"ms per scheduler step, eager vs steps_per_call (23 at 10 "
              f"tiles, 4 at whole frames), in turns: "
              + str({f"{k[0]} {k[1]} x{k[2]}": [round(d, 4) for d, _, _ in v]
                     for k, v in timing.items()})
              + f"; card: {card}")
    return timing


# ---------------------------------------------------------------------------
# Phases 45-47: the multi-card renderer (l2n_tpu_torch/parallel) on the one
# card: a slab with its row offset and stream against its plain version and
# the whole frame's rows (45), ranks spawned over gloo (46) and the stateful
# tile-axis parity leg (47). On one card over gloo a sharded step's time is
# not a multi-card figure: its ranks share the card, and the fold goes
# through the host.
# ---------------------------------------------------------------------------

def headline_config(RenderConfig):
    """bench.py's headline config (`_headline_cfg`): 1024x1024, 128x32
    tiles, whole-frame steps, 4 spp per step, tpu_hw, fast_math."""
    return RenderConfig(width=1024, height=1024, tile_height=32,
                        tile_width=128, tiles_per_step=1024, spp_per_step=4,
                        rng="tpu_hw", fast_math=True).validate()


def sharded_rank(rank, legs):
    """One rank of phase 46's launch: each leg's ShardedRenderer (every
    rank builds each leg's mesh; a rank outside it renders nothing), its
    launches counted from zero over the leg's steps, its ms per step by
    CUDA events and the host clock after the first step, then the fold
    alone (which leaves accum as it is) timed over 10 calls; the gathered
    state comes back from rank 0."""
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.parallel import ShardedRenderer, make_device_mesh
    from l2n_tpu_torch.parallel.mesh import mesh_coordinate
    from l2n_tpu_torch.parallel.step import gather_state
    from l2n_tpu_torch.scene import build_triangle_scene
    from l2n_tpu_torch.scene.spheres import compute_spheres
    out = {}
    for leg in legs:
        mesh = make_device_mesh(*leg["mesh"])
        if mesh_coordinate(mesh) is None:
            out[leg["name"]] = None
            continue
        cfg = RenderConfig.from_json(leg["cfg"])
        scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                cfg.scene_seed)
        if cfg.scene_kind == "triangle":
            scene = build_triangle_scene(scene, cfg.disc_lat, cfg.disc_long)
        r = ShardedRenderer(cfg, scene, mesh)
        cam = Camera.from_config(cfg).packed()
        torch.cuda.synchronize()
        reset_launches()
        r.step(cam)
        ms = host_ms = None
        if leg["steps"] > 1:
            ms, host_ms, _ = timed_steps(lambda st, c: r.step(c), r.state,
                                         cam, leg["steps"] - 1)
        torch.cuda.synchronize()
        res = {"coord": mesh_coordinate(mesh), "launches": dict(launches),
               "ms": ms, "host_ms": host_ms}
        res["state"] = gather_state(mesh, r.state)
        sched = r.step_fn.body.schedule(r.state.tile_offset)
        fold = lambda: r.step_fn.fold(r.state, sched)  # noqa: E731
        res["fold_ms"], res["fold_host_ms"], _ = timed_steps(
            lambda st, c: fold(), None, None, 10)
        out[leg["name"]] = res
        del r
        torch.cuda.empty_cache()
    return out


def parallel_phases(card, cfg, scene, tri_cfg, tri_buf, cam):
    """Phases 45-47 (see above); returns each kernel's launches on the
    sharded paths, per leg and rank."""
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.camera.camera import slab_camera
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt, sphere_pt_plain
    from l2n_tpu_torch.ops.kernels.triangle_pt import (
        triangle_pt,
        triangle_pt_plain,
    )
    from l2n_tpu_torch.parallel.launch import launch
    from l2n_tpu_torch.parallel.step import SlabStep, init_slab_state
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.step import build_render_step
    from l2n_tpu_torch.render.tiles import tile_grid
    dev = torch.device("cuda")
    spheres = scene.packed().to(dev)

    # --- 45: one slab (tile rows 10-14: row offset 320, stream 3) --------
    slab_gates = {}
    for name, fcfg, buf, kernel, plain in (
            ("sphere_pt", cfg, spheres, sphere_pt, sphere_pt_plain),
            ("triangle_pt", tri_cfg, tri_buf, triangle_pt,
             triangle_pt_plain)):
        scfg = fcfg.replace(height=160, ndc_height=fcfg.height)
        sched = torch.as_tensor(tile_grid(scfg)).to(dev)
        whole = fcfg.replace(tiles_per_step=fcfg.tile_count)
        frame = init_frame_state(whole, dev)
        fsched = torch.as_tensor(tile_grid(whole)).to(dev)
        runs = {}
        for label, fn, extras in (("kernel", kernel, (320, 3)),
                                  ("plain", plain, (320, 3)),
                                  ("stream 0", kernel, (320, 0))):
            st = init_frame_state(scfg, dev)
            for _ in range(2):
                fn(scfg, sched, slab_camera(cam, *extras), buf, st.accum,
                   st.output)
            runs[label] = st
        for _ in range(2):
            kernel(whole, fsched, cam, buf, frame.accum, frame.output)
        torch.cuda.synchronize()
        err = (runs["kernel"].accum - runs["plain"].accum).abs().max().item()
        out_err = (runs["kernel"].output
                   - runs["plain"].output).abs().max().item()
        rows = frame.accum[:, 320:480]
        lit = (runs["kernel"].accum[:3].amax(0) > 0).float().mean().item()
        moved = ((runs["kernel"].accum[:3] - rows[:3]).abs().amax(0)
                 > 0).float().mean().item()
        require(err == 0.0 and lit > 0.02,
                f"{name} slab kernel vs plain: max abs {err}, lit {lit}")
        require(bits_equal(runs["stream 0"].accum, rows),
                f"{name}: the slab at stream 0 != the frame's rows 320-480")
        require(moved > 0.05, f"{name}: stream 3 changes {moved} of the "
                "slab's pixels")
        slab_gates[name] = {"max_abs": err, "output_max_abs": out_err,
                            "lit": round(lit, 4),
                            "stream_moves": round(moved, 4)}
    phase(45, f"a slab of the default configs (rows 320-480 of 720, row "
              f"offset 320, stream 3; 2 steps of its 50 tiles), kernel vs "
              f"plain (gate max abs 0, lit > 0.02; the slab at stream 0 "
              f"bit-equal to rows 320-480 of 2 whole-frame steps; stream 3 "
              f"moves > 5% of the pixels): {slab_gates}; card: {card}")

    # --- 46/47: ranks spawned on the one card over gloo --------------------
    head = headline_config(RenderConfig)
    legs = [
        {"name": "sphere 1x2", "cfg": cfg.to_json(), "mesh": (1, 2),
         "steps": 23, "kernel": "sphere_pt"},
        {"name": "triangle 1x2", "cfg": tri_cfg.to_json(), "mesh": (1, 2),
         "steps": 23, "kernel": "triangle_pt"},
        {"name": "headline 2x2", "cfg": head.to_json(), "mesh": (2, 2),
         "steps": 2, "kernel": "sphere_pt"},
        {"name": "headline tinymt 4x1",
         "cfg": head.replace(rng="tinymt").to_json(), "mesh": (4, 1),
         "steps": 1, "kernel": "sphere_pt"}]
    t0 = time.perf_counter()
    ranks = launch(sharded_rank, 4, "gloo", args=(legs,), timeout=600.0)
    launch_s = time.perf_counter() - t0
    results, sharded_launches = {}, collections.defaultdict(dict)
    for leg in legs:
        name, (n_tile, n_sample) = leg["name"], leg["mesh"]
        lcfg = RenderConfig.from_json(leg["cfg"])
        got = ranks[0][name]["state"]
        per_rank = [r[name]["launches"].get(leg["kernel"], 0)
                    for r in ranks if r[name] is not None]
        sharded_launches[leg["kernel"]][name] = per_rank
        require(per_rank == [leg["steps"]] * (n_tile * n_sample),
                f"{name}: launches per rank {per_rank}, steps "
                f"{leg['steps']}")
        lscene = tri_buf if lcfg.scene_kind == "triangle" else scene
        lcam = Camera.from_config(lcfg).packed()
        h = lcfg.padded_height // n_tile
        acc = got["sharded_accum"]
        for t in range(n_tile):
            for s_ in range(n_sample):
                body = SlabStep(lcfg, lscene, n_tile, t, s_, device=dev)
                st = init_slab_state(lcfg, n_tile, t, dev)
                for _ in range(leg["steps"]):
                    st = body(st, lcam)
                require(np.array_equal(acc[s_, :, t * h:(t + 1) * h],
                                       st.accum.cpu().numpy()),
                        f"{name}: gathered slab ({t}, {s_}) != its kernel "
                        "render in this process")
        folded = acc.sum(0)
        touched = folded[3] > 0
        want = np.power(np.maximum(folded[:3], 0.0)
                        / np.maximum(folded[3:4], np.float32(1e-20)),
                        np.float32(lcfg.gamma))[:, touched]
        out_rel = float(np.max(np.abs(got["output"][:, touched] - want)
                               / np.maximum(np.abs(want), 1e-30)))
        require(out_rel <= 1e-6, f"{name}: the fold's display, relative "
                f"error {out_rel}")
        lit = float((folded[:3].max(0)[touched] > 0).mean())
        require(lit > 0.02, f"{name}: lit {lit}")
        results[name] = {"launches": per_rank, "lit": round(lit, 4),
                         "display_rel_err": out_rel,
                         "offset": int(got["tile_offset"])}
    # phase 47: one single-card whole-frame kernel step of the tinymt leg
    tcfg = head.replace(rng="tinymt")
    tstep = build_render_step(tcfg, scene, backend="cuda", device=dev)
    tst = tstep(init_frame_state(tcfg, dev), Camera.from_config(tcfg).packed())
    torch.cuda.synchronize()
    got = ranks[0]["headline tinymt 4x1"]["state"]
    tlit = (tst.accum[:3].amax(0) > 0).float().mean().item()
    require(np.array_equal(got["sharded_accum"][0], tst.accum.cpu().numpy())
            and np.array_equal(got["rng_state"],
                               tst.rng_state.cpu().numpy().view(np.uint32))
            and tlit > 0.02,
            f"tinymt (4, 1) != one single-card whole-frame step (lit {tlit})")
    # the single-card eager step beside each leg (CUDA events, host clock)
    single = {}
    for leg in legs[:3]:
        lcfg = RenderConfig.from_json(leg["cfg"])
        lscene = tri_buf if lcfg.scene_kind == "triangle" else scene
        lstep = build_render_step(lcfg, lscene, backend="cuda", device=dev)
        lcam = Camera.from_config(lcfg).packed()
        lst = lstep(init_frame_state(lcfg, dev), lcam)
        d_ms, h_ms, lst = timed_steps(lstep, lst, lcam, 10)
        single[leg["name"]] = (d_ms, h_ms)
        del lst, lstep
    for leg in legs[:3]:
        name = leg["name"]
        r0 = ranks[0][name]
        print(f"[sharded] {name} ({leg['steps']} steps, ranks on ONE card "
              f"over gloo: not a multi-card figure): rank 0 "
              f"{r0['ms']:.4f} ms per step (CUDA events), "
              f"{r0['host_ms']:.4f} ms (host clock to sync), the fold "
              f"{r0['fold_ms']:.4f} ms ({r0['fold_host_ms']:.4f} host); "
              f"ranks' ms per step "
              f"{[round(r[name]['ms'], 4) for r in ranks if r[name]]}; "
              f"the single-card eager step {single[name][0]:.4f} ms "
              f"({single[name][1]:.4f} host); card: {card}", flush=True)
    if torch.cuda.device_count() >= 2:
        nccl = launch(sharded_rank, 2, "nccl", args=(legs[:1],))
        require(np.array_equal(nccl[0]["sphere 1x2"]["state"][
            "sharded_accum"], ranks[0]["sphere 1x2"]["state"][
            "sharded_accum"]), "nccl (1, 2) != gloo (1, 2)")
        print(f"nccl: (1, 2) sphere leg on {torch.cuda.device_count()} "
              f"cards bit-equal to gloo's, rank 0 "
              f"{nccl[0]['sphere 1x2']['ms']:.4f} ms per step", flush=True)
    else:
        print("nccl: not run (1 card)", flush=True)
    phase(46, f"ranks spawned on the one card over gloo (4 ranks, "
              f"{launch_s:.1f} s for the launch and every leg): gathered "
              f"sharded_accum bit-equal to each slab's kernel render in "
              f"this process (sphere and triangle defaults on (1, 2), 23 "
              f"steps; the headline on (2, 2), 2 whole-frame steps of 256 "
              f"tiles over slabs of 128: each tile once), the display the "
              f"fold's pow form (rel err <= 1e-6), launches = steps on "
              f"every rank: {results}; card: {card}")
    phase(47, f"tinymt headline on (4, 1), 1 step: accum and rng_state "
              f"bit-equal to one single-card whole-frame kernel step, lit "
              f"{tlit:.4f}; card: {card}")
    return dict(sharded_launches)


# The compile-time settings of each step kernel's instantiations, in their
# template order (csrc/pathtrace.cuh with_options, dispatch_pass_a/_b); the
# fused kernels' body (kBody*) comes first, an int.
KERNEL_FLAGS = {"sphere_pt": ("fast_math", "viewproj"),
                "triangle_pt": ("fast_math", "viewproj"),
                "wavefront_pass_a": ("fast_math", "viewproj"),
                "wavefront_pass_b": ("fast_math",)}
BODIES = ("lambert", "aovs", "materials", "nee", "fog")


# Phase 48's settings of the knot behind a light, each with its lit gate:
# the materials, NEE and fog bodies and the ambient-occlusion AOV. Without
# NEE a path meets light only through a bounce that survives roulette and
# reaches the small light or (here) the sun sky: its gate is lower.
LIT_KNOT_SETTINGS = {
    "microfacet+bump, sun": ({"material_mode": "microfacet",
                              "normal_map": 0.8, "env_mode": "sun"}, 0.02),
    "nee+mis+microfacet": ({"nee": True, "mis": True,
                            "material_mode": "microfacet"}, 0.1),
    "fog+nee+mis": ({"fog_density": 0.0008, "fog_albedo": 0.8, "nee": True,
                     "mis": True}, 0.1),
    "ambient_occlusion": ({"aov": "ambient_occlusion"}, 0.1)}


def triangle_scene_bytes(buf, c) -> int:
    """Bytes of the packed triangle scene that triangle_pt's Lambert body
    must read for the counters `c` of count_work(tri_buffers=buf): the
    bound, slab-group and certain-hit arrays and the albedo once, the 16
    slots of each sub-cluster that holds a winning triangle, and each
    winner's attribute row; not the material table, which that body does
    not read."""
    from l2n_tpu_torch.ops.kernels.triangle_pack import SUBSIZE
    small = sum(a.numel() * 4 for a in (
        buf.mesh_bounds, buf.slab_count, buf.slab_bounds, buf.sub_bounds,
        buf.group_bounds, buf.inner_gap, buf.balls, buf.albedo))
    return (small + c["hit_subs"] * SUBSIZE * buf.tris.shape[1] * 4
            + c["hit_tris"] * buf.attrs.shape[1] * 4)


def trefoil_phase(card, dev) -> dict:
    """Phase 48: the JAX bench's `bigobj` stage on the card
    (probes/step_ab.py bigobj_case: the 70,144-triangle trefoil knot, one
    mesh of 548 slabs, which walks the slab-group level, with its interior
    balls and inscribed sphere as seeds). triangle_pt against its plain
    version at 10 tiles from the frame's middle for 2 steps, in tpu_hw and
    threefry (accum and output bit-equal, lit coverage of the rendered
    pixels > 0.1), and the same for the knot behind a light
    (step_ab.lit_knot) in LIT_KNOT_SETTINGS; the kernel's device time per
    call (CUDA events) at 10 tiles and whole frames, the plain version's
    at 10 tiles, and the bound (triangle_bound) of each from the plain
    path's counts, with the certain-hit seeds and fallbacks. Returns the
    triangle_pt row's trefoil_* keys."""
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.ops.kernels.triangle_pt import (
        TriangleBuffers,
        triangle_pt,
        triangle_pt_plain,
    )
    from l2n_tpu_torch.ops.scenes import triangle_anyhit, triangle_intersector
    from l2n_tpu_torch.probes.step_ab import bigobj_case, lit_knot
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    t0 = time.perf_counter()
    cfg, scene, cam = bigobj_case()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    buf = TriangleBuffers.from_scene(scene, dev)
    pack_s = time.perf_counter() - t0
    slabs = int(buf.slab_count[0])
    groups = int((buf.group_bounds[0, :, 3] > 0).sum())
    balls = int((buf.balls[0, :, 3] > 0).sum())
    r2, gap = float(buf.mesh_bounds[0, 3]), float(buf.inner_gap[0])
    require(not buf.shelled, "the trefoil walks its slabs")
    require(scene.mesh_count == 1 and scene.total_triangles == 70144
            and slabs == 548 and groups == 69,
            f"trefoil: 1 mesh of 70,144 triangles in 548 slabs and 69 "
            f"groups ({scene.mesh_count}, {scene.total_triangles}, {slabs}, "
            f"{groups})")
    tiles = torch.as_tensor(tile_grid(cfg)).to(dev)
    k, first = 10, cfg.tile_count // 2 - 5
    cfg10 = cfg.replace(tiles_per_step=k)

    def hold(name, rcfg, b, min_lit=0.1):
        """triangle_pt vs plain over buffers b, 2 steps of 10 tiles from
        `first`: (max abs, lit coverage of the rendered pixels)."""
        ka, pa = init_frame_state(rcfg, dev), init_frame_state(rcfg, dev)
        for i in range(2):
            sched = scheduled_tiles(tiles, first + i * k, k)
            triangle_pt(rcfg, sched, cam, b, ka.accum, ka.output)
            triangle_pt_plain(rcfg, sched, cam, b, pa.accum, pa.output)
        torch.cuda.synchronize()
        kacc, pacc = ka.accum.cpu().numpy(), pa.accum.cpu().numpy()
        require(np.array_equal(kacc[3], pacc[3]),
                f"trefoil {name}: kernel/plain accum[3] equal")
        err = float(np.abs(kacc - pacc).max())
        require(err == 0.0, f"trefoil {name}: kernel/plain max abs {err}")
        require(bits_equal(ka.output, pa.output),
                f"trefoil {name}: kernel/plain output bit-equal")
        rendered = pacc[3] > 0
        require(int(rendered.sum()) == 2 * k * cfg.tile_height
                * cfg.tile_width, f"trefoil {name}: 20 tiles rendered once")
        lit = float((pacc[:3].max(0) > 0)[rendered].mean())
        require(lit > min_lit,
                f"trefoil {name}: lit coverage {lit} > {min_lit}")
        return err, lit

    reset_launches()
    gates = {rng: hold(rng, cfg10.replace(rng=rng), buf)
             for rng in ("tpu_hw", "threefry")}
    require(launches["triangle_pt"] == 4, "trefoil: 4 triangle_pt launches")
    # The knot as mesh 1 behind an emissive sphere (step_ab.lit_knot): the
    # bounces, the last segments' any-hit, NEE's shadow rays and the AO
    # cast walk its groups, in the materials, NEE and fog bodies' walk out
    # of line and the AOV body's `occluded`.
    t0 = time.perf_counter()
    lit_buf = TriangleBuffers.from_scene(lit_knot(scene), dev)
    lit_pack_s = time.perf_counter() - t0
    lit_gates = {name: hold(name, cfg10.replace(**over).validate(), lit_buf,
                            min_lit)
                 for name, (over, min_lit) in LIT_KNOT_SETTINGS.items()}
    trefoil_launches = launches["triangle_pt"]
    require(trefoil_launches == 4 + 2 * len(LIT_KNOT_SETTINGS),
            f"trefoil: {4 + 2 * len(LIT_KNOT_SETTINGS)} triangle_pt launches")
    lit_intersect = triangle_intersector(lit_buf.soup)
    lw = count_work(cfg10, scheduled_tiles(tiles, first, k), cam,
                    init_frame_state(cfg10, dev).accum,
                    (lit_intersect, triangle_anyhit(lit_intersect),
                     lit_buf.albedo.T),
                    mesh_bounds=lit_buf.mesh_bounds, tri_buffers=lit_buf)
    ms, bounds, seeds = {}, {}, {}
    intersect = triangle_intersector(buf.soup)
    closures = (intersect, triangle_anyhit(intersect), buf.albedo.T)
    for label, lcfg, sched in (
            ("10-tile", cfg10, scheduled_tiles(tiles, first, k)),
            ("whole-frame", cfg, scheduled_tiles(tiles, 0,
                                                 cfg.tile_count))):
        st = init_frame_state(lcfg, dev)
        ms[label] = timed_calls(lambda: triangle_pt(
            lcfg, sched, cam, buf, st.accum, st.output), 2,
            20 if label == "10-tile" else 5)
        w = count_work(lcfg, sched, cam, init_frame_state(lcfg, dev).accum,
                       closures, cull_bounds=buf.mesh_bounds.T.contiguous(),
                       mesh_bounds=buf.mesh_bounds, tri_buffers=buf)
        bounds[label] = triangle_bound(w, 1, sched.shape[0],
                                       triangle_scene_bytes(buf, w))
        seeds[label] = seed_share(w)
    st = init_frame_state(cfg10, dev)
    sched = scheduled_tiles(tiles, first, k)
    plain_ms = timed_calls(lambda: triangle_pt_plain(
        cfg10, sched, cam, buf, st.accum, st.output), 0, 1)
    phase(48, f"the trefoil (bench.py bigobj: load_obj(trefoil_obj()) "
              f"{load_s:.1f} s, packed in {pack_s:.1f} s: 70,144 triangles "
              f"in {slabs} slabs, {groups} groups of 8, {balls} live "
              f"interior balls, inner_gap {gap:.7g} of r_out^2 {r2:.7g}: "
              f"inscribed sphere r_in/r_out "
              f"{np.sqrt(max(r2 - gap, 0.0) / r2):.3e}), {cfg.width}x"
              f"{cfg.height} in {cfg.tile_height}x{cfg.tile_width} tiles, "
              f"aimed camera: triangle_pt vs plain, 2 steps of 10 tiles "
              f"from tile {first}, (max abs, lit) {gates} (gates: 0, accum "
              f"and output bit-equal, lit > 0.1), launches "
              f"{trefoil_launches}; kernel {ms['10-tile']:.4f} ms per call at "
              f"10 tiles, {ms['whole-frame']:.4f} ms per whole frame (CUDA "
              f"events), plain {plain_ms:.1f} ms at 10 tiles; bound (ms, by) "
              f"{bounds}; certain-hit seeds (plain counter) {seeds}; behind "
              f"a light (lit_knot, packed in {lit_pack_s:.1f} s: the knot "
              f"is mesh 1): kernel vs plain, the same 20 tiles, (max abs, "
              f"lit) {lit_gates} (gates: 0, bit-equal, lit > 0.1; 0.02 "
              f"without NEE); its "
              f"Lambert step's other casts (plain counter): {lw['b_casts']} "
              f"nearest, {lw['b_anyhit']} any-hit, {lw['b_mesh_entries']} "
              f"mesh-bound entries, {seed_share(lw)}; card: {card}")
    return {"trefoil_launches": trefoil_launches,
            "trefoil_max_abs_err": max(e for e, _ in [*gates.values(),
                                                      *lit_gates.values()]),
            "trefoil_pack_s": pack_s,
            "trefoil_10_tile_ms": ms["10-tile"],
            "trefoil_whole_frame_ms": ms["whole-frame"],
            "trefoil_10_tile_plain_ms": plain_ms,
            "trefoil_10_tile_bound_ms": bounds["10-tile"][0],
            "trefoil_10_tile_bound_by": bounds["10-tile"][1],
            "trefoil_whole_frame_bound_ms": bounds["whole-frame"][0],
            "trefoil_whole_frame_bound_by": bounds["whole-frame"][1]}


def shell_phase(card, dev, tri_cfg, tri_buf, cam) -> dict:
    """Phase 49 ([shell]): the shell visits of the default triangle scene
    (csrc/shellwalk.cuh, ops/kernels/shellwalk.py). The plain shell cast
    (shell_nearest, the JAX package's top-4 shells over the stored rows)
    over one whole-frame plain step's bounce and any-hit casts: its counts
    (resolved, pending, tries, wide and unsettled tries: the meshes the
    kernel walks by their slabs, K exhausted), and its resolved lanes
    against the brute-force hits of the same casts (gate: none differs).
    triangle_pt against its plain version, 23 steps of 10 tiles and one
    whole-frame step, in threefry and tpu_hw (gates: accum and output
    bit-equal, lit > 0.02). The kernel's device time per call (CUDA
    events, the best of 3 rounds) with the shell visits and with the slab
    walk alone (the shell buffer's head zeroed), in turns: shell, slabs,
    slabs, shell. Returns the triangle_pt row's shell_* keys."""
    from l2n_tpu_torch.ops.kernels import shellwalk as sw
    from l2n_tpu_torch.ops.kernels.common import (
        launches,
        render_tiles_plain,
        reset_launches,
    )
    from l2n_tpu_torch.ops.kernels.triangle_pt import (
        triangle_pt,
        triangle_pt_plain,
    )
    from l2n_tpu_torch.ops.scenes import (
        TRIANGLE_MISS_COLOR,
        triangle_anyhit,
        triangle_intersector,
    )
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    require(tri_buf.shelled, "the default triangle scene takes the shell")
    whole = tri_cfg.replace(tiles_per_step=tri_cfg.tile_count)
    tiles = torch.as_tensor(tile_grid(tri_cfg)).to(dev)
    intersect = triangle_intersector(tri_buf.soup)
    any_hit = triangle_anyhit(intersect)
    stats, bad = collections.Counter(), collections.Counter()

    def live_rays(ox, oy, oz, dx, dy, dz):
        live = torch.broadcast_to(ox, dx.shape) < 1e30
        return live, [torch.broadcast_to(a, dx.shape)[live]
                      for a in (ox, oy, oz, dx, dy, dz)]

    def nearest(ox, oy, oz, dx, dy, dz):
        h = intersect(ox, oy, oz, dx, dy, dz)
        if ox.dim() == 0:  # primaries keep the cone-culled walk
            return h
        live, r = live_rays(ox, oy, oz, dx, dy, dz)
        t, m, pend = sw.shell_nearest(tri_buf.shell, tri_buf.shell_tris, *r,
                                      stats=stats)
        bt = h.t[live]
        bm = torch.where(bt >= 0.0, h.index[live], -1)
        bad["nearest"] += int((~pend & ((t != bt) | (m != bm))).sum())
        return h

    def anyhit(ox, oy, oz, dx, dy, dz):
        hit = any_hit(ox, oy, oz, dx, dy, dz)
        live, r = live_rays(ox, oy, oz, dx, dy, dz)
        t, _, pend = sw.shell_nearest(tri_buf.shell, tri_buf.shell_tris, *r,
                                      stats=stats)
        bad["anyhit"] += int((~pend & ((t >= 0.0) != hit[live])).sum())
        return hit

    st = init_frame_state(whole, dev)
    render_tiles_plain(whole, scheduled_tiles(tiles, 0, whole.tile_count),
                       cam, nearest, anyhit, tri_buf.table(), st.accum,
                       st.output, None, TRIANGLE_MISS_COLOR)
    require(sum(bad.values()) == 0,
            f"shell_nearest's resolved lanes are the brute-force hits {bad}")
    require(stats["resolved"] > 0.9 * stats["rays"],
            f"most casts resolve {dict(stats)}")

    def hold(rcfg, steps):
        """triangle_pt vs plain from fresh states: (max abs, lit)."""
        k = rcfg.effective_tiles_per_step
        ka, pa = init_frame_state(rcfg, dev), init_frame_state(rcfg, dev)
        for i in range(steps):
            sched = scheduled_tiles(tiles, i * k % rcfg.tile_count, k)
            triangle_pt(rcfg, sched, cam, tri_buf, ka.accum, ka.output)
            triangle_pt_plain(rcfg, sched, cam, tri_buf, pa.accum, pa.output)
        torch.cuda.synchronize()
        err = float((ka.accum - pa.accum).abs().max())
        require(err == 0.0 and bits_equal(ka.output, pa.output),
                f"shell: triangle_pt {rcfg.rng} {k} tiles kernel/plain max "
                f"abs {err}, output bit-equal")
        lit = float((pa.accum[:3, :rcfg.height, :rcfg.width].amax(0) > 0)
                    .float().mean())
        require(lit > 0.02, f"shell: lit {lit} > 0.02")
        return err, round(lit, 4)

    reset_launches()
    gates = {(rng, label): hold(rcfg.replace(rng=rng), steps)
             for rng in ("threefry", "tpu_hw")
             for label, rcfg, steps in (
                 ("10-tile", tri_cfg.replace(tiles_per_step=10), 23),
                 ("whole-frame", whole, 1))}
    held = launches["triangle_pt"]
    require(held == 48, f"shell: 48 triangle_pt launches ({held})")
    slabs = dataclasses.replace(tri_buf,
                                shell=torch.zeros_like(tri_buf.shell))
    ms = collections.defaultdict(list)
    for rng in ("threefry", "tpu_hw"):
        for label, rcfg, n in (("10-tile", tri_cfg.replace(
                tiles_per_step=10), 50), ("whole-frame", whole, 10)):
            rcfg = rcfg.replace(rng=rng)
            sched = scheduled_tiles(tiles, 0, rcfg.effective_tiles_per_step)
            sts = init_frame_state(rcfg, dev)
            for walk in ("shell", "slabs", "slabs", "shell"):
                b = tri_buf if walk == "shell" else slabs
                ms[(rng, label, walk)].append(min(timed_calls(
                    lambda: triangle_pt(rcfg, sched, cam, b, sts.accum,
                                        sts.output), 2, n)
                    for _ in range(3)))
    times = {f"{rng} {label} {walk}": [round(x, 4) for x in v]
             for (rng, label, walk), v in ms.items()}
    tries = max(stats["tries"], 1)
    phase(49, f"[shell] the default triangle scene's shell visits "
              f"(disc_lat {int(tri_buf.shell[0])}, disc_long "
              f"{int(tri_buf.shell[1])}): the plain shell cast over one "
              f"whole-frame plain step's bounce and any-hit casts "
              f"{dict(stats)}: resolved {stats['resolved'] / max(stats['rays'], 1):.4f} "
              f"of the casts, per try wide {stats['wide'] / tries:.4f} and "
              f"unsettled {stats['unsettled'] / tries:.4f} (the meshes the "
              f"kernel walks by their slabs), K exhausted "
              f"{stats['pending_k']}; resolved lanes vs the brute-force "
              f"hits: {dict(bad)} differ (gate 0); triangle_pt vs plain "
              f"(max abs, lit) {gates} (gates: 0, accum and output "
              f"bit-equal, lit > 0.02), launches {held}; kernel ms per call "
              f"(CUDA events, best of 3) in turns shell, slabs, slabs, "
              f"shell: {times}; card: {card}")
    return {"shell_launches": held,
            "shell_max_abs_err": max(e for e, _ in gates.values()),
            "shell_resolved": stats["resolved"] / max(stats["rays"], 1),
            "shell_slab_tries": (stats["wide"] + stats["unsettled"]) / tries,
            **{f"shell_{rng}_{label.replace('-', '_')}_ms": min(
                ms[(rng, label, "shell")]) for rng in ("threefry", "tpu_hw")
                for label in ("10-tile", "whole-frame")},
            **{f"slabs_{rng}_{label.replace('-', '_')}_ms": min(
                ms[(rng, label, "slabs")]) for rng in ("threefry", "tpu_hw")
                for label in ("10-tile", "whole-frame")}}


def fused_steps_phase(card, dev) -> dict:
    """Phase 50: a call's steps rendered in groups, one kernel call per G
    steps (render/step.py MultiStep), against one launch per step at the
    `tri32k.rows` schedule of portbench: 1024x1024 in 32x128 tiles, 8 tiles
    at 1 spp a step, 32 steps a call, so G = 32 and a call is one launch
    of the whole frame. sphere_pt on the headline's 128 spheres and
    triangle_pt on them tessellated 16x8 (32,768 triangles), in tpu_hw,
    threefry and tinymt, 3 calls from tile offset 7 (eager, capture and
    replay, replay): the grouped step against the same step under
    debug_mode (G = 1, every launch synchronized) and against a graph of
    one launch per step (MultiStep with fuse=False); gate max abs 0 on
    accum, output and the state planes. Then ms per call of the two
    graphs, CUDA events over 20 replays, in turns."""
    import dataclasses as dc

    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.ops.kernels.common import launches, reset_launches
    from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.step import MultiStep, build_render_step
    from l2n_tpu_torch.scene import build_triangle_scene
    from l2n_tpu_torch.scene.spheres import compute_spheres
    from l2n_tpu_torch.utils.validate import debug_mode
    base = headline_config(RenderConfig).replace(tiles_per_step=8,
                                                 spp_per_step=1)
    spheres = compute_spheres(base.sphere_count, base.world_size,
                              base.scene_seed)
    tri_buf = TriangleBuffers.from_scene(
        build_triangle_scene(spheres, 16, 8), dev)
    n = base.tile_count // base.effective_tiles_per_step
    gaps, held, ms = {}, {}, {}
    for family, kernel in (("sphere", "sphere_pt"),
                           ("triangle", "triangle_pt")):
        fcfg = base if family == "sphere" else base.replace(
            scene_kind="triangle", fast_math=False, disc_lat=16, disc_long=8)
        scene = spheres if family == "sphere" else tri_buf
        for rng in ("tpu_hw", "threefry", "tinymt"):
            cfg = fcfg.replace(rng=rng).validate()
            cam = Camera.from_config(cfg).packed()
            grouped = build_render_step(cfg, scene, backend="cuda",
                                        device=dev, steps_per_call=n)
            single = MultiStep(cfg, grouped.render, grouped.tiles, n, dev,
                               graphs=True, fuse=False)
            require(grouped.group == n and single.group == 1,
                    f"groups {grouped.group}, {single.group}")
            states = [dc.replace(init_frame_state(cfg, dev), tile_offset=7)
                      for _ in range(3)]
            reset_launches()
            for _ in range(3):
                states[0] = grouped(states[0], cam)
            torch.cuda.synchronize()
            held[f"{kernel} {rng}"] = launches[kernel]
            require(launches[kernel] == 3, f"{kernel} {rng}: "
                    f"{launches[kernel]} launches in 3 grouped calls")
            with debug_mode():
                for _ in range(3):
                    states[1] = grouped(states[1], cam)
            for _ in range(3):
                states[2] = single(states[2], cam)
            torch.cuda.synchronize()
            g = states[0]
            for other, what in ((states[1], "debug_mode"),
                                (states[2], "fuse=False")):
                gap = max(float((a - b).abs().max()) for a, b in (
                    (g.accum, other.accum), (g.output, other.output)))
                if g.rng_state is not None:
                    gap = max(gap, float((g.rng_state.long()
                                          - other.rng_state.long())
                                         .abs().max()))
                gaps[f"{kernel} {rng} vs {what}"] = gap
                require(same_state(g, other),
                        f"{kernel} rng={rng}: grouped call != one launch "
                        f"per step ({what}), max abs {gap}")
            require(float(g.accum[3].sum()) == 3 * cfg.padded_height
                    * cfg.padded_width, f"{kernel} {rng}: sample count")
            if rng == "tinymt":
                continue
            st = states[0]
            for label, step in (("grouped", grouped), ("per-step", single),
                                ("per-step", single), ("grouped", grouped)):
                ms.setdefault(f"{kernel} {rng} {label}", []).append(
                    timed_calls(lambda: step(st, cam), 2, 20))
            del grouped, single, states, st
            torch.cuda.empty_cache()
    times = {k: [round(x, 4) for x in v] for k, v in ms.items()}
    phase(50, f"grouped steps at tri32k.rows's schedule (1024x1024, 32x128 "
              f"tiles, 8 tiles at 1 spp a step, {n} steps a call, one "
              f"launch a call): grouped vs debug_mode and vs a graph of one "
              f"launch a step, 3 calls from tile offset 7, max abs (gate 0 "
              f"on accum, output, state planes) {gaps}; launches in 3 "
              f"grouped calls {held}; ms per call (CUDA events, 20 graph "
              f"replays, in turns grouped, per-step, per-step, grouped) "
              f"{times}; card: {card}")
    return {"gaps": gaps, "ms": times}


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
    if sys.argv[1:] == ["fused"]:  # phase 50 alone
        fused_steps_phase(card, dev)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    # --- 1: card, versions, build ------------------------------------------
    tmp = tempfile.TemporaryDirectory()
    side = {stem: start_cubin(build, Path(tmp.name), stem, src)
            for stem, src in (("serial_sweep", SERIAL_SWEEP_CU),
                              ("old_sweep_mma", OLD_MMA_CU))}
    lib_path, build_s = build.build()
    build.load()
    ptxas, kernel, owner = [], "?", "?"
    for ln in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"(sphere_pt|triangle_pt|uv_demo|philox_bits|"
                      r"wavefront_pass_[abc]|cond_cost|sweep_vpu2?|"
                      r"sweep_mma|onehot_carry|onehot_gather)_kernel", ln)
        if "Compiling entry function" in ln and m:
            # one instantiation per sampler and compile-time setting (the
            # fused kernels' AOVs, fast_math, viewproj; pass A's last two,
            # pass B's fast_math), or per cond_cost mode and carry count:
            # name it
            rng = re.search(r"(Threefry|Philox|TinyMT|TausLCG)", ln)
            body = re.search(r"Li([0-4])ELb", ln)
            flags = ([BODIES[int(body.group(1))]] if body and m.group(1) in
                     KERNEL_FLAGS else []) + [
                name for name, bit in zip(KERNEL_FLAGS.get(
                    m.group(1), ()), re.findall(r"Lb([01])E", ln))
                if bit == "1"]
            rng_flags = ", ".join([rng.group(1)] + flags) if rng else ""
            mode_m = re.search(r"cond_cost_kernelILi(\d+)ELi(\d+)E", ln)
            kernel = owner = m.group(1) + (
                f"<{rng_flags}>" if rng else
                f"<mode {mode_m.group(1)}, m {mode_m.group(2)}>" if mode_m
                else "")
        elif "Function properties for" in ln:
            # the entry's own stack and spill, or those of a function it
            # calls (triangle_pt's out-of-line walk, TriSceneViewT<true>)
            callee = re.search(r"cast_call\w*?(NearestVisit|AnyVisit)", ln)
            owner = (f"{kernel} calls cast_call<{callee.group(1)}>"
                     if callee else kernel)
        elif "registers" in ln or "spill" in ln:
            ptxas.append(f"{kernel if 'registers' in ln else owner}: "
                         f"{ln.split(':', 1)[-1].strip()}")
    from l2n_tpu_torch.probes.onehot_recovery import TH, TW, launch_shape
    group, threads, blocks = launch_shape(TH * TW)
    onehot_regs = [ln for ln in ptxas if ln.startswith("onehot_")
                   and "registers" in ln]
    # The sweeps: the kept kernels' registers and spills (no spill
    # allowed), those of the bodies they replaced (the serial scalar body,
    # the FP64 mma kernel) beside them, and each one's CALL sites.
    side_log = {}
    for stem, proc in side.items():
        _, side_log[stem] = proc.communicate()
        require(proc.returncode == 0,
                f"nvcc of {stem}: {side_log[stem][-2000:]}")
    sweep_regs = [ln for ln in ptxas if re.match(r"sweep_(vpu2?|mma):", ln)]
    require(len([ln for ln in sweep_regs if "spill" in ln]) == 3
            and not any(re.search(r"[1-9]\d* bytes (spill|stack)", ln)
                        for ln in sweep_regs),
            f"sweep_vpu, sweep_vpu2, sweep_mma spill nothing: {sweep_regs}")
    old_regs = (ptxas_lines(side_log["serial_sweep"], r"serial_sweep_vpu2?")
                + ptxas_lines(side_log["old_sweep_mma"], r"old_sweep_mma"))
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    calls = ("cuobjdump not found" if not cuobjdump.exists() else {
        **sass_calls(str(cuobjdump), lib_path,
                     r"sweep_(vpu2?|mma)_kernel"),
        **sass_calls(str(cuobjdump), Path(tmp.name) / "serial_sweep.cubin",
                     r"serial_sweep_vpu2?"),
        **sass_calls(str(cuobjdump), Path(tmp.name) / "old_sweep_mma.cubin",
                     r"old_sweep_mma")})
    tmp.cleanup()
    from l2n_tpu_torch.probes import sweep_variants as sv
    mma_shape = sv.launch_shape("sweep_mma", sv.BLOCKS * sv.TH * sv.TW,
                                sv.SPHERES)
    phase(1, f"card: {card}; torch {torch.__version__}, CUDA "
             f"{torch.version.cuda}; kernels built in {build_s:.1f} s "
             f"({lib_path.name}); onehot_recovery: {group} lanes per ray, "
             f"{threads}-thread blocks, grid {blocks} at {TH * TW} lanes, "
             f"{onehot_regs}; sweep_vpu / sweep_vpu2 (chunked) and "
             f"sweep_mma (3xTF32 miss test, exact resolve; repeats per "
             f"chunk, threads, grid, blocks per SM at the probe's size "
             f"{mma_shape}) {sweep_regs}, the bodies they replaced (the "
             f"serial sweep_lane; the FP64 mma kernel) {old_regs}; CALL "
             f"instructions in their SASS (cuobjdump -sass; one site a "
             f"sqrtf, whose slow path takes arguments outside its fast "
             f"range, negative ones included; sweep_mma's only sqrtf is its "
             f"resolve's) {calls}; ptxas: {' | '.join(ptxas)}")

    for body in ("materials", "nee", "fog"):
        print(f"[ptxas] the {body} bodies' instantiations (registers, spill "
              f"and stack per instantiation; the fused kernels and passes "
              f"A/B): " + " | ".join(
                  ln for ln in ptxas
                  if re.search(rf"[<, ]{body}[,>]", ln.split(":")[0])),
              flush=True)

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
        require(tri_buf.shelled,
                "the default triangle scene's casts take the shell visits")
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
        require(not tori_buf.shelled, "the torus field walks its slabs")
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
        require(tori_err == 0.0,
                f"triangle_pt torus field kernel/plain max abs {tori_err}")
        tori_intersect = triangle_intersector(tori_buf.soup)
        tori_seeds = count_work(
            whole, scheduled_tiles(tiles, 0, whole.tile_count), tori_cam,
            init_frame_state(whole, dev).accum,
            (tori_intersect, triangle_anyhit(tori_intersect),
             tori_buf.albedo.T), tri_buffers=tori_buf)
        tori_balls = int((tori_buf.balls[:, :, 3] > 0).sum())
        phase(8, f"triangle_pt kernel vs plain, torus field "
                 f"({tori.total_triangles} triangles, {tori.mesh_count} "
                 f"meshes of {int(slabs.max())} slabs, {tori_balls} live "
                 f"interior balls, inscribed spheres "
                 f"{int((tori_buf.inner_gap < 2e30).sum())}), aimed camera, "
                 f"1 whole-frame step: accum RMSE {rmse:.3e} (gate 1e-3), "
                 f"max abs {tori_err:.3e} (gate 0), output flip fraction "
                 f"{flips:.3e} (gate 2e-3), lit {lit:.4f}; certain-hit "
                 f"seeds (plain counter): {seed_share(tori_seeds)}")
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
        # k not a multiple of 4: the last Philox block gives fewer words
        for shape in ((4, 256), (4, whole_h), (5, 256), (3, 33)):
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
        phase(13, f"philox_bits kernel vs plain bit-equal at (4, 256, 128), "
                  f"(4, {whole_h}, 128), (5, 256, 128) and (3, 33, 128); "
                  f"the five bit gates of tests/test_tpu_hw.py on the card's bits pass: "
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
                  f"0.05; the mesh views with viewproj: bit-equal but at "
                  f"pixels whose plain sweep kept a hit outside its mesh's "
                  f"bound): {hard}")

        slice_phases(card, tmp, cfg, spheres, tri_cfg, tri_buf, cam)
        materials_phases(card, tmp, cfg, scene, tri_cfg, tri_buf, cam)
        nee_launches = nee_phases(card, tmp, cfg, scene, tri_cfg, tri_buf)
        fog_launches = fog_phases(card, tmp, cfg, scene, tri_cfg, tri_buf,
                                  cam)
        program_phases(card, tmp, cfg, scene, tri_cfg, tri_buf, cam)
        sharded = parallel_phases(card, cfg, scene, tri_cfg, tri_buf, cam)
        trefoil = trefoil_phase(card, dev)
        shell = shell_phase(card, dev, tri_cfg, tri_buf, cam)
        fused_steps_phase(card, dev)

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

    # --- the new settings: kernel ms per launch beside the default's -------
    settings = settings_timing(card, dev, cfg, scene, tri_cfg, tri_scene, cam)

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
    mesh_cull = tri_buf.mesh_bounds.T.contiguous()
    tri_work = {}
    for label, lcfg in (("10-tile", tri_cfg), ("whole-frame", whole)):
        lsched = scheduled_tiles(tiles, 0, lcfg.effective_tiles_per_step)
        w = tri_work[label] = count_work(
            lcfg, lsched, cam, init_frame_state(lcfg, dev).accum,
            tri_closures, cull_bounds=mesh_cull,
            mesh_bounds=tri_buf.mesh_bounds, tri_buffers=tri_buf)
        (bounds if label == "10-tile" else bounds_whole)["triangle_pt"] = (
            triangle_bound(w, m, lsched.shape[0],
                           triangle_scene_bytes(tri_buf, w)))
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
    print(f"[seed] certain-hit seeds of the default triangle scene "
          f"({int((tri_buf.inner_gap < 2e30).sum())} of {m} meshes with an "
          f"inscribed sphere, {int((tri_buf.balls[:, :, 3] > 0).sum())} "
          f"interior balls), whole frame, default view: "
          f"{seed_share(tw)}; 10 tiles: {seed_share(tri_work['10-tile'])} "
          f"(counted on the plain path)", flush=True)
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
        return kernel_row(name, *args, bounds[name],
                          **setting_extra(name, "nee+mis", nee_launches),
                          **setting_extra(name, "fog+nee+mis", fog_launches),
                          **extra)

    def setting_extra(name, setting, path_launches):
        """The kernel's NEE+MIS (or fog+NEE+MIS) instantiation beside its
        row: its launches on phase 37's (40's) main path and its ms per
        launch at 10 tiles and at whole frames ([settings],
        torch.profiler)."""
        family = "wavefront" if name.startswith("wavefront") else name
        if (family, "10-tile", setting) not in settings:
            return {}
        key = re.sub(r"\W", "_", setting)
        return {f"{key}_launches": path_launches.get(name, 0), **{
            f"{key}_{label.replace('-', '_')}_ms":
                settings[(family, label, setting)].get(f"{name}_kernel")
            for label in ("10-tile", "whole-frame")}}

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
            **whole_frame("sphere_pt"),
            sharded_launches=sharded.get("sphere_pt")),
        row("uv_demo", "l2n_tpu_torch/csrc/uv_demo.cu",
            "l2n_tpu/ops/kernels/uv_demo.py:22", uv_launches, uv_err,
            "max abs err <= 1e-5", uv_kernel_ms, uv_ms, uv_plain_ms),
        row("triangle_pt", "l2n_tpu_torch/csrc/triangle_pt.cu",
            "l2n_tpu/ops/kernels/triangle_pt.py:811",
            tri_launches.get("triangle_pt", 0),
            max(tri_err, tori_err, trefoil["trefoil_max_abs_err"]),
            frame_tol, kernel_ms[("triangle_pt", "10-tile")],
            timings[("triangle_pt", "10-tile", "cuda")],
            timings[("triangle_pt", "10-tile", "torch")],
            **whole_frame("triangle_pt"),
            sharded_launches=sharded.get("triangle_pt"), **trefoil,
            **shell),
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
