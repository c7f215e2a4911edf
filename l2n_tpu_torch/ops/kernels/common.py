"""Shared plumbing of the kernel tier: the port's config gate, launch
counters, CUDA-graph capture and replay, the debug checks, tensor checks,
the camera the kernels read, tile pixel coordinates and the kernel-form
accumulate + tonemap (counterpart of l2n_tpu.ops.kernels.common)."""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from l2n_tpu_torch.camera.camera import PACKED_SHAPE, slab_extras
from l2n_tpu_torch.maths.sampling import PI
from l2n_tpu_torch.ops.fog import (
    fog_directional_transmittance,
    fog_inv_sigma,
    fog_sky,
)
from l2n_tpu_torch.ops.kernels import build
from l2n_tpu_torch.ops.nee import emissive_count
from l2n_tpu_torch.ops.pathtrace import generate_rays, shade
from l2n_tpu_torch.rng.sampler import COUNTER_SAMPLERS, config_max_pairs
from l2n_tpu_torch.rng.state import STATE_PLANES, sampler_from_planes
from l2n_tpu_torch.rng.threefry import as_words, to_int32
from l2n_tpu_torch.utils.profiling import Site

# The spans this module records (utils/profiling.py).
_KERNEL_PARAMS = Site("kernel.params")
_KERNEL_LAUNCH = Site("kernel.launch")

# Launches of each hand-written kernel, by kernel name. A wrapper adds one
# right after its kernel launched, and nowhere else: the plain versions a
# wrapper runs for CPU tensors do not count. Read it to show that a run went
# through the kernels.
launches: collections.Counter = collections.Counter()
# Calls of a render step by how they ran: "eager" (render/step.py: the
# step's launches dispatched one by one), "capture" (`capture`: a CUDA graph
# captured) and "replay" (`replay`: a graph replayed; a captured graph is
# replayed at once, so the call that captures counts one of each). Read
# eager over eager + replay for the share of calls the host dispatches
# launch by launch.
graph_calls: collections.Counter = collections.Counter()


def reset_launches() -> None:
    """Zero both counters, `launches` and `graph_calls`."""
    launches.clear()
    graph_calls.clear()


# Set by utils/validate.debug_mode(): each launch then synchronizes its
# device, which raises on a CUDA error of the launch or its run, and each
# render step audits its frame state (render/step.py).
_debug_checks = False


def debug_checks() -> bool:
    return _debug_checks


def set_debug_checks(on: bool) -> bool:
    """Turn the debug checks on or off; returns the previous setting."""
    global _debug_checks
    prev, _debug_checks = _debug_checks, bool(on)
    return prev


def capture(fn, device: torch.device):
    """Capture the kernel launches of fn() on `device` into a CUDA graph,
    which runs nothing until it is replayed. Returns (graph, the launches it
    holds): a capture counts no launch in `launches` (it runs none), and
    `replay` adds the held ones per replay. Raises if the capture fails.
    The kernel library must be built and every launcher's shared-memory
    opt-in done before (an eager run of fn): neither may happen while a
    stream captures."""
    before = launches.copy()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph):
            fn()
        held = launches - before
    finally:
        launches.clear()
        launches.update(before)
    graph_calls["capture"] += 1
    return graph, held


def replay(graph, held: collections.Counter) -> None:
    """Replay a graph of `capture` on the current stream and count its
    launches."""
    graph.replay()
    launches.update(held)
    graph_calls["replay"] += 1


def stream_capturing(device: torch.device) -> bool:
    """Whether the current stream of `device` is capturing a CUDA graph."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def check_supported(cfg) -> None:
    """Validate the config. The port renders every config the JAX package
    accepts; were a part of it still unported, this would raise
    NotImplementedError naming the ROADMAP item that ports it, so that
    nothing is silently ignored."""
    cfg.validate()


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Validate what a kernel wrapper is handed before any pointer is
    taken: dtype, shape, device and contiguity."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# The kernels' AOV, sky and camera codes (csrc/pathtrace.cuh kAov*, kEnv*,
# kRayGen*).
AOV_CODES = {"pathtracing": 0, "tex_coords": 1, "param_uv": 2, "normal": 3,
             "hit": 4, "ambient_occlusion": 5}
ENV_CODES = {"none": 0, "mandelbrot": 1, "sun": 2}
RAY_GEN_CODES = {"fovy": 0, "viewproj": 1}
# The kernels' sampler codes (csrc/pathtrace.cuh kRng*): the host entry
# points pick the kernel instantiation of the configured sampler.
RNG_CODES = {"threefry": 0, "tpu_hw": 1, "tinymt": 2, "tauslcg": 3}
# The kernels' material codes (csrc/pathtrace.cuh kMaterial*).
MATERIAL_CODES = {"procedural": 0, "microfacet": 1, "disney": 2}


def table_rows(cfg, lights=None) -> int:
    """Rows of the per-object table (albedo, then the material channels,
    scene/materials.MATERIAL_CHANNELS) a kernel may stage: 9 with a
    material mode, the bump, explicit lights or NEE (csrc/pathtrace.cuh
    table_rows: the materials and NEE bodies and the bumped normal AOV),
    else the 3 albedo rows of the Lambert body."""
    materials = (cfg.material_mode != "procedural" or cfg.normal_map > 0.0
                 or cfg.nee or (lights is not None and lights.has_lights))
    return 9 if materials else 3


def check_rng_state(cfg, rng_state, device) -> None:
    """The stateful modes' state planes: (planes, Hp, Wp) int32 (32-bit
    words as int32 bit patterns, rng/state.STATE_PLANES) on the frame's
    device, updated in place; None for the counter-based modes."""
    planes = STATE_PLANES.get(cfg.rng, 0)
    if not planes:
        if rng_state is not None:
            raise ValueError(f"rng_state: rng={cfg.rng!r} keeps no state "
                             "planes; pass None")
        return
    if rng_state is None:
        raise ValueError(f"rng_state: rng={cfg.rng!r} needs its "
                         f"({planes}, Hp, Wp) state planes")
    check_tensor("rng_state", rng_state, torch.int32,
                 (planes, cfg.padded_height, cfg.padded_width), device)


def step_params(cfg, k: int, n_scene: int, camera, lights=None):
    """The integer and float parameter arrays of csrc/pathtrace.cuh's
    params_from_arrays, in its order, for K scheduled tiles over a scene of
    `n_scene` spheres or meshes, with the point and directional light
    counts of `lights` (ops/lights.ExplicitLights, or None). Under NEE the
    scene's E lights ride in the ints and NEE's two constants, as float32
    roundings of the float64 products that ops/nee.py rounds too, in the
    floats: scale E (area) and scale / (4 pi) (cone). Fog's flag and
    constants (ops/fog.py) come last: sigma, float32(1 / sigma), the sky
    distance, the albedo and the directional lights' transmittance. The
    camera (a packed host array or a DeviceCamera) gives only its slab
    extras (camera/camera.py): the stream (ip[12]) and the slab's row
    offset, the last int, after fog's flag, so that every other parameter
    keeps its place. The camera block itself is no parameter: the kernels
    read it from a device buffer (`DeviceCamera`)."""
    with _KERNEL_PARAMS:
        row_offset, stream = camera_extras(camera)
        n_point = 0 if lights is None else lights.point.shape[0]
        n_dir = 0 if lights is None else lights.directional.shape[0]
        n_lights = (emissive_count(n_scene, cfg.emissive_every) if cfg.nee
                    else 0)
        fog = cfg.fog_density > 0.0
        ip = np.array([cfg.tile_height, cfg.tile_width, cfg.padded_height,
                       cfg.padded_width, k, n_scene, cfg.spp_per_step,
                       cfg.max_bounces, config_max_pairs(cfg),
                       cfg.emissive_every, ENV_CODES[cfg.env_mode],
                       cfg.seed & 0xFFFFFFFF, stream, AOV_CODES[cfg.aov],
                       RNG_CODES[cfg.rng], RAY_GEN_CODES[cfg.ray_gen],
                       int(cfg.fast_math), MATERIAL_CODES[cfg.material_mode],
                       n_point, n_dir, int(cfg.nee), int(cfg.mis), n_lights,
                       int(fog), row_offset], dtype=np.int64)
        ip = ip.astype(np.uint32).view(np.int32)
        fp = np.array(
            [1.0 / (cfg.ndc_width or cfg.width),
             1.0 / (cfg.ndc_height or cfg.height), cfg.rr_ceiling,
             cfg.ray_epsilon, cfg.emission_scale, cfg.env_scale, cfg.gamma,
             cfg.normal_map, cfg.normal_map_freq,
             cfg.emission_scale * n_lights, cfg.emission_scale / (4.0 * PI),
             cfg.fog_density, fog_inv_sigma(cfg) if fog else 0.0,
             fog_sky(cfg), cfg.fog_albedo, fog_directional_transmittance(cfg)],
            np.float32)
        return np.ascontiguousarray(ip), fp


def check_camera(camera) -> np.ndarray:
    """The packed (10, 4) float32 camera block as a contiguous host array."""
    camera = np.ascontiguousarray(camera, dtype=np.float32)
    if camera.shape != PACKED_SHAPE:
        raise ValueError(f"camera: shape {camera.shape}, expected "
                         f"{PACKED_SHAPE}")
    return camera


class DeviceCamera(NamedTuple):
    """The packed (10, 4) float32 camera in a buffer on the frame's device,
    which the kernels read when they run (csrc/pathtrace.cuh stage_camera),
    and its slab extras (row offset, stream; camera/camera.py), which ride
    in their int parameters. A built step owns one and writes each new
    camera into it (`write_camera`), so that its CUDA graph serves every
    camera pose."""
    buffer: torch.Tensor
    extras: tuple[int, int] = (0, 0)


def write_camera(buffer: torch.Tensor, camera: np.ndarray) -> None:
    """Write the packed host camera into `buffer`, a (10, 4) float32
    tensor, in stream order: on the card by a kernel that takes the 40
    floats by value (csrc/camera.cu), which a stream capture records with
    them; elsewhere by a copy."""
    if buffer.device.type == "cuda":
        launch_raw("camera_write", buffer.device, check_camera(camera),
                   buffer)
    else:
        buffer.copy_(torch.from_numpy(check_camera(camera)))


def check_step_camera(camera, device: torch.device):
    """A step wrapper's camera: a DeviceCamera whose buffer is a contiguous
    (10, 4) float32 tensor on `device`, as it is, or the packed host array
    (`check_camera`)."""
    if isinstance(camera, DeviceCamera):
        check_tensor("camera", camera.buffer, torch.float32, PACKED_SHAPE,
                     device)
        return camera
    return check_camera(camera)


def camera_extras(camera) -> tuple[int, int]:
    """(row_offset, stream) of a packed host camera or a DeviceCamera."""
    if isinstance(camera, DeviceCamera):
        return camera.extras
    return slab_extras(camera)


def host_camera(camera) -> np.ndarray:
    """The packed camera as a host array; a DeviceCamera's buffer is read
    now (the plain versions, which run when they are called)."""
    if isinstance(camera, DeviceCamera):
        return camera.buffer.detach().cpu().numpy().copy()
    return check_camera(camera)


def kernel_camera(camera, device: torch.device) -> DeviceCamera:
    """The DeviceCamera a kernel launch reads: `camera` itself, or a new
    buffer on `device` written with the packed host array."""
    if isinstance(camera, DeviceCamera):
        return camera
    buffer = torch.empty(PACKED_SHAPE, dtype=torch.float32, device=device)
    write_camera(buffer, camera)
    return DeviceCamera(buffer, slab_extras(camera))


def check_schedule(cfg, sched, accum, output=None) -> int:
    """Validate the schedule and the frame planes a step kernel reads or
    updates in place (`output` where it writes one); returns the number of
    scheduled tiles K."""
    dev = accum.device if isinstance(accum, torch.Tensor) else None
    k = sched.shape[0] if isinstance(sched, torch.Tensor) else -1
    check_tensor("sched", sched, torch.int32, (k, 2), dev)
    if not 1 <= k <= cfg.tile_count:
        raise ValueError(f"sched: {k} tiles, expected 1..{cfg.tile_count}")
    hp, wp = cfg.padded_height, cfg.padded_width
    check_tensor("accum", accum, torch.float32, (4, hp, wp), dev)
    if output is not None:
        check_tensor("output", output, torch.float32, (3, hp, wp), dev)
    return k


def tile_pixel_coords(cfg, sched: torch.Tensor):
    """(row, col) int64 tensors of shape (K, tile_height, tile_width) for
    the scheduled tiles sched (K, 2) = (tile_x, tile_y)."""
    th, tw = cfg.tile_height, cfg.tile_width
    dev = sched.device
    tx = sched[:, 0].to(torch.int64).view(-1, 1, 1)
    ty = sched[:, 1].to(torch.int64).view(-1, 1, 1)
    row = ty * th + torch.arange(th, device=dev).view(1, th, 1)
    col = tx * tw + torch.arange(tw, device=dev).view(1, 1, tw)
    return row.expand(-1, th, tw), col.expand(-1, th, tw)


def safe_gamma(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """pow(x, gamma) for x >= 0 as exp(gamma * log(max(x, 1e-30))), 0 for
    x <= 0 — the kernels' display form (the XLA oracle uses
    power(max(rgb, 0) / max(n, 1e-20), gamma); the two differ in the last
    ulps, so tests compare `accum` tightly and `output` loosely)."""
    safe = torch.clamp(x, min=1e-30)
    return torch.where(x <= 0.0, torch.zeros_like(x),
                       torch.exp(gamma * torch.log(safe)))


def accumulate_and_tonemap(cfg, accum: torch.Tensor, output: torch.Tensor,
                           flat: torch.Tensor, sums, spp: int) -> None:
    """IN PLACE over the pixels `flat` (indices into the flattened planes):
    accum += (sum_r, sum_g, sum_b, spp); output = gamma(rgb / n)."""
    acc = accum.view(4, -1)
    out = output.view(3, -1)
    a = acc[:, flat]
    n = a[3] + float(spp)
    rgb = [a[c] + sums[c] for c in range(3)]
    acc[:, flat] = torch.stack(rgb + [n])
    inv = 1.0 / n
    out[:, flat] = torch.stack([safe_gamma(c * inv, cfg.gamma) for c in rgb])


def _sample_samplers(cfg, flat, sample_index, rng_state, pixel_index=None,
                     stream=0):
    """The sampler of each of the step's `spp` samples over the lanes
    `flat` (offsets into the frame's planes), made lazily: a fresh
    counter-based sampler per sample, keyed on (seed, `stream`) and the
    lanes' `pixel_index` (`flat` where None: a frame that is not a slab),
    or one stateful sampler over the states gathered at `flat` whose state
    chains from sample to sample. After the last sample the stepped states
    are scattered back into `rng_state` IN PLACE. The stateful samplers
    ignore the stream: their state planes are the slab's rows of the
    frame's."""
    spp = cfg.spp_per_step
    if cfg.rng in COUNTER_SAMPLERS:
        cls = COUNTER_SAMPLERS[cfg.rng]
        pixel = flat if pixel_index is None else pixel_index
        for s in range(spp):
            yield cls(cfg.seed, stream, pixel, sample_index + s,
                      config_max_pairs(cfg))
        return
    planes = rng_state.view(rng_state.shape[0], -1)
    sampler = sampler_from_planes(cfg.rng, [
        as_words(planes[i, flat]) for i in range(planes.shape[0])])
    for _ in range(spp):
        yield sampler
    for i, w in enumerate(sampler.final_state()):
        planes[i, flat] = to_int32(w)


def render_tiles_plain(cfg, sched: torch.Tensor, camera, intersect, anyhit,
                       table: torch.Tensor, accum: torch.Tensor,
                       output: torch.Tensor, rng_state=None,
                       miss_color=(0.0, 0.0, 0.0), lights=None,
                       nee=None) -> None:
    """The plain torch step shared by the kernels' plain versions: for every
    pixel of the scheduled tiles, `spp` samples in lockstep through
    ops/pathtrace.shade with the scene's `intersect`/`anyhit` closures,
    per-object table (n, 9) (or its (n, 3) albedo columns where the config
    reads no more, table_rows), normal-AOV `miss_color`, explicit
    `lights` and NEE's light sampler `nee`, then accumulate + tonemap IN
    PLACE; the stateful modes' `rng_state` planes are stepped IN PLACE
    too. The camera's slab extras (camera/camera.py) place the frame's rows
    in a larger frame, whose global rows give the pixel index and the
    camera rays, and key the counter-based samplers' stream. A DeviceCamera
    is read when the step runs."""
    dev = accum.device
    camera = host_camera(camera)
    row_offset, stream = slab_extras(camera)
    cam = torch.as_tensor(camera).to(dev)
    row, col = tile_pixel_coords(cfg, sched)
    flat = (row * cfg.padded_width + col).reshape(-1)  # into the planes
    grow = row.reshape(-1) + row_offset  # the global row
    pixel_index = grow * cfg.padded_width + col.reshape(-1)
    sample_index = accum[3].reshape(-1)[flat].to(torch.int32)
    rowf = grow.to(torch.float32)
    colf = col.reshape(-1).to(torch.float32)

    spp = cfg.spp_per_step
    sums = [torch.zeros(flat.shape, dtype=torch.float32, device=dev)
            for _ in range(3)]
    for sampler in _sample_samplers(cfg, flat, sample_index, rng_state,
                                    pixel_index, stream):
        u1, u2 = sampler.draw2()  # pixel jitter, every lane
        rays = generate_rays(cfg, cam, colf, rowf, u1, u2)
        rgb = shade(cfg, intersect, anyhit, table, sampler, *rays,
                    miss_color=miss_color, lights=lights, nee=nee)
        sums = [a + b for a, b in zip(sums, rgb)]
    accumulate_and_tonemap(cfg, accum, output, flat, sums, spp)


def launch_raw(name: str, device: torch.device, *args) -> None:
    """Launch the C entry point `l2n_<name>` of the kernel library on the
    current stream of `device` and count it. `args` are host numpy arrays
    (passed by address), device tensors (by data pointer), None (a null
    pointer) or Python ints, in the entry point's order before its stream.
    Raises on a refused launch; builds the library at its first use."""
    def arg(a):
        if isinstance(a, np.ndarray):
            return ctypes.c_void_p(a.ctypes.data)
        if isinstance(a, torch.Tensor):
            return ctypes.c_void_p(a.data_ptr())
        if a is None:
            return ctypes.c_void_p(None)
        return ctypes.c_int(a)

    with _KERNEL_LAUNCH:
        fn = getattr(build.load(), f"l2n_{name}")
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*map(arg, args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    if _debug_checks:
        torch.cuda.synchronize(device)


# Shared memory a Hopper block can opt in to.
MAX_SMEM = 227 * 1024


def launch(name: str, cfg, device: torch.device, *args) -> None:
    """`launch_raw` for a path-tracing step kernel of config `cfg`, whose
    blocks are one tile row of at most 1024 threads."""
    if cfg.tile_width > 1024:
        raise ValueError(f"{name}: tile_width must be <= 1024 (one thread "
                         "per column of a tile row)")
    launch_raw(name, device, *args)
