"""Device time of the render steps at the default configs' two schedules
(the reference's 10 tiles and whole-frame steps of 230 tiles), for holding
two or more versions of the kernels against each other on one card in one
call: the fused step kernels, sphere_pt and triangle_pt, and the wavefront
step (`RenderConfig(wavefront=True)`, threefry and tpu_hw), whole and pass
by pass; the onehot_recovery probe's two kernels at its S = 128; the
sweep_variants probe's three kernels at its size (64 blocks, 128 spheres,
16 repeats); philox_bits at (4, 256, 128) and (4, 7360, 128), the
raw-bits gates' draw and a whole padded frame's; triangle_pt's
materials body (microfacet, the bump, two explicit lights), NEE+MIS and
fog+NEE+MIS bodies on the default triangle config ("settings"), and the
default and those five again in threefry and in tpu_hw ("triangle"); and
triangle_pt on the
70,144-triangle trefoil knot at the JAX bench's `bigobj` config
(`bigobj_case`; tpu_hw and threefry, 10 tiles from the frame's middle and
whole frames), where one mesh of 548 slabs takes the slab-group level;
and the host's time a call of the built step at one step a call ("host":
render/step.build_render_step on bench.py's headline config, the camera
turned 1 degree a call as portbench's orbit mix turns it).

    # the kernels of the tree at DIR (e.g. a `git archive` of the parent
    # commit) and of this tree, in turns: DIR, this, this, DIR
    python3 l2n_tpu_torch/probes/step_ab.py --parent DIR
    # more trees (variants of this one), in turns: DIR, this, V1, V2, V2,
    # V1, this, DIR; --only FAMILY[,FAMILY...] (fused, wavefront, onehot,
    # sweep, philox, trefoil, settings, triangle, host) times only those
    python3 l2n_tpu_torch/probes/step_ab.py --parent DIR --variant V1 \
        --variant V2 --only wavefront

Each measurement runs in a process of its own that imports the package
from its tree (`--root`), renders from a zero frame state with the default
camera, and times N back-to-back calls captured once into a CUDA graph and
replayed between CUDA events, the best of 3 replays: the device time
without the host's dispatch. The fused families time their public wrapper
(handed the packed host camera, which it writes to a device buffer on
every call, since the kernels read the camera from one); the wavefront
step is the built step (render/step.build_render_step, backend="cuda"), as
the main path runs it, schedule gather included (inside the outer capture
it runs eagerly). Its passes are timed by torch.profiler over calls of the
step (device ms per launch of each `wavefront_pass_*_kernel`, and every
other device event of the step summed per step, "rest"), which replay the
step's own graph once it has captured one. The onehot pair is timed per call of its
wrapper by graph replay, and per launch by torch.profiler ("... kernel");
the sweeps the same way (sweep_vpu, sweep_vpu2, sweep_mma), and
philox_bits per shape (graph replay of 200 calls, torch.profiler over
50). "host" is the host clock around each call of the step (the device
synchronized after it, outside the time) and around each call and its
synchronize, the median and the 95th percentile of 300 calls after 3
(the library's build, a capture where the step captures one).
Needs one CUDA card; prints one JSON line per process and a summary, the
fused kernels' registers and spill stores per instantiation in each tree
(from its build log, `ptxas -v`) with the instantiations where the trees
differ, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import time
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


def ptxas(tree: Path, pattern=r"(sphere_pt|triangle_pt)_kernel") -> dict:
    """{instantiation: [registers, spill store bytes]} of the kernels whose
    entry names match `pattern`, from the tree's newest build log (the
    entry's own spill, not that of the functions it calls). The
    names drop what nvcc derives from the file's contents (the source's
    hash, the anonymous namespace's) and the kernel's parameter list, so
    that two trees' entries meet."""
    logs = sorted((tree / "l2n_tpu_torch" / "build").glob("*.log"),
                  key=lambda p: p.stat().st_mtime)
    out, entry, raw, own = {}, None, None, False
    for ln in logs[-1].read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            raw, own = m.group(1), True
            entry = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_|_cu_[0-9a-f]+|"
                           r"vNS\d+_8PtParams.*$", "", raw)
            entry = entry if re.search(pattern, entry) else None
            continue
        f = re.search(r"Function properties for (\S+)", ln)
        if f:  # the entry's own, or a function it calls (not counted)
            own = f.group(1) == raw
            continue
        if entry is None:
            continue
        regs = re.search(r"Used (\d+) registers", ln)
        spill = re.search(r"(\d+) bytes spill stores", ln)
        row = out.setdefault(entry, [None, None])
        if regs:
            row[0] = int(regs.group(1))
        if spill and own:
            row[1] = int(spill.group(1))
    return out


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


def _schedules(torch, cfg, first: int = 0):
    """{schedule: (cfg, sched)}: 10 tiles from tile `first`, and every
    tile."""
    from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
    tiles = torch.as_tensor(tile_grid(cfg)).to("cuda")
    return {"10-tile": (cfg.replace(tiles_per_step=10),
                        scheduled_tiles(tiles, first, 10)),
            "whole-frame": (cfg.replace(tiles_per_step=cfg.tile_count),
                            scheduled_tiles(tiles, 0, cfg.tile_count))}


def bigobj_case():
    """The JAX bench's `bigobj` stage (bench.py stage_bigobj) for the port:
    (cfg, scene, packed camera). The 70,144-triangle trefoil knot
    (scene/procgen.py trefoil_obj at its defaults, through load_obj: one
    mesh of 548 slabs); 1024x1024 in 32x128 tiles, whole-frame steps, 1
    spp, fast_math off, rng tpu_hw; the camera aimed at the vertices' mean
    from (0.35, 0.25, 1.0) x 1.45 times their largest distance from it, so
    that the knot fills the view."""
    import numpy as np
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.maths.linalg import look_at
    from l2n_tpu_torch.scene import load_obj, trefoil_obj
    cfg = RenderConfig(width=1024, height=1024, tile_height=32,
                       tile_width=128, tiles_per_step=1024, spp_per_step=1,
                       rng="tpu_hw", fast_math=False,
                       scene_kind="triangle").validate()
    scene = load_obj(trefoil_obj())
    verts = np.asarray(scene.vertices).reshape(-1, 3)
    target = verts.mean(0).astype(np.float32)
    radius = float(np.linalg.norm(verts - target, axis=1).max())
    vm = look_at(target + np.array([0.35, 0.25, 1.0], np.float32)
                 * 1.45 * radius, target,
                 np.array([0.0, 1.0, 0.0], np.float32))
    return cfg, scene, Camera.from_config(cfg, view_matrix=vm).packed()


def lit_knot(knot):
    """`knot` (a TriangleScene of one mesh) as mesh 1 behind a light: mesh
    0, the only emissive one under emissive_every > 1, a sphere of a fifth
    of the knot's radius (its vertices' largest distance from their mean)
    outside that radius, above and in front of the knot as bigobj_case's
    camera sees it. Bounces, shadow rays and NEE toward the light then
    walk the knot's slab groups, which a knot that is mesh 0 (emissive)
    never does past its primaries."""
    import numpy as np
    from l2n_tpu_torch.scene import (
        TriangleScene,
        merge_scenes,
        tessellate_sphere,
    )
    verts = np.asarray(knot.vertices).reshape(-1, 3)
    target = verts.mean(0).astype(np.float32)
    radius = float(np.linalg.norm(verts - target, axis=1).max())
    up = np.array([0.2, 1.0, 0.6], np.float32)
    p, n, t, idx = tessellate_sphere(
        target + up / np.linalg.norm(up) * np.float32(1.3 * radius),
        0.2 * radius, 16, 8)
    light = TriangleScene(vertices=p, normals=n, tex_coords=t, indices=idx,
                          triangle_count=[idx.shape[0] // 3],
                          index_offset=[0])
    return merge_scenes(light, knot)


def _trefoil(torch, root: Path, times: dict) -> None:
    """triangle_pt on bigobj_case's trefoil (the tree's own packing, timed
    on the host clock) per rng mode and schedule (10 tiles from the
    middle of the frame) into `times`."""
    sys.path.insert(0, str(root))
    from l2n_tpu_torch.ops.kernels import triangle_pt
    from l2n_tpu_torch.render.state import init_frame_state
    assert Path(triangle_pt.__file__).resolve().is_relative_to(root)
    cfg, scene, cam = bigobj_case()
    t0 = time.perf_counter()
    buf = triangle_pt.TriangleBuffers.from_scene(scene, "cuda")
    times["trefoil pack s"] = time.perf_counter() - t0
    for rng in ("tpu_hw", "threefry"):
        rcfg = cfg.replace(rng=rng)
        for label, (scfg, sched) in _schedules(
                torch, rcfg, rcfg.tile_count // 2 - 5).items():
            st = init_frame_state(scfg, torch.device("cuda"))
            times[f"trefoil {rng} {label}"] = graph_ms(
                torch, lambda: triangle_pt.triangle_pt(
                    scfg, sched, cam, buf, st.accum, st.output),
                CALLS[label])


def profile_ms(torch, fn, n: int, kernels=r"wavefront_pass_[abc]_kernel"):
    """{kernel: device ms per launch} of the kernels whose names match
    `kernels` (the wavefront passes), and "rest": every other device event,
    ms per call, from torch.profiler over n eager calls of fn() (after one
    unprofiled call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    launches, rest = collections.defaultdict(list), 0.0
    for e in dev:
        m = re.search(kernels, e.name)
        if m:
            launches[m.group(0)].append(e.time_range.elapsed_us())
        else:
            rest += e.time_range.elapsed_us()
    out = {k: sum(v) / len(v) / 1e3 for k, v in sorted(launches.items())}
    out["rest"] = rest / n / 1e3
    return out


def _wavefront(torch, cam, times: dict) -> None:
    """The wavefront step's times per rng mode and schedule into `times`."""
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.step import build_render_step
    from l2n_tpu_torch.scene import compute_spheres
    dev = torch.device("cuda")
    cfg = RenderConfig(wavefront=True).validate()
    scene = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    for rng in ("threefry", "tpu_hw"):
        for label in CALLS:
            lcfg = cfg.replace(rng=rng)
            if label == "whole-frame":
                lcfg = lcfg.replace(tiles_per_step=lcfg.tile_count)
            step = build_render_step(lcfg, scene, backend="cuda", device=dev)
            box = [init_frame_state(lcfg, dev)]

            def call():
                box[0] = step(box[0], cam)

            key = f"wavefront {rng} {label}"
            times[key] = graph_ms(torch, call, CALLS[label])
            for name, ms in profile_ms(torch, call, 20).items():
                times[f"{key} {name}"] = ms


def _host(torch, root: Path, times: dict) -> None:
    """The built step's host ms a call at one step a call, and ms a frame
    with its synchronize, over cameras turned 1 degree a call (module
    doc), into `times`."""
    import math

    import numpy as np
    sys.path.insert(0, str(root))
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.render.state import init_frame_state
    from l2n_tpu_torch.render.step import build_render_step
    from l2n_tpu_torch.scene import compute_spheres
    assert Path(sys.modules["l2n_tpu_torch"].__file__).resolve(
    ).is_relative_to(root)
    dev = torch.device("cuda")
    cfg = RenderConfig(width=1024, height=1024, tile_height=32,
                       tile_width=128, tiles_per_step=1024, spp_per_step=4,
                       rng="tpu_hw", fast_math=True).validate()
    step = build_render_step(cfg, compute_spheres(
        cfg.sphere_count, cfg.world_size, cfg.scene_seed), backend="cuda",
        device=dev)
    view0 = Camera.from_config(cfg).view_matrix.astype(np.float64)

    def camera(deg):
        a = math.radians(deg)
        rot = np.array([[math.cos(a), 0.0, math.sin(a), 0.0],
                        [0.0, 1.0, 0.0, 0.0],
                        [-math.sin(a), 0.0, math.cos(a), 0.0],
                        [0.0, 0.0, 0.0, 1.0]])
        return Camera.from_config(cfg, view_matrix=(
            view0 @ rot.T).astype(np.float32)).packed()

    cams = [camera(float(i)) for i in range(303)]
    st = init_frame_state(cfg, dev)
    host, frame = [], []
    for i, cam in enumerate(cams):
        t0 = time.perf_counter()
        st = step(st, cam)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= 3:
            host.append((t1 - t0) * 1e3)
            frame.append((t2 - t0) * 1e3)
    for name, v in (("host", host), ("frame", frame)):
        v = sorted(v)
        times[f"host N=1 orbit {name} ms p50"] = v[len(v) // 2]
        times[f"host N=1 orbit {name} ms p95"] = v[int(0.95 * len(v))]


def _onehot(torch, root: Path, times: dict) -> None:
    """The onehot pair's device ms per call of its wrapper (graph replay of
    200 calls) and per launch (torch.profiler over 50) into `times`."""
    sys.path.insert(0, str(root))
    from l2n_tpu_torch.probes import onehot_recovery as oh
    assert Path(oh.__file__).resolve().is_relative_to(root)
    x = {k: torch.from_numpy(v).to("cuda") for k, v in oh.inputs().items()}
    calls = {"onehot_carry": lambda: oh.onehot_carry(x["rays"], x["spheres"]),
             "onehot_gather": lambda: oh.onehot_gather(x["rays"], x["spheres"],
                                                       x["table"])}
    for name, fn in calls.items():
        times[name] = graph_ms(torch, fn, 200)
        times[f"{name} kernel"] = profile_ms(torch, fn, 50,
                                             f"{name}_kernel").get(
                                                 f"{name}_kernel")


def _sweep(torch, root: Path, times: dict) -> None:
    """The sweep probe's kernels' device ms per call of their wrappers
    (graph replay of 20 calls) and per launch (torch.profiler over 10) into
    `times`."""
    sys.path.insert(0, str(root))
    from l2n_tpu_torch.probes import sweep_variants as sv
    assert Path(sv.__file__).resolve().is_relative_to(root)
    x = {k: torch.from_numpy(v).to("cuda") for k, v in sv.inputs().items()}
    o, d, cmat = x["o"], x["d"], x["cmat"]
    sph = [x[k] for k in ("cx", "cy", "cz", "r2")]
    bias = torch.zeros(o.shape[1:], dtype=torch.float32, device="cuda")
    calls = {"sweep_vpu": lambda: sv.sweep_vpu(o, d, *sph, bias),
             "sweep_vpu2": lambda: sv.sweep_vpu2(o, d, *sph, bias),
             "sweep_mma": lambda: sv.sweep_mma(o, d, cmat, bias)}
    for name, fn in calls.items():
        times[name] = graph_ms(torch, fn, 20)
        times[f"{name} kernel"] = profile_ms(torch, fn, 10,
                                             f"{name}_kernel").get(
                                                 f"{name}_kernel")


def _philox(torch, root: Path, times: dict) -> None:
    """philox_bits' device ms per call of its wrapper (graph replay of 200
    calls) and per launch (torch.profiler over 50) per shape into
    `times`."""
    sys.path.insert(0, str(root))
    from l2n_tpu_torch.ops.kernels import philox_bits as pb
    assert Path(pb.__file__).resolve().is_relative_to(root)
    seeds = torch.tensor([123, 456], dtype=torch.int32, device="cuda")
    for k, h in ((4, 256), (4, 7360)):
        name = f"philox_bits ({k},{h},128)"
        fn = (lambda k=k, h=h: pb.philox_bits(seeds, k, h))
        times[name] = graph_ms(torch, fn, 200)
        times[f"{name} kernel"] = profile_ms(
            torch, fn, 50, "philox_bits_kernel").get("philox_bits_kernel")


# triangle_pt's other bodies (family "settings"): the materials body (a
# material mode, the bump, and chip_smoke.py's two explicit lights), the
# NEE and fog bodies, on the default triangle config and camera.
SETTINGS = {"microfacet": {"material_mode": "microfacet"},
            "normal_map": {"normal_map": 0.8},
            "lights": {"lights": True},
            "nee+mis": {"nee": True, "mis": True},
            "fog+nee+mis": {"fog_density": 0.002, "fog_albedo": 0.8,
                            "nee": True, "mis": True}}


def _lights():
    """chip_smoke.py light_containers' point light (at the origin,
    intensity (5e7, 4e7, 3e7)) and directional light ((0.3, -1, 0.2),
    radiance (0.5, 0.5, 0.6)), with no Phong albedo."""
    import numpy as np
    from l2n_tpu_torch.ops.lights import ExplicitLights
    from l2n_tpu_torch.scene.materials import (
        DirectionalLights,
        PhongMaterials,
        PointLights,
    )
    return ExplicitLights(
        PhongMaterials.from_arrays(np.zeros((0, 4), np.float32),
                                   np.zeros((0, 3), np.float32),
                                   np.zeros(0, np.float32)),
        PointLights.from_arrays(np.zeros((1, 3), np.float32),
                                np.array([[5e7, 4e7, 3e7]], np.float32)),
        DirectionalLights.from_arrays(
            np.array([[0.3, -1.0, 0.2]], np.float32),
            np.array([[0.5, 0.5, 0.6]], np.float32)))
FAMILIES = ("fused", "wavefront", "onehot", "sweep", "philox", "trefoil",
            "settings", "triangle", "host")


def measure_tree(root: Path, only: str) -> dict:
    """ms per call of each family's public wrapper or step, per schedule;
    `only` is "all" or a comma-separated list of FAMILIES."""
    import torch
    want = set(FAMILIES if only == "all" else only.split(","))
    times = {}
    if "onehot" in want:
        _onehot(torch, root, times)
    if "sweep" in want:
        _sweep(torch, root, times)
    if "philox" in want:
        _philox(torch, root, times)
    if "trefoil" in want:
        _trefoil(torch, root, times)
    if "host" in want:
        _host(torch, root, times)
    if want & {"fused", "wavefront", "settings", "triangle"}:
        _, cam, families = _families(root)
        from l2n_tpu_torch.render.state import init_frame_state
    cases = []
    if "fused" in want:
        cases += [(name, name, {}) for name in families]
    if "settings" in want:
        cases += [(f"triangle_pt {setting}", "triangle_pt", kw)
                  for setting, kw in SETTINGS.items()]
    if "triangle" in want:
        cases += [(f"triangle_pt {setting} {rng}", "triangle_pt",
                   {**kw, "rng": rng})
                  for rng in ("threefry", "tpu_hw")
                  for setting, kw in {"default": {}, **SETTINGS}.items()]
    for key, name, kw in cases:
        mod, cfg, scene = families[name]
        kernel = getattr(mod, name)
        kw = dict(kw)
        extra = {"lights": _lights()} if kw.pop("lights", False) else {}
        for label, (scfg, sched) in _schedules(torch,
                                               cfg.replace(**kw)).items():
            st = init_frame_state(scfg, torch.device("cuda"))
            times[f"{key} {label}"] = graph_ms(torch, lambda: kernel(
                scfg, sched, cam, scene, st.accum, st.output, **extra),
                CALLS[label])
    if "wavefront" in want:
        _wavefront(torch, cam, times)
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
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="one more tree, measured after this one")
    ap.add_argument("--only", default="all",
                    help="all, or families to time, comma-separated: "
                    + ", ".join(FAMILIES))
    ap.add_argument("--root", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.only != "all" and not set(args.only.split(",")) <= set(FAMILIES):
        ap.error(f"--only: families are {', '.join(FAMILIES)}")
    if args.root is not None:  # one measurement, in this process
        print(json.dumps(measure_tree(args.root.resolve(), args.only)),
              flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent DIR")
    trees = {"parent": args.parent.resolve(), "this": THIS_TREE}
    for v in args.variant:
        trees[v.name] = v.resolve()
    names = list(trees)
    turns = names + names[::-1]
    runs = {name: [] for name in names}
    for name in turns:
        run = _run(["--root", str(trees[name]), "--only", args.only])
        runs[name].append(run["ms"])
        print(json.dumps({"tree": name, **run}), flush=True)
    keys = runs["this"][0].keys()
    summary = {k: {name: [r.get(k) for r in rs] for name, rs in runs.items()}
               for k in keys}
    print(json.dumps({"turns": turns, "ms": summary}), flush=True)
    regs = {name: ptxas(tree) for name, tree in trees.items()}
    entries = sorted(set().union(*regs.values()))
    differ = {e: {name: regs[name].get(e) for name in names}
              for e in entries
              if len({str(regs[name].get(e)) for name in names}) > 1}
    print(json.dumps({"ptxas": {
        "instantiations": {name: len(r) for name, r in regs.items()},
        "registers": {name: sorted({v[0] for v in r.values()})
                      for name, r in regs.items()},
        "spill_bytes": {name: sorted({v[1] for v in r.values()})
                        for name, r in regs.items()},
        "differ": differ}}), flush=True)
    print(card())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
