"""The l2n_tpu_torch slice end to end on the CPU (backend="torch"): held
against the JAX package's XLA oracle step and the sphere golden, driven
through Application, and checked for what it must refuse.

The JAX oracle step runs op by op (`jax.disable_jit`). Under jit, XLA:CPU
fuses the step and contracts a*b+c into FMAs; the Mandelbrot sky's escape
counts are chaotic at its band edges, so a one-ulp direction change moves a
sky pixel by whole 3/64 steps and a handful of such pixels dominate any
RMSE. Op by op, XLA's float32 operations are IEEE and the port performs the
same ones in the same order, so the gates of tests/test_native.py hold with
room to spare. The jitted oracle's image is the sphere golden, held below
with its own gates.
"""

import collections
import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.render.program import SphereProgram as JSphereProgram
from l2n_tpu.render.state import init_frame_state as jinit
from l2n_tpu.render.step import build_render_step as jbuild
from l2n_tpu.scene.spheres import compute_spheres as jcompute
from l2n_tpu_torch.app.application import Application
from l2n_tpu_torch.app.display import PngSequenceDisplay
from l2n_tpu_torch.camera import Camera, ControllerInput
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt_plain
from l2n_tpu_torch.ops.kernels.triangle_pt import (
    TriangleBuffers,
    triangle_pt_plain,
)
from l2n_tpu_torch.render.program import SphereProgram, TriangleProgram
from l2n_tpu_torch.render.renderer import Renderer
from l2n_tpu_torch.render.state import FrameState, init_frame_state
from l2n_tpu_torch.render.step import MultiStep, build_render_step
from l2n_tpu_torch.render.tiles import advance_offset, scheduled_tiles
from l2n_tpu_torch.scene.spheres import SphereScene, compute_spheres
from l2n_tpu_torch.utils.validate import debug_mode


def _jcfg(cfg):
    """The JAX package's config for the same settings (the port's own
    RenderConfig has the same JSON form)."""
    return JRenderConfig.from_json(cfg.to_json())


def _forget_port():
    """Drop the port's modules from sys.modules; this file keeps its own
    bindings. tests/test_aot_cache.py asserts that every loaded module
    named "l2n_tpu*" lies in the JAX package's AOT digest scope, and every
    xdist worker imports every test file, so the port (a separate package
    whose name shares that prefix) must not stay loaded."""
    for name in [m for m in sys.modules if m.startswith("l2n_tpu_torch")]:
        del sys.modules[name]


_forget_port()


@pytest.fixture(scope="module", autouse=True)
def _port_unloaded_after_module():
    # One torch thread while this module runs: the suite's workers share
    # the machine's cores, and a torch pool as wide as the machine in each
    # of them oversubscribes the cores (the JAX package's tests included).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _forget_port()


REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "sphere_pt_256x128_4spp.npz"


def _aimed_camera(cfg):
    """Between a diffuse (odd) sphere and its nearest emissive (even) one,
    looking at the diffuse one: a lit frame (tests/test_brdf.py's aim)."""
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c = np.stack([sc.center_x.numpy(), sc.center_y.numpy(),
                  sc.center_z.numpy()], 1)
    r = np.sqrt(sc.sqr_radius.numpy())
    odd, even = np.arange(1, cfg.sphere_count, 2), np.arange(0, cfg.sphere_count, 2)
    dm = np.linalg.norm(c[odd][:, None] - c[even][None], axis=2)
    oi, ei = np.unravel_index(np.argmin(dm), dm.shape)
    j, e = odd[oi], even[ei]
    to_e = (c[e] - c[j]) / np.linalg.norm(c[e] - c[j])
    eye = c[j] + to_e * 5.0 * r[j]
    vm = look_at(eye.astype(np.float32), c[j].astype(np.float32),
                 np.array([0.0, 1.0, 0.0], np.float32))
    return Camera.from_config(cfg, view_matrix=vm)


@pytest.mark.parametrize("extra", [{}, {"spp_per_step": 2, "max_bounces": 3},
                                   {"max_bounces": 1}],
                         ids=["reference", "spp2_bounces3", "bounces1"])
def test_torch_step_matches_xla_oracle(extra):
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2, **extra).validate()
    cam = _aimed_camera(cfg).packed()
    jscene = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    jstep = jbuild(_jcfg(cfg), jscene, backend="xla")
    jst = jinit(_jcfg(cfg))
    # Both packages step the same state: the JAX one, handed over as numpy.
    st = FrameState.from_numpy(np.asarray(jst.accum), np.asarray(jst.output),
                               int(jst.tile_offset), int(jst.iteration))
    scene = SphereScene.from_numpy(jscene.center_x, jscene.center_y,
                                   jscene.center_z, jscene.sqr_radius)
    step = build_render_step(cfg, scene, backend="torch", device="cpu")
    with jax.disable_jit():
        for _ in range(4):
            jst = jstep(jst, cam)
    for _ in range(4):
        st = step(st, cam)
    ja, jo = np.asarray(jst.accum), np.asarray(jst.output)
    ta, to, offset, iteration = st.to_numpy()
    assert (offset, iteration) == (int(jst.tile_offset), int(jst.iteration))
    assert (ja[:3].max(0) > 0).mean() > 0.3  # real lit coverage
    np.testing.assert_array_equal(ta[3], ja[3])  # same coverage
    rmse = np.sqrt(((ta - ja) ** 2).mean())
    assert rmse < 1e-3, f"port/oracle RMSE {rmse}"
    assert (np.abs(to - jo) > 1e-3).mean() < 2e-3


def test_torch_slice_matches_sphere_golden():
    """The golden was rendered by the jitted XLA oracle (256x128, 4
    whole-frame steps, 128 spheres); gates of tests/test_golden_render.py's
    cross-implementation checks."""
    with np.load(GOLDEN) as data:
        cfg = RenderConfig.from_json(bytes(data["config"]).decode())
        want = data["accum"]
    scene = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    step = build_render_step(cfg, scene, backend="torch", device="cpu")
    st = init_frame_state(cfg)
    cam = Camera.from_config(cfg).packed()
    for _ in range(4):
        st = step(st, cam)
    got = st.accum.numpy()
    np.testing.assert_array_equal(got[3], want[3])
    d = np.abs(got - want)
    assert (d > 1e-3).mean() < 0.03
    mean_diff = np.abs(got[:3] / np.maximum(got[3], 1)
                       - want[:3] / np.maximum(want[3], 1))
    assert np.sqrt((mean_diff ** 2).mean()) < 0.03


def test_headless_application_cpu(tmp_path):
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2)
    app = Application(cfg, workdir=tmp_path, backend="torch", device="cpu")
    display = PngSequenceDisplay(tmp_path / "frames", every=2)
    st = app.run(3, display=display)
    assert st.iteration == 3
    # one row of tiles per step over a 1x2 tile grid: rows 0-31 twice
    spp = st.accum[3, :cfg.height, :cfg.width].numpy()
    np.testing.assert_array_equal(np.unique(spp), [1.0, 2.0])
    assert np.isfinite(st.output.numpy()).all()
    pngs = sorted((tmp_path / "frames").glob("*.png"))
    assert [p.name for p in pngs] == ["frame_00000.png", "frame_00002.png"]
    assert pngs[0].read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "l2n_cache.json").exists()
    m = app.renderer.metrics()
    assert m["iteration"] == 3 and m["ms_per_step"] > 0


def test_clear_on_move_and_switch(tmp_path):
    cfg = RenderConfig(width=128, height=64, sphere_count=16)
    app = Application(cfg, workdir=tmp_path, backend="torch", device="cpu")
    moves = {1: ControllerInput(forward=True)}
    st = app.run(2, input_source=moves.get, save_camera=False)
    # frame 0 rendered, frame 1 rendered then the move cleared accum
    assert float(st.accum.abs().sum()) == 0.0
    assert float(st.output.abs().sum()) > 0.0  # display keeps stale pixels
    assert st.tile_offset == 0 and st.iteration == 2
    r = Renderer({"a": SphereProgram(cfg, backend="torch"),
                  "b": SphereProgram(cfg, backend="torch")})
    r.step(app.camera)
    r.switch("b")
    assert float(r.state.accum.abs().sum()) == 0.0 and r.current == "b"


def test_backend_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(width=128, height=64, sphere_count=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_render_step(cfg, compute_spheres(16), backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Application(cfg, backend="cuda", device="cuda")
    with pytest.raises(ValueError, match="backend"):
        build_render_step(cfg, compute_spheres(16), backend="auto")


@pytest.mark.parametrize("kw,item", [
    # Each id names the ROADMAP item that refused the setting when the
    # case was written; item None: the setting has been ported since and
    # the case builds and renders a step: tex_coords on spheres (#8), the
    # sun sky, viewproj, fast_math and the normal AOV (#9, its first
    # slice), the material modes and normal mapping (#9, its second
    # slice), NEE and MIS (#9, its third slice), fog (#9, its fourth
    # slice), the stateful rng modes (#10) and the wavefront step (#13).
    pytest.param({"aov": "tex_coords"}, None, id="kw0-#8"),
    pytest.param({"rng": "tinymt"}, None, id="kw1-#10"),
    pytest.param({"nee": True}, None, id="kw2-#9"),
    pytest.param({"material_mode": "microfacet"}, None, id="kw3-#9"),
    pytest.param({"normal_map": 0.5}, None, id="kw4-#9"),
    pytest.param({"fog_density": 0.01}, None, id="kw5-#9"),
    pytest.param({"env_mode": "sun"}, None, id="kw6-#9"),
    pytest.param({"ray_gen": "viewproj"}, None, id="kw7-#9"),
    pytest.param({"fast_math": True}, None, id="kw8-#9"),
    pytest.param({"wavefront": True}, None, id="kw9-#13"),
    pytest.param({"aov": "normal"}, None, id="kw10-#8/#9"),
    pytest.param({"nee": True, "mis": True}, None, id="kw11-#9")])
def test_unsupported_configs_raise(kw, item):
    cfg = RenderConfig(width=128, height=64, sphere_count=16, **kw)
    if item is None:
        step = build_render_step(cfg, compute_spheres(16), backend="torch")
        st = step(init_frame_state(cfg), Camera.from_config(cfg).packed())
        assert float(st.accum[3].sum()) == (cfg.effective_tiles_per_step
                                            * cfg.tile_height * cfg.tile_width)
        assert bool(torch.isfinite(st.accum).all())
        return
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        build_render_step(cfg, compute_spheres(16), backend="torch")


def test_sphere_wavefront_config_builds_and_renders():
    """RenderConfig(wavefront=True) was refused (ROADMAP Queue 1 #13) until
    the wavefront step was ported: a sphere config with it now builds and
    renders the fused step's image, bit for bit (plain versions)."""
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2)
    cam = _aimed_camera(cfg).packed()
    scene = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    accums = []
    for wavefront in (False, True):
        step = build_render_step(cfg.replace(wavefront=wavefront), scene,
                                 backend="torch")
        st = init_frame_state(cfg)
        for _ in range(2):
            st = step(st, cam)
        accums.append(st.accum.numpy())
    np.testing.assert_array_equal(accums[1], accums[0])
    assert (accums[1][:3].max(0) > 0).mean() > 0.3  # a lit frame


def test_unsupported_program_options_raise(tmp_path):
    """The explicit material and light buffers were refused (Queue 1 #9)
    until its second slice: a program with them now renders, and lights
    with wavefront=True raise ValueError, as in the JAX package."""
    from l2n_tpu_torch.scene.materials import (
        DirectionalLights,
        PhongMaterials,
        PointLights,
    )
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2)
    mats = PhongMaterials.from_arrays(
        np.array([[0.9, 0.2, 0.2, 1.0]], np.float32),
        np.zeros((1, 3), np.float32), np.zeros(1, np.float32))
    lights = dict(point_lights=PointLights.from_arrays(
        np.zeros((1, 3), np.float32), np.array([[5e7, 4e7, 3e7]], np.float32)),
        directional_lights=DirectionalLights.from_arrays(
            np.array([[0.3, -1.0, 0.2]], np.float32),
            np.array([[0.5, 0.5, 0.6]], np.float32)))
    cam = _aimed_camera(cfg).packed()
    sums = []
    for kw in ({}, {"materials": mats, **lights}):
        prog = SphereProgram(cfg, backend="torch", **kw)
        st = prog.step(init_frame_state(cfg), cam)
        assert bool(torch.isfinite(st.accum).all())
        sums.append(float(st.accum[:3].sum()))
    assert sums[1] > sums[0] > 0
    with pytest.raises(ValueError, match="wavefront"):
        SphereProgram(cfg.replace(wavefront=True), backend="torch", **lights)
    with pytest.raises(ValueError, match="wavefront"):
        SphereProgram(cfg.replace(wavefront=True), backend="torch",
                      materials=mats)
    # The texcoord AOVs were mesh-only (#8) until the sphere family took
    # them: both renderers now build and render one.
    app = Application(cfg.replace(aov="tex_coords"), workdir=tmp_path,
                      backend="torch", renderer_names=("spherePT",
                                                       "trianglePT"))
    st = app.run(1, save_camera=False)
    assert float(st.accum[3].sum()) > 0


# steps_per_call: N scheduler steps per call (render/step.py). The small
# config of the port's other tests: 64x32 in 8x8 tiles, 3 tiles per step;
# the start offset 29 of the 32-tile schedule is not a multiple of 3 and
# makes the schedule wrap inside a call.
SPC_CFG = dict(width=64, height=32, tile_width=8, tile_height=8,
               tiles_per_step=3, max_bounces=2, sphere_count=16,
               emissive_every=2, disc_lat=6, disc_long=4)


def _spc_program(family, n, **extra):
    cfg = RenderConfig(**{**SPC_CFG, **extra}).validate()
    cls = TriangleProgram if family == "triangle" else SphereProgram
    return cls(cfg, backend="torch", steps_per_call=n)


def _states_equal(a, b):
    assert (a.tile_offset, a.iteration) == (b.tile_offset, b.iteration)
    np.testing.assert_array_equal(a.accum.numpy(), b.accum.numpy())
    np.testing.assert_array_equal(a.output.numpy(), b.output.numpy())
    if a.rng_state is None:
        assert b.rng_state is None
    else:
        np.testing.assert_array_equal(a.rng_state.numpy(),
                                      b.rng_state.numpy())


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("family,extra", [
    ("sphere", {}), ("triangle", {}), ("sphere", {"wavefront": True}),
    ("sphere", {"rng": "tinymt"})],
    ids=["sphere", "triangle", "wavefront", "tinymt"])
def test_steps_per_call_equals_single_steps(family, extra, n):
    """steps_per_call=N (the device cursor's schedule, gathered once per
    call) equals N single steps of the host schedule to the bit: accum,
    output, rng_state, tile_offset and iteration (the JAX package's
    tests/test_kernels.py TestStepsPerCall)."""
    single, multi = _spc_program(family, 1, **extra), \
        _spc_program(family, n, **extra)
    cam = _aimed_camera(single.cfg).packed()
    a = dataclasses.replace(init_frame_state(single.cfg), tile_offset=29)
    b = dataclasses.replace(init_frame_state(single.cfg), tile_offset=29)
    for _ in range(2):
        b = multi.step(b, cam)
        for _ in range(n):
            a = single.step(a, cam)
        _states_equal(a, b)
    assert b.iteration == 2 * n
    assert b.tile_offset == (29 + 2 * n * 3) % 32
    assert int(multi.step.cursor[0]) == b.tile_offset
    assert float(b.accum[3].sum()) == 2 * n * 3 * 64
    assert (b.accum[:3].amax(0) > 0).float().mean() > 0.1  # lit


# Grouped steps (render/step.py: G = max(1, min(N, T // k)) steps a kernel
# call) on SPC_CFG's 32-tile frame: (k, N, start offset, the tiles of each
# kernel call). 3 x 12 runs past the frame (groups of 30 + 6 tiles); 6 x 8
# has another k that does not divide T (30 + 18); 3 x 5 from offset 31
# wraps in its first group (one group of 15).
FUSED = {"past_frame": (3, 12, 29, [30, 6]), "k_6": (6, 8, 10, [30, 18]),
         "wraps_first": (3, 5, 31, [15])}


@pytest.mark.parametrize("rng", ["threefry", "tpu_hw", "tinymt", "tauslcg"])
@pytest.mark.parametrize("family", ["sphere", "triangle"])
@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_steps_equal_single_steps(case, family, rng):
    """A call whose steps render in groups, one kernel call a group, equals
    one step at a time to the bit: accum, output, rng_state, tile_offset,
    iteration and the device cursor."""
    k, n, offset, groups = FUSED[case]
    single = _spc_program(family, 1, tiles_per_step=k, rng=rng)
    multi = _spc_program(family, n, tiles_per_step=k, rng=rng)
    g = multi.step.group
    assert [g * k] * (n // g) + [n % g * k] * (n % g > 0) == groups
    cam = _aimed_camera(single.cfg).packed()
    a = dataclasses.replace(init_frame_state(single.cfg), tile_offset=offset)
    b = multi.step(dataclasses.replace(init_frame_state(single.cfg),
                                       tile_offset=offset), cam)
    for _ in range(n):
        a = single.step(a, cam)
    _states_equal(a, b)
    assert b.iteration == n and b.tile_offset == (offset + n * k) % 32
    assert int(multi.step.cursor[0]) == b.tile_offset
    assert float(b.accum[3].sum()) == n * k * 64
    assert (b.accum[:3].amax(0) > 0).float().mean() > 0.1  # lit


def _recorded_groups(cfg, n, offset=29):
    """The tiles of each kernel call of one call of N steps, with a stand-in
    `render` that records its schedules; the schedules joined must be the
    N steps' own and each group's tiles distinct."""
    step = build_render_step(cfg, compute_spheres(cfg.sphere_count),
                             backend="torch", steps_per_call=n)
    scheds = []
    step.render = lambda sched, *planes: scheds.append(sched.clone())
    st = dataclasses.replace(init_frame_state(cfg), tile_offset=offset)
    step(st, Camera.from_config(cfg).packed())
    k = cfg.effective_tiles_per_step
    want = step.tiles[(torch.arange(n * k) + offset) % cfg.tile_count]
    assert torch.equal(torch.cat(scheds), want)
    for sched in scheds:
        ids = sched[:, 1] * cfg.tile_count_x + sched[:, 0]
        assert ids.unique().numel() == sched.shape[0]
    return [s.shape[0] for s in scheds]


@pytest.mark.parametrize("case,extra,n,groups", [
    ("fused", {}, 12, [30, 6]),
    ("debug_mode", {}, 12, [3] * 12),
    ("wavefront", {"wavefront": True}, 12, [3] * 12),
    ("whole_frame", {"tiles_per_step": 32}, 3, [32] * 3)],
    ids=["fused", "debug_mode", "wavefront", "whole_frame"])
def test_fused_steps_kernel_calls(case, extra, n, groups):
    """Each kernel call's tile count: G * k tiles a call, the last call the
    rest; one step a call under debug_mode, for the wavefront step (its
    lane buffers hold one step's tiles) and at whole frames (T // k = 1)."""
    cfg = RenderConfig(**SPC_CFG).replace(**extra).validate()
    with debug_mode() if case == "debug_mode" else contextlib.nullcontext():
        assert _recorded_groups(cfg, n) == groups


def _stand_in_graphs(monkeypatch, calls):
    """render/step.py's capture and replay stood in for on the CPU, as a
    CUDA graph runs: the capture records nothing and runs nothing, each
    replay runs the captured call anew (so it reads the step's camera
    buffer and device cursor as they are then). `calls` records them."""
    def fake_capture(fn, device):
        calls.append("capture")
        return fn, collections.Counter()

    def fake_replay(graph, held):
        calls.append("replay")
        graph()

    # render/step.py's own globals (this file keeps its own bindings of
    # the port's modules, _forget_port).
    step_globals = MultiStep.__call__.__globals__
    monkeypatch.setitem(step_globals, "capture", fake_capture)
    monkeypatch.setitem(step_globals, "replay", fake_replay)
    return step_globals


def test_steps_per_call_graph_keys(monkeypatch):
    """The card's graph cache, run on the CPU with a stand-in capture
    (_stand_in_graphs), for one step a call and for two: the first call of
    a (slab extras, buffers) key runs eagerly, the second captures, later
    ones replay, whatever the camera, which a replay reads from the step's
    camera buffer (written only when the camera's bytes change); new
    buffers drop the graph. Every call matches single steps to the bit."""
    calls = []
    step_globals = _stand_in_graphs(monkeypatch, calls)
    writes = []
    write_camera = step_globals["write_camera"]

    def counted_write(buffer, camera):
        writes.append(camera.tobytes())
        write_camera(buffer, camera)

    monkeypatch.setitem(step_globals, "write_camera", counted_write)
    single = _spc_program("sphere", 1)
    cams = [_aimed_camera(single.cfg).packed(),
            Camera.from_config(single.cfg).packed()]
    for n in (1, 2):
        multi = _spc_program("sphere", n)
        graphed = MultiStep(multi.cfg, multi.step.render, multi.step.tiles,
                            n, torch.device("cpu"), graphs=True)
        a = dataclasses.replace(init_frame_state(single.cfg), tile_offset=5)
        b = dataclasses.replace(init_frame_state(single.cfg), tile_offset=5)
        calls.clear()
        writes.clear()
        for cam, fresh in ((0, False), (0, False), (1, False), (0, False),
                           (0, False), (1, True), (1, False), (0, False)):
            if fresh:  # new buffers, e.g. a state made anew
                a = FrameState.from_numpy(*a.to_numpy())
                b = FrameState.from_numpy(*b.to_numpy())
            b = graphed(b, cams[cam])
            for _ in range(n):
                a = single.step(a, cams[cam])
            _states_equal(a, b)
        # eager, capture+replay; new cameras: replay, replay, replay; new
        # buffers: eager, capture+replay; a new camera: replay.
        assert calls == ["capture", "replay", "replay", "replay", "replay",
                         "capture", "replay", "replay"], n
        assert writes == [cams[i].tobytes() for i in (0, 1, 0, 1, 0)], n


@pytest.mark.parametrize("rng", ["threefry", "tpu_hw", "tinymt", "tauslcg"])
@pytest.mark.parametrize("family", ["sphere", "triangle"])
def test_graph_step_over_orbit_poses(monkeypatch, family, rng):
    """One step a call through the graphed path (_stand_in_graphs: the
    first call eager, then one capture, replays reading the camera buffer)
    over 6 camera poses turned 1 degree apart about the world's vertical
    axis, whole frames, equals the eager per-pose step it replaced (the
    host schedule at the state's offset, the kernel's plain version handed
    the packed host camera) to the bit."""
    calls = []
    _stand_in_graphs(monkeypatch, calls)
    prog = _spc_program(family, 1, tiles_per_step=32, rng=rng)
    cfg = prog.cfg
    graphed = MultiStep(cfg, prog.step.render, prog.step.tiles, 1,
                        torch.device("cpu"), graphs=True)
    kernel = sphere_pt_plain if family == "sphere" else triangle_pt_plain
    scene = prog.scene.packed() if family == "sphere" else \
        TriangleBuffers.from_scene(prog.scene)
    view0 = _aimed_camera(cfg).view_matrix.astype(np.float64)
    a, b = init_frame_state(cfg), init_frame_state(cfg)
    for pose in range(6):
        t = np.radians(float(pose))
        rot = np.array([[np.cos(t), 0.0, np.sin(t), 0.0], [0.0, 1.0, 0.0, 0.0],
                        [-np.sin(t), 0.0, np.cos(t), 0.0], [0.0, 0.0, 0.0, 1.0]])
        cam = Camera.from_config(
            cfg, view_matrix=(view0 @ rot.T).astype(np.float32)).packed()
        b = graphed(b, cam)
        kernel(cfg, scheduled_tiles(prog.step.tiles, a.tile_offset, 32), cam,
               scene, a.accum, a.output, a.rng_state)
        a = dataclasses.replace(a, tile_offset=advance_offset(
            cfg, a.tile_offset), iteration=a.iteration + 1)
        _states_equal(a, b)
    assert calls == ["capture"] + ["replay"] * 5
    assert float(b.accum[3].sum()) == 6 * 64 * 32
    assert (b.accum[:3].amax(0) > 0).float().mean() > 0.1  # lit


def test_step_inside_an_open_capture_runs_eagerly(monkeypatch):
    """A call made while the current stream captures (someone else's graph
    around the step, stood in for) runs its steps eagerly, so the outer
    capture records them, and writes the camera each time, the write among
    what it records (and the cursor's fill); the buffer's bytes and the
    cursor are then unknown, so the first call after the capture writes
    and fills again. Each call matches single steps."""
    calls = []
    step_globals = _stand_in_graphs(monkeypatch, calls)
    outer = [True]
    monkeypatch.setitem(step_globals, "stream_capturing", lambda d: outer[0])
    writes = []
    write_camera = step_globals["write_camera"]

    def counted_write(buffer, camera):
        writes.append(camera.tobytes())
        write_camera(buffer, camera)

    monkeypatch.setitem(step_globals, "write_camera", counted_write)
    single = _spc_program("sphere", 1)
    graphed = MultiStep(single.cfg, single.step.render, single.step.tiles, 1,
                        torch.device("cpu"), graphs=True)
    cam = _aimed_camera(single.cfg).packed()
    a, b = init_frame_state(single.cfg), init_frame_state(single.cfg)
    graph_calls = step_globals["graph_calls"]
    graph_calls.clear()
    for inside in (True, True, True, False, False, False):
        outer[0] = inside
        b = graphed(b, cam)
        a = single.step(a, cam)
        _states_equal(a, b)
        # what the host knows of the cursor and the camera after the call
        known = (graphed._cursor_at, graphed._written)
        assert known == ((None, None) if inside else (b.tile_offset,
                                                      cam.tobytes()))
    # Inside: eager three times, a write each; after: eager (the first call
    # of its key, writing again), capture+replay, replay, no more writes.
    assert calls == ["capture", "replay", "replay"]
    assert len(writes) == 4
    assert graph_calls["eager"] == 3 + 1 + 6  # the single steps' too


def test_capture_counts_launches_per_replay(monkeypatch):
    """common.capture takes back the launches counted while a graph was
    captured (a capture runs nothing) and common.replay counts them per
    replay; a capture that fails leaves the counter as it was. The CUDA
    graph is stood in for on the CPU."""
    common = MultiStep.__call__.__globals__["capture"].__globals__
    launches = common["launches"]
    replays = []

    class FakeGraph:
        def replay(self):
            replays.append(1)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    launches.clear()
    launches.update({"sphere_pt": 5})
    graph, held = common["capture"](
        lambda: launches.update({"sphere_pt": 3, "wavefront_pass_a": 3}),
        torch.device("cpu"))
    assert dict(launches) == {"sphere_pt": 5}
    assert held == {"sphere_pt": 3, "wavefront_pass_a": 3}
    for _ in range(2):
        common["replay"](graph, held)
    assert dict(launches) == {"sphere_pt": 11, "wavefront_pass_a": 6}
    assert len(replays) == 2

    def fails():
        launches.update({"triangle_pt": 1})
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        common["capture"](fails, torch.device("cpu"))
    assert dict(launches) == {"sphere_pt": 11, "wavefront_pass_a": 6}
    launches.clear()


def test_steps_per_call_matches_jax_fori_loop():
    """The port's two-step call against the JAX SphereProgram(
    steps_per_call=2, backend="xla") (lax.fori_loop) run op by op, under
    the north star's gates."""
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2).validate()
    cam = _aimed_camera(cfg).packed()
    jprog = JSphereProgram(_jcfg(cfg), backend="xla", steps_per_call=2)
    prog = SphereProgram(cfg, backend="torch", steps_per_call=2)
    jst, st = jinit(jprog.cfg), init_frame_state(cfg)
    with jax.disable_jit():
        for _ in range(2):
            jst = jprog.step(jst, cam)
    for _ in range(2):
        st = prog.step(st, cam)
    ja, jo = np.asarray(jst.accum), np.asarray(jst.output)
    ta, to, offset, iteration = st.to_numpy()
    assert (offset, iteration) == (int(jst.tile_offset), int(jst.iteration))
    assert iteration == 4
    assert (ja[:3].max(0) > 0).mean() > 0.3  # real lit coverage
    np.testing.assert_array_equal(ta[3], ja[3])
    assert np.sqrt(((ta - ja) ** 2).mean()) < 1e-3
    assert (np.abs(to - jo) > 1e-3).mean() < 2e-3


def test_metrics_per_scheduler_step():
    """Renderer.metrics divides a call's time by steps_per_call, so its
    figures stay per scheduler step."""
    r = Renderer({"spherePT": _spc_program("sphere", 4)})
    r._step_times = [0.008, 0.012]
    m = r.metrics()
    assert m["ms_per_step"] == pytest.approx(10.0 / 4)
    assert m["samples_per_sec"] == pytest.approx(3 * 64 / 2.5e-3)


SLICE_MODULES = [
    "l2n_tpu_torch", "l2n_tpu_torch.config", "l2n_tpu_torch.rng.threefry",
    "l2n_tpu_torch.rng.philox", "l2n_tpu_torch.rng.tinymt",
    "l2n_tpu_torch.rng.tauslcg", "l2n_tpu_torch.rng.tinymt_params",
    "l2n_tpu_torch.rng.state", "l2n_tpu_torch.rng.sampler",
    "l2n_tpu_torch.maths.linalg", "l2n_tpu_torch.maths.fastmath",
    "l2n_tpu_torch.maths.sampling", "l2n_tpu_torch.maths.brdf",
    "l2n_tpu_torch.maths.bump", "l2n_tpu_torch.scene.materials",
    "l2n_tpu_torch.ops.lights", "l2n_tpu_torch.ops.nee",
    "l2n_tpu_torch.ops.fog",
    "l2n_tpu_torch.camera.camera",
    "l2n_tpu_torch.camera.cache", "l2n_tpu_torch.camera.view_controller",
    "l2n_tpu_torch.scene.spheres", "l2n_tpu_torch.scene.tessellate",
    "l2n_tpu_torch.scene.obj", "l2n_tpu_torch.scene.procgen",
    "l2n_tpu_torch.render.tiles",
    "l2n_tpu_torch.render.state", "l2n_tpu_torch.ops.intersect",
    "l2n_tpu_torch.ops.scenes", "l2n_tpu_torch.ops.envlight",
    "l2n_tpu_torch.ops.pathtrace", "l2n_tpu_torch.ops.kernels.build",
    "l2n_tpu_torch.ops.kernels.common", "l2n_tpu_torch.ops.kernels.sphere_pt",
    "l2n_tpu_torch.ops.kernels.uv_demo",
    "l2n_tpu_torch.ops.kernels.philox_bits",
    "l2n_tpu_torch.ops.kernels.triangle_pack",
    "l2n_tpu_torch.ops.kernels.triangle_pt",
    "l2n_tpu_torch.ops.kernels.wavefront", "l2n_tpu_torch.render.step",
    "l2n_tpu_torch.render.program", "l2n_tpu_torch.render.renderer",
    "l2n_tpu_torch.utils.image", "l2n_tpu_torch.app.display",
    "l2n_tpu_torch.app.application", "l2n_tpu_torch.utils.validate",
    "l2n_tpu_torch.utils.profiling", "l2n_tpu_torch.utils.checkpoint",
    "l2n_tpu_torch.app.interactive", "l2n_tpu_torch.render",
    "l2n_tpu_torch.app", "l2n_tpu_torch.utils"]


def test_port_imports_without_jax():
    """The card's machine has no jax: every slice module imports with jax
    made unimportable, and no module of the JAX package is loaded (the
    port has its own config)."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "loaded = sorted(m for m in sys.modules if m == 'l2n_tpu' or "
        "m.startswith('l2n_tpu.'))\n"
        "assert loaded == [], loaded\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
