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

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from l2n_tpu.config import RenderConfig
from l2n_tpu.render.state import init_frame_state as jinit
from l2n_tpu.render.step import build_render_step as jbuild
from l2n_tpu.scene.spheres import compute_spheres as jcompute
from l2n_tpu_torch.app.application import Application
from l2n_tpu_torch.app.display import PngSequenceDisplay
from l2n_tpu_torch.camera import Camera, ControllerInput
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.render.program import SphereProgram
from l2n_tpu_torch.render.renderer import Renderer
from l2n_tpu_torch.render.state import FrameState, init_frame_state
from l2n_tpu_torch.render.step import build_render_step
from l2n_tpu_torch.scene.spheres import SphereScene, compute_spheres


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
    yield
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
    jstep = jbuild(cfg, jscene, backend="xla")
    jst = jinit(cfg)
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
    ({"aov": "tex_coords"}, "#8"), ({"rng": "tinymt"}, "#10"),
    ({"nee": True}, "#9"), ({"material_mode": "microfacet"}, "#9"),
    ({"normal_map": 0.5}, "#9"), ({"fog_density": 0.01}, "#9"),
    ({"env_mode": "sun"}, "#9"), ({"ray_gen": "viewproj"}, "#9"),
    ({"fast_math": True}, "#9"), ({"wavefront": True}, "#13"),
    # the id predates the triangle family, when this AOV was "#8/#9"
    pytest.param({"aov": "normal"}, "#9", id="kw10-#8/#9")])
def test_unsupported_configs_raise(kw, item):
    cfg = RenderConfig(width=128, height=64, sphere_count=16, **kw)
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        build_render_step(cfg, compute_spheres(16), backend="torch")


def test_unsupported_program_options_raise(tmp_path):
    cfg = RenderConfig(width=128, height=64, sphere_count=16)
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        SphereProgram(cfg, backend="torch", point_lights=[])
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        Application(cfg.replace(aov="tex_coords"), workdir=tmp_path,
                    backend="torch", renderer_names=("spherePT", "trianglePT"))


SLICE_MODULES = [
    "l2n_tpu_torch", "l2n_tpu_torch.rng.threefry", "l2n_tpu_torch.rng.sampler",
    "l2n_tpu_torch.maths.linalg", "l2n_tpu_torch.maths.fastmath",
    "l2n_tpu_torch.maths.sampling", "l2n_tpu_torch.camera.camera",
    "l2n_tpu_torch.camera.cache", "l2n_tpu_torch.camera.view_controller",
    "l2n_tpu_torch.scene.spheres", "l2n_tpu_torch.scene.tessellate",
    "l2n_tpu_torch.scene.obj", "l2n_tpu_torch.scene.procgen",
    "l2n_tpu_torch.render.tiles",
    "l2n_tpu_torch.render.state", "l2n_tpu_torch.ops.intersect",
    "l2n_tpu_torch.ops.scenes", "l2n_tpu_torch.ops.envlight",
    "l2n_tpu_torch.ops.pathtrace", "l2n_tpu_torch.ops.kernels.build",
    "l2n_tpu_torch.ops.kernels.common", "l2n_tpu_torch.ops.kernels.sphere_pt",
    "l2n_tpu_torch.ops.kernels.uv_demo",
    "l2n_tpu_torch.ops.kernels.triangle_pack",
    "l2n_tpu_torch.ops.kernels.triangle_pt", "l2n_tpu_torch.render.step",
    "l2n_tpu_torch.render.program", "l2n_tpu_torch.render.renderer",
    "l2n_tpu_torch.utils.image", "l2n_tpu_torch.app.display",
    "l2n_tpu_torch.app.application"]


def test_port_imports_without_jax():
    """The card's machine has no jax: every slice module imports with jax
    made unimportable, and the only l2n_tpu modules loaded are the package
    root and its config."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "loaded = sorted(m for m in sys.modules if m == 'l2n_tpu' or "
        "m.startswith('l2n_tpu.'))\n"
        "assert loaded == ['l2n_tpu', 'l2n_tpu.config'], loaded\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
