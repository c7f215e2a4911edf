"""l2n_tpu_torch's session checkpoints, profiling and validation on the CPU
(backend="torch"): held against the JAX package's utils/checkpoint.py,
utils/profiling.py and utils/validate.py.

Sessions move both ways. A session saved by one package resumes in the
other, and the continued render meets the north star's gates against the
other package's uninterrupted one (the JAX step run op by op, as in
tests/test_torch_render.py, whose module doc says why); within the port,
resume is bit-exact.
"""

import logging
import sys

import numpy as np
import jax
import pytest
import torch

from l2n_tpu.app.application import Application as JApplication
from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.render.state import FrameState as JFrameState
from l2n_tpu.utils.checkpoint import load_session as jload_session
from l2n_tpu.utils.checkpoint import save_session as jsave_session
from l2n_tpu.utils.profiling import StepTimer as JStepTimer
from l2n_tpu.utils.profiling import log_metrics as jlog_metrics
from l2n_tpu.utils.validate import rmse_vs_oracle as jrmse_vs_oracle
from l2n_tpu_torch.app.application import Application
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.render.state import init_frame_state
from l2n_tpu_torch.render.step import build_render_step
from l2n_tpu_torch.scene.spheres import compute_spheres
from l2n_tpu_torch.utils.checkpoint import load_session, save_session
from l2n_tpu_torch.utils.profiling import log_metrics, trace
from l2n_tpu_torch.utils.validate import (
    check_frame_state,
    debug_mode,
    rmse_vs_oracle,
)


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


# The small config of tests/test_app.py: 128x64, one 128x32 tile per step.
CFG = RenderConfig(width=128, height=64, tile_width=128, tile_height=32,
                   sphere_count=16, emissive_every=2,
                   tiles_per_step=1).validate()


def _aimed_view(cfg):
    """Between a diffuse (odd) sphere and its nearest emissive (even) one,
    looking at the diffuse one: a lit frame (tests/test_torch_render.py's
    aim), as a view matrix."""
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
    return look_at(eye.astype(np.float32), c[j].astype(np.float32),
                   np.array([0.0, 1.0, 0.0], np.float32))


def _app(tmp_path, cfg=CFG):
    app = Application(cfg, workdir=tmp_path, backend="torch", device="cpu",
                      renderer_names=("spherePT",))
    app.controller.set_view_matrix(_aimed_view(cfg))
    return app


def _japp(tmp_path, cfg=CFG):
    app = JApplication(JRenderConfig.from_json(cfg.to_json()),
                       workdir=tmp_path, backend="xla",
                       renderer_names=("spherePT",))
    app.controller.set_view_matrix(_aimed_view(cfg))
    return app


def _north_star(got, want):
    """The north star's gates of the port's tests: the same coverage, a lit
    frame, accum RMSE < 1e-3 and output flips (|d| > 1e-3) < 0.2%."""
    ga, go = (np.asarray(x) for x in got)
    wa, wo = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ga[3], wa[3])
    assert (wa[:3].max(0) > 0).mean() > 0.3
    assert np.sqrt(((ga - wa) ** 2).mean()) < 1e-3
    assert (np.abs(go - wo) > 1e-3).mean() < 2e-3


@pytest.mark.parametrize("rng", ["threefry", "tinymt"])
def test_port_resume_bit_exact(tmp_path, rng):
    cfg = CFG.replace(rng=rng)
    app = _app(tmp_path, cfg)
    app.run(3, save_camera=False)
    path = app.save_session(tmp_path / "session.npz")
    live = app.renderer.state
    resumed = _app(tmp_path, cfg)
    resumed.controller.set_view_matrix(np.eye(4, dtype=np.float32))
    buffers = resumed.renderer.state.accum.data_ptr()
    resumed.load_session(path)
    # Loaded in place: the live buffers (a step graph's) keep their address.
    assert resumed.renderer.state.accum.data_ptr() == buffers
    np.testing.assert_array_equal(resumed.controller.view_matrix,
                                  app.controller.view_matrix)
    assert (resumed.renderer.state.tile_offset,
            resumed.renderer.state.iteration) == (live.tile_offset, 3)
    cont = resumed.run(2, save_camera=False)
    ref = app.run(2, save_camera=False)
    assert cont.iteration == ref.iteration == 5
    np.testing.assert_array_equal(cont.accum.numpy(), ref.accum.numpy())
    np.testing.assert_array_equal(cont.output.numpy(), ref.output.numpy())
    if rng == "tinymt":
        np.testing.assert_array_equal(cont.rng_state.numpy(),
                                      ref.rng_state.numpy())


def test_session_file_matches_jax(tmp_path):
    """The same state saved by both packages: the same keys in the same
    order, dtypes, shapes, config bytes and values; the tinymt planes as
    uint32."""
    cfg = CFG.replace(rng="tinymt")
    app = _app(tmp_path, cfg)
    app.run(1, save_camera=False)
    st = app.renderer.state
    view = app.controller.view_matrix
    ours = save_session(tmp_path / "port.npz", cfg, st, view)
    jst = JFrameState(accum=jax.numpy.asarray(st.accum.numpy()),
                      output=jax.numpy.asarray(st.output.numpy()),
                      tile_offset=jax.numpy.int32(st.tile_offset),
                      iteration=jax.numpy.int32(st.iteration),
                      rng_state=jax.numpy.asarray(
                          st.rng_state.numpy().view(np.uint32)))
    theirs = jsave_session(tmp_path / "jax.npz",
                           JRenderConfig.from_json(cfg.to_json()), jst, view)
    with np.load(ours) as a, np.load(theirs) as b:
        assert a.files == b.files
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            assert a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key])
        assert a["rng_state"].dtype == np.uint32
    # Each package reads the other's file back to the same state.
    _, back, _ = load_session(theirs, device="cpu")
    np.testing.assert_array_equal(back.rng_state.numpy(),
                                  st.rng_state.numpy())
    _, jback, jview = jload_session(ours)
    np.testing.assert_array_equal(np.asarray(jback.rng_state),
                                  st.rng_state.numpy().view(np.uint32))
    np.testing.assert_array_equal(jview, view)


def test_jax_session_resumes_in_port(tmp_path):
    """JAX -> port: a JAX session saved after 2 steps resumes in the port
    for 2 more; the north star's gates against the JAX render's own 4."""
    japp = _japp(tmp_path)
    with jax.disable_jit():
        japp.run(2, save_camera=False)
        path = japp.save_session(tmp_path / "jax.npz")
        jfull = japp.run(2, save_camera=False)
    app = _app(tmp_path)
    app.load_session(path)
    st = app.run(2, save_camera=False)
    assert (st.tile_offset, st.iteration) == (int(jfull.tile_offset),
                                              int(jfull.iteration))
    _north_star((st.accum, st.output), (jfull.accum, jfull.output))


def test_port_session_resumes_in_jax(tmp_path):
    """port -> JAX: a port session saved after 2 steps resumes in the JAX
    package for 2 more; the north star's gates against the port's own 4."""
    app = _app(tmp_path)
    app.run(2, save_camera=False)
    path = app.save_session(tmp_path / "port.npz")
    full = app.run(2, save_camera=False)
    japp = _japp(tmp_path)
    japp.load_session(path)
    with jax.disable_jit():
        jst = japp.run(2, save_camera=False)
    assert (int(jst.tile_offset), int(jst.iteration)) == (full.tile_offset,
                                                          full.iteration)
    _north_star((jst.accum, jst.output), (full.accum, full.output))


def test_session_config_mismatch_rejected(tmp_path):
    app = _app(tmp_path)
    path = app.save_session(tmp_path / "s.npz")
    other = _app(tmp_path, CFG.replace(seed=99))
    before = other.renderer.state.accum.clone()
    with pytest.raises(ValueError, match="config"):
        other.load_session(path)
    jpath = _japp(tmp_path, CFG.replace(seed=99)).save_session(
        tmp_path / "j.npz")
    with pytest.raises(ValueError, match="config"):
        app.load_session(jpath)
    assert torch.equal(other.renderer.state.accum, before)


def test_log_metrics_matches_jax(caplog):
    """The port's metrics log line is the JAX package's, letter for letter,
    for the JAX StepTimer's figures."""
    timer = JStepTimer(window=4)
    timer.times = [0.010, 0.012, 0.0095, 0.011, 0.013, 0.0105]
    metrics = timer.metrics(samples_per_step=40960, pixels=921600,
                            mean_segments=1.25)
    with caplog.at_level(logging.INFO):
        log_metrics(32, metrics)
        jlog_metrics(32, metrics)
    assert len(caplog.records) == 2
    assert caplog.records[0].getMessage() == caplog.records[1].getMessage()
    assert caplog.records[0].name == "l2n_tpu_torch.metrics"


def test_trace_writes_chrome_trace(tmp_path):
    with trace(tmp_path / "trace") as log_dir:
        torch.ones(8).sum()
    assert (log_dir / "trace.json").stat().st_size > 0


def test_check_frame_state_finds_nan_inf_negative():
    st = init_frame_state(CFG)
    assert check_frame_state(st).ok
    st.accum[0, 0, 0] = float("nan")
    st.accum[1, 2, 3] = float("inf")
    st.output[2, 1, 1] = float("-inf")
    st.accum[3, 5, 5] = -1.0
    report = check_frame_state(st)
    assert not report.ok
    assert (report.nan_count, report.inf_count,
            report.negative_samples) == (1, 2, 1)


def test_debug_mode_audits_steps():
    """Under debug_mode a step that leaves a NaN, an Inf or a negative
    count in the frame state raises; clean steps run (on the CPU the
    launches it checks do not happen: the plain path has none)."""
    cfg = CFG
    step = build_render_step(cfg, compute_spheres(16), backend="torch")
    multi = build_render_step(cfg, compute_spheres(16), backend="torch",
                              steps_per_call=2)
    cam = Camera.from_config(cfg).packed()
    with debug_mode():
        st = multi(step(init_frame_state(cfg), cam), cam)
        assert st.iteration == 3
        for poison in (float("nan"), float("inf"), -5.0):
            bad = init_frame_state(cfg)
            bad.accum[3, 0, 0] = poison  # stays after 1 or 2 samples
            for fn in (step, multi):
                with pytest.raises(FloatingPointError):
                    fn(bad, cam)
    step(bad, cam)  # outside debug_mode nothing is audited


def test_rmse_vs_oracle_keys_match_jax():
    """The port's rmse_vs_oracle against its oracle (backend="torch" twice:
    zero difference) returns the JAX function's keys; backend="cuda"
    without a card raises."""
    scene = compute_spheres(8, CFG.world_size, CFG.scene_seed)
    cfg = CFG.replace(sphere_count=8)
    got = rmse_vs_oracle(cfg, scene, steps=2, backend="torch")
    assert got == {"rmse": 0.0, "max_abs": 0.0, "diverging_fraction": 0.0,
                   "coverage_match": True}
    from l2n_tpu.scene.spheres import compute_spheres as jcompute
    jcfg = JRenderConfig.from_json(cfg.to_json())
    want = jrmse_vs_oracle(jcfg, jcompute(8, jcfg.world_size,
                                          jcfg.scene_seed),
                           steps=1, backend="xla")
    assert got.keys() == want.keys()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rmse_vs_oracle(cfg, scene, steps=1, backend="cuda")
