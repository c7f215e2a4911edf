"""Every rng mode of l2n_tpu_torch against the JAX package on the CPU.

Units: TinyMT32 (golden vectors, random seeds and parameter triples),
std::mt19937, the parameter table, the per-pixel state initialisers,
TausLCG (words above 2**24 included), the masked samplers and Philox.
The slice: the port's plain step with rng="tinymt" / "tauslcg" against
l2n_tpu.render.step._xla_step run op by op (jax.disable_jit; jitted
XLA:CPU contracts FMAs), on the sphere scene and a small triangle scene:
`rng_state` and `accum` bit-equal. One extra or missing draw shifts every
later sample of a pixel, so the state planes after several steps are what
catch a wrong draw consumption.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.render.state import init_frame_state as jinit
from l2n_tpu.render.step import build_render_step as jbuild
from l2n_tpu.rng import sampler as jsampler
from l2n_tpu.rng import state as jstate
from l2n_tpu.rng import tauslcg as jtauslcg
from l2n_tpu.rng import tinymt as jtinymt
from l2n_tpu.rng.tinymt_params import PARAMS_NPZ as JPARAMS_NPZ
from l2n_tpu.scene.spheres import compute_spheres as jcompute
from l2n_tpu.scene.tessellate import build_triangle_scene as jtessellate
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.render.state import FrameState, init_frame_state
from l2n_tpu_torch.render.step import build_render_step
from l2n_tpu_torch.rng import philox, sampler, state, tauslcg, tinymt
from l2n_tpu_torch.rng.threefry import uniform_oo_from_bits
from l2n_tpu_torch.rng.tinymt_params import (
    PARAMS_NPZ,
    TABLE_SIZE,
    cpp_mt19937,
    load_param_table,
)
from l2n_tpu_torch.scene.spheres import SphereScene, compute_spheres
from l2n_tpu_torch.scene.tessellate import build_triangle_scene


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


GOLDEN = json.loads((Path(__file__).parent / "golden"
                     / "tinymt32_vectors.json").read_text())


def _w(a) -> torch.Tensor:
    """uint32 numpy (or JAX) words as the port's int64 words."""
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# TinyMT
# ---------------------------------------------------------------------------

def _golden_init(case):
    params = tuple(case[k] for k in ("mat1", "mat2", "tmat"))
    return tinymt.init(torch.tensor([case["seed"]]), params)


@pytest.mark.parametrize("case", GOLDEN, ids=lambda c: f"seed{c['seed']}")
def test_tinymt_golden_init_state(case):
    status, _ = _golden_init(case)
    assert [int(s[0]) for s in status] == case["state_after_init"]


@pytest.mark.parametrize("case", GOLDEN, ids=lambda c: f"seed{c['seed']}")
def test_tinymt_golden_uint32_stream(case):
    status, params = _golden_init(case)
    got = []
    for _ in case["uint32"]:
        v, status = tinymt.generate_uint32(status, params)
        got.append(int(v[0]))
    assert got == case["uint32"]


@pytest.mark.parametrize("case", GOLDEN, ids=lambda c: f"seed{c['seed']}")
def test_tinymt_golden_float_oo_bits(case):
    status, params = _golden_init(case)
    got = []
    for _ in case["float_oo_bits"]:
        v, status = tinymt.generate_float_oo(status, params)
        got.append(int(v.numpy().view(np.uint32)[0]))
    assert got == case["float_oo_bits"]


def test_tinymt_matches_jax_on_random_streams():
    """Random seeds with random per-lane parameter triples from the table:
    init, 16 steps of uint32 and float draws, temper_conv_open, pack."""
    gen = np.random.Generator(np.random.PCG64(31))
    seeds = gen.integers(0, 2**32, 2048, dtype=np.uint32)
    tbl = load_param_table()[gen.integers(0, TABLE_SIZE, 2048)]
    jparams = tuple(jnp.asarray(tbl[:, i]) for i in range(3))
    tparams = tuple(_w(tbl[:, i]) for i in range(3))
    js, jp = jtinymt.init(jnp.asarray(seeds), jparams)
    ts, tp = tinymt.init(_w(seeds), tparams)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(_u32(b), np.asarray(a))
    np.testing.assert_array_equal(
        tinymt.temper_conv_open(ts, tp).numpy(),
        np.asarray(jtinymt.temper_conv_open(js, jp)))
    np.testing.assert_array_equal(
        _u32(tinymt.pack(ts, tp)), np.asarray(jtinymt.pack(js, jp)))
    for i in range(16):
        if i % 2:
            jv, js = jtinymt.generate_uint32(js, jp)
            tv, ts = tinymt.generate_uint32(ts, tp)
            np.testing.assert_array_equal(_u32(tv), np.asarray(jv))
        else:
            jv, js = jtinymt.generate_float_oo(js, jp)
            tv, ts = tinymt.generate_float_oo(ts, tp)
            np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                          np.asarray(jv).view(np.uint32))
    (us, up), packed = tinymt.unpack(tinymt.pack(ts, tp)), tinymt.pack(ts, tp)
    assert all(torch.equal(a, b) for a, b in zip(us, ts))
    assert packed.shape == (2048, 8) and bool((packed[:, 7] == 0).all())


def test_cpp_mt19937_knowns():
    """std::mt19937 knowns: the first output for seed 5489 and the C++
    standard's 10000th-invocation value."""
    s = cpp_mt19937(10000)
    assert s[0] == 3499211612
    assert s[9999] == 4123659995
    np.testing.assert_array_equal(cpp_mt19937(700)[:100], cpp_mt19937(100))


def test_param_table_is_a_byte_equal_copy():
    assert PARAMS_NPZ.parent.name == "rng"
    assert "l2n_tpu_torch" in PARAMS_NPZ.parts
    assert PARAMS_NPZ.read_bytes() == Path(JPARAMS_NPZ).read_bytes()
    tbl = load_param_table()
    assert tbl.shape == (TABLE_SIZE, 3) and tbl.dtype == np.uint32
    assert tuple(tbl[0]) == (0x8F7011EE, 0xFC78FF1F, 0x3793FDFF)


@pytest.mark.parametrize("shape", [(2, 3), (32, 128)], ids=["2x3", "tile"])
@pytest.mark.parametrize("mode", ["reference", "canonical", "tauslcg"])
def test_state_init_matches_jax(shape, mode):
    h, w = shape
    if mode == "tauslcg":
        want, got = jstate.init_tauslcg_states(h, w, 5), \
            state.init_tauslcg_states(h, w, 5)
    else:
        (js, jp) = jstate.init_tinymt_states(h, w, 0, param_table=mode)
        (ts, tp) = state.init_tinymt_states(h, w, 0, param_table=mode)
        want, got = js + jp, ts + tuple(torch.as_tensor(p) for p in tp)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(
            np.broadcast_to(_u32(torch.as_tensor(b)), (h, w)),
            np.broadcast_to(np.asarray(a), (h, w)))
    np.testing.assert_array_equal(
        state.mt19937_seeds(100, 3), jstate.mt19937_seeds(100, 3))


# ---------------------------------------------------------------------------
# TausLCG
# ---------------------------------------------------------------------------

def test_tauslcg_matches_jax_on_random_states():
    """Random four-word states (every word up to 2**32), 8 draws: values
    and states bit-equal, and the float conversion of words above 2**24
    (rounded, possibly to exactly 1.0) agrees."""
    gen = np.random.Generator(np.random.PCG64(32))
    words = gen.integers(0, 2**32, (4, 65536), dtype=np.uint32)
    words[:, :4] = 0xFFFFFFFF - np.arange(4, dtype=np.uint32) * 50
    js = tuple(jnp.asarray(w) for w in words)
    ts = tuple(_w(w) for w in words)
    for _ in range(8):
        jv, js = jtauslcg.rand1(js)
        tv, ts = tauslcg.rand1(ts)
        np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                      np.asarray(jv).view(np.uint32))
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(_u32(b), np.asarray(a))
    # The conversion alone, on words of every magnitude.
    x = np.concatenate([words[0], np.array(
        [2**24 - 1, 2**24 + 1, 2**24 + 3, 2**32 - 1, 2**32 - 128,
         2**32 - 129], np.uint32)])
    conv = _w(x).to(torch.float32).numpy()
    np.testing.assert_array_equal(conv, x.astype(np.float32))
    np.testing.assert_array_equal(conv, np.asarray(
        jnp.asarray(x).astype(jnp.float32)))
    assert conv[-3] == conv[-2] == 2.0**32  # rounded up: the draw is 1.0
    assert conv[-1] < 2.0**32


def test_tauslcg_init_matches_jax():
    seeds = np.random.Generator(np.random.PCG64(33)).integers(
        0, 2**32, 4096, dtype=np.uint32)
    for a, b in zip(jtauslcg.init(jnp.asarray(seeds)), tauslcg.init(_w(seeds))):
        np.testing.assert_array_equal(_u32(b), np.asarray(a))


# ---------------------------------------------------------------------------
# Masked samplers (tests/test_rng.py TestSamplers)
# ---------------------------------------------------------------------------

class _LaneMasked:
    """The counterpart of l2n_tpu.rng.sampler.MaskedSampler over a port
    sampler: a lane mask anded into every draw's mask. The port's plain
    step needs none (it gathers the scheduled pixels' states), so it lives
    here, to hold the port's masked draws against the JAX package's."""

    def __init__(self, inner, lane_mask):
        self._inner, self._mask = inner, lane_mask

    def _and(self, mask):
        return self._mask if mask is None else mask & self._mask

    def draw2(self, mask=None):
        return self._inner.draw2(self._and(mask))

    def draw1(self, mask=None):
        return self._inner.draw1(self._and(mask))

    def final_state(self):
        return self._inner.final_state()


def test_masked_tinymt_advances_only_masked_lanes():
    status, params = state.init_tinymt_states(1, 8, seed=3)
    s = sampler.TinyMTSampler(status, params)
    mask = torch.tensor([[True, False] * 4])
    s.draw1(mask=mask)
    stepped = s.final_state()
    for w_new, w_old in zip(stepped, status):
        assert torch.equal(w_new[0, 1::2], w_old[0, 1::2])
    assert (stepped[3][0, 0::2] != status[3][0, 0::2]).all()


def test_masked_sampler_combines_masks():
    status, params = state.init_tinymt_states(1, 4, seed=5)
    m = _LaneMasked(sampler.TinyMTSampler(status, params),
                    torch.tensor([[True, True, False, False]]))
    m.draw1(mask=torch.tensor([[True, False, True, False]]))
    changed = m.final_state()[3] != status[3]
    assert changed[0].tolist() == [True, False, False, False]


@pytest.mark.parametrize("mode", ["tinymt", "tauslcg"])
def test_masked_draws_match_jax(mode):
    """draw2 / draw1 under masks: values (0.5 off the mask) and stepped
    states bit-equal with the JAX samplers."""
    if mode == "tinymt":
        js, jp = jstate.init_tinymt_states(4, 64, 9)
        ts, tp = state.init_tinymt_states(4, 64, 9)
        jsm = jsampler.TinyMTSampler(js, jp)
        tsm = sampler.TinyMTSampler(ts, tp)
    else:
        jsm = jsampler.TausLCGSampler(jstate.init_tauslcg_states(4, 64, 9))
        tsm = sampler.TausLCGSampler(state.init_tauslcg_states(4, 64, 9))
    gen = np.random.Generator(np.random.PCG64(34))
    lane = gen.random((4, 64)) < 0.7
    jm = jsampler.MaskedSampler(jsm, jnp.asarray(lane))
    tm = _LaneMasked(tsm, torch.from_numpy(lane))
    for call in ("draw2", "draw1", "draw1", "draw2", "draw1"):
        mask = gen.random((4, 64)) < 0.5
        j = getattr(jm, call)(mask=jnp.asarray(mask))
        t = getattr(tm, call)(mask=torch.from_numpy(mask))
        j = j if isinstance(j, tuple) else (j,)
        t = t if isinstance(t, tuple) else (t,)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jm.final_state(), tm.final_state()):
        np.testing.assert_array_equal(_u32(b), np.asarray(a))


# ---------------------------------------------------------------------------
# Philox (rng="tpu_hw")
# ---------------------------------------------------------------------------

def test_philox_known_answers():
    """Random123's known answers for Philox4x32-10 (kat_vectors): key 0,
    counter 0, and key/counter all ones (0xffffffff)."""
    z = torch.zeros(1, dtype=torch.int64)
    got = [int(w[0]) for w in philox.philox4x32(0, 0, z, 0, 0, 0)]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    got = [int(w[0]) for w in philox.philox4x32(0xFFFFFFFF, 0xFFFFFFFF,
                                                 f, f, f, f)]
    assert got == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def test_philox_mulhilo_exact():
    gen = np.random.Generator(np.random.PCG64(35))
    b = gen.integers(0, 2**32, 100_000, dtype=np.uint64)
    b[:3] = [0, 1, 2**32 - 1]
    for a in (philox.M0, philox.M1, 0xFFFFFFFF, 1):
        hi, lo = philox.mulhilo32(a, torch.from_numpy(b.astype(np.int64)))
        prod = [int(a) * int(x) for x in b[:1000]]
        assert hi[:1000].tolist() == [p >> 32 for p in prod]
        assert lo[:1000].tolist() == [p & 0xFFFFFFFF for p in prod]
        want_lo = (b * np.uint64(a)) & np.uint64(0xFFFFFFFF)
        np.testing.assert_array_equal(lo.numpy(), want_lo.astype(np.int64))


def test_philox_sampler_addressing():
    """Pair k of sample s is words 2 (k & 1), 2 (k & 1) + 1 of block
    (pixel, s, k >> 1, 0); draw1 caches the spare word; `resumed` picks
    the stream up mid-sample; the budget holds."""
    pix = torch.arange(4096, dtype=torch.int64) * 7
    samp = torch.arange(4096, dtype=torch.int64) % 5
    s = sampler.PhiloxSampler(11, 3, pix, samp, 6)
    got = [s.draw2(), s.draw1(), s.draw1(), s.draw2(), s.draw1()]
    blocks = [philox.philox4x32(11, 3, pix, samp, j, 0) for j in range(2)]
    u = [torch.stack([uniform_oo_from_bits(w) for w in b]) for b in blocks]
    want = [(u[0][0], u[0][1]), u[0][2], u[0][3], (u[1][0], u[1][1]),
            u[1][2]]
    for g, w in zip(got, want):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    assert s.draw_position == (4, True)
    r = sampler.PhiloxSampler.resumed(11, 3, pix, samp, 6, 4, True)
    assert torch.equal(r.draw1(), u[1][3])
    r.draw2()
    r.draw2()
    with pytest.raises(RuntimeError, match="budget"):
        r.draw2()


# ---------------------------------------------------------------------------
# The slice against the JAX oracle step
# ---------------------------------------------------------------------------

def _jcfg(cfg):
    return JRenderConfig.from_json(cfg.to_json())


def _aimed_sphere_view(cfg):
    """Between a diffuse (odd) sphere and its nearest emissive (even) one,
    looking at the diffuse one: a lit frame."""
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


def _tri_view(cfg):
    """Up close at the emissive sphere 0 (tests/test_kernels.py)."""
    sp = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c0 = np.array([float(sp.center_x[0]), float(sp.center_y[0]),
                   float(sp.center_z[0])], np.float32)
    r0 = float(np.sqrt(float(sp.sqr_radius[0])))
    return look_at(c0 + np.array([0.0, 0.0, 2.5 * r0], np.float32), c0,
                   np.array([0.0, 1.0, 0.0], np.float32))


def _against_oracle(cfg, steps):
    """The port's plain step and the JAX oracle step from the JAX initial
    state; returns (port FrameState, JAX FrameState)."""
    if cfg.scene_kind == "sphere":
        view = _aimed_sphere_view(cfg)
        jscene = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
        scene = SphereScene.from_numpy(jscene.center_x, jscene.center_y,
                                       jscene.center_z, jscene.sqr_radius)
    else:
        view = _tri_view(cfg)
        jscene = jtessellate(jcompute(cfg.sphere_count, cfg.world_size,
                                      cfg.scene_seed),
                             cfg.disc_lat, cfg.disc_long)
        scene = build_triangle_scene(compute_spheres(
            cfg.sphere_count, cfg.world_size, cfg.scene_seed),
            cfg.disc_lat, cfg.disc_long)
    cam = Camera.from_config(cfg, view).packed()
    jstep = jbuild(_jcfg(cfg), jscene, backend="xla")
    jst = jinit(_jcfg(cfg))
    st = FrameState.from_numpy(np.asarray(jst.accum), np.asarray(jst.output),
                               rng_state=np.asarray(jst.rng_state))
    step = build_render_step(cfg, scene, backend="torch")
    with jax.disable_jit():
        for _ in range(steps):
            jst = jstep(jst, cam)
    for _ in range(steps):
        st = step(st, cam)
    return st, jst


def _assert_bit_equal(st, jst, cfg):
    np.testing.assert_array_equal(st.rng_state.numpy().view(np.uint32),
                                  np.asarray(jst.rng_state))
    ja = np.asarray(jst.accum)
    np.testing.assert_array_equal(st.accum.numpy(), ja)
    np.testing.assert_allclose(st.output.numpy(), np.asarray(jst.output),
                               rtol=0, atol=1e-5)  # kernel-form tonemap
    assert (st.tile_offset, st.iteration) == (int(jst.tile_offset),
                                              int(jst.iteration))
    lit = (ja[:3, :cfg.height, :cfg.width].max(0) > 0).mean()
    assert lit > 0.05, lit


@pytest.mark.parametrize("mode", ["tinymt", "tauslcg"])
@pytest.mark.parametrize("extra", [{}, {"spp_per_step": 2, "max_bounces": 3},
                                   {"max_bounces": 1}],
                         ids=["reference", "spp2_bounces3", "bounces1"])
def test_stateful_step_matches_xla_oracle(mode, extra):
    cfg = RenderConfig(width=128, height=64, sphere_count=16,
                       emissive_every=2, rng=mode, **extra).validate()
    st, jst = _against_oracle(cfg, 3)
    _assert_bit_equal(st, jst, cfg)


@pytest.mark.parametrize("mode", ["tinymt", "tauslcg"])
def test_stateful_triangle_step_matches_xla_oracle(mode):
    """One step of two samples, so the state chains from sample to sample,
    at one bounce: the jitter, the diffuse vertex's draws and the drawless
    any-hit segment (the JAX triangle oracle op by op takes ~15 s a step
    at this depth, twice that at two bounces; the sphere oracle tests take
    the deeper paths)."""
    cfg = RenderConfig(width=128, height=32, sphere_count=8, disc_lat=8,
                       disc_long=4, scene_kind="triangle", spp_per_step=2,
                       max_bounces=1, rng=mode).validate()
    st, jst = _against_oracle(cfg, 1)
    _assert_bit_equal(st, jst, cfg)


@pytest.mark.parametrize("mode", ["tinymt", "tauslcg"])
def test_unscheduled_pixels_keep_their_state(mode):
    """Only the scheduled tiles' pixels draw (the counterpart of
    tests/test_render.py's tinymt step test); clearing the accumulation
    leaves the states alone."""
    from l2n_tpu_torch.render.state import clear_accumulation
    cfg = RenderConfig(width=256, height=64, sphere_count=8, tiles_per_step=1,
                       rng=mode).validate()
    step = build_render_step(cfg, compute_spheres(8), backend="torch")
    st = init_frame_state(cfg)
    before = st.rng_state.clone()
    st = step(st, Camera.from_config(cfg).packed())
    mask = st.accum[3] > 0
    assert 0 < int(mask.sum()) < mask.numel()
    assert (before[:4, mask] != st.rng_state[:4, mask]).any(0).all()
    assert torch.equal(before[:, ~mask], st.rng_state[:, ~mask])
    after = st.rng_state.clone()
    st = clear_accumulation(st)
    assert float(st.accum.abs().sum()) == 0.0
    assert torch.equal(st.rng_state, after)


@pytest.mark.parametrize("mode", ["tinymt", "tauslcg", "tpu_hw"])
def test_cli_config_renders_every_rng_mode(mode, tmp_path):
    """The path a user reaches with `--config` holding "rng": m (plain
    versions here; backend="cuda" on the card): both renderers render it,
    and the Application's state carries the mode's planes across a
    renderer switch and a camera move, which clear only the accumulation."""
    from l2n_tpu_torch.app.application import Application, main
    cfg = RenderConfig(width=128, height=64, sphere_count=8, disc_lat=8,
                       disc_long=4, rng=mode)
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    assert json.loads(path.read_text())["rng"] == mode
    for renderer in ("spherePT", "trianglePT"):
        out = tmp_path / renderer
        assert main(["--config", str(path), "--frames", "2", "--out",
                     str(out), "--every", "1", "--backend", "torch",
                     "--renderer", renderer]) == 0
        assert len(list(out.glob("*.png"))) == 2
    app = Application(cfg, workdir=tmp_path, backend="torch")
    st = app.run(2, save_camera=False)
    planes = None if st.rng_state is None else st.rng_state.clone()
    assert (planes is None) == (mode == "tpu_hw")
    app.switch_renderer("trianglePT")
    app.renderer.on_camera_moved()
    st = app.renderer.state
    assert float(st.accum.abs().sum()) == 0.0
    if planes is not None:
        assert torch.equal(st.rng_state, planes)
        st = app.run(1, save_camera=False)
        assert not torch.equal(st.rng_state, planes)
