"""The primary-only AOVs, the sun sky, ray_gen="viewproj" and fast_math of
l2n_tpu_torch against the JAX package on the CPU.

Units: sun_le against the JAX sky, fast_sqrt (NaN at 0 and below), the
viewproj camera rays against the fovy ones (within 2e-3, as
tests/test_oracle.py holds the JAX pair).
The slice: the port's plain step (backend="torch") against
l2n_tpu.render.step._xla_step run op by op (jax.disable_jit; jitted
XLA:CPU contracts FMAs, tests/test_torch_render.py), the state handed over
as numpy, for each new setting on the sphere scene (128x64, 16 spheres)
and a small triangle scene (4 spheres of 32 triangles, 128x32), in every rng
mode the XLA oracle accepts (threefry, tinymt, tauslcg; wavefront=True
takes the stateless ones only). One parity function holds every case to
the north star's gates (accum[3] equal, accum RMSE < 1e-3, output
|d| > 1e-3 on fewer than 2e-3 of the values), or, with fast_math, to the
JAX package's fast-math gates (tests/test_kernels.py TestFastMath: the
same, with fewer than 1e-3 of the values flipped), plus the stateful
modes' state planes bit-equal and a lit-coverage gate in every case: the
sun cases look along the sun's direction, so the sky they compare is lit.
"""

from __future__ import annotations

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.ops.envlight import sun_le as jsun_le
from l2n_tpu.ops.intersect import fast_sqrt as jfast_sqrt
from l2n_tpu.render.state import init_frame_state as jinit
from l2n_tpu.render.step import build_render_step as jbuild
from l2n_tpu.scene.spheres import compute_spheres as jcompute
from l2n_tpu.scene.tessellate import build_triangle_scene as jtessellate
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.maths.sampling import fast_sqrt
from l2n_tpu_torch.ops.envlight import SUN_S, sun_le
from l2n_tpu_torch.ops.pathtrace import generate_rays
from l2n_tpu_torch.render.state import FrameState
from l2n_tpu_torch.render.step import build_render_step
from l2n_tpu_torch.scene.spheres import SphereScene, compute_spheres
from l2n_tpu_torch.scene.tessellate import build_triangle_scene


def _forget_port():
    """Drop the port's modules from sys.modules; this file keeps its own
    bindings (tests/test_aot_cache.py scans every loaded l2n_tpu* module)."""
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


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------

def test_sun_le_matches_jax():
    gen = np.random.Generator(np.random.PCG64(31))
    d = gen.normal(size=(3, 20_000)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    d[:, :2000] = (np.float32(SUN_S) * np.array([1, 1, -1], np.float32)[:, None]
                   + 0.05 * d[:, :2000])  # near the sun: a lit lobe
    d = d.astype(np.float32)
    got = sun_le(*(torch.from_numpy(a) for a in d)).numpy()
    want = np.asarray(jsun_le(*(jnp.asarray(a) for a in d)))
    # Equal but for subnormals: XLA:CPU flushes them to 0, torch (and the
    # card without fast math) keeps them.
    tiny = np.finfo(np.float32).tiny
    normal = np.abs(got) >= tiny
    np.testing.assert_array_equal(got[normal], want[normal])
    assert (want[~normal] == 0).all() and (got[~normal] < tiny).all()
    assert (got > 1e-3).sum() > 500 and (got == 0).sum() > 5000


def test_fast_sqrt_poisons_zero_and_below():
    x = torch.tensor([1e-8, 0.5, 1.0, 2.0, 1e6, 3e30], dtype=torch.float32)
    np.testing.assert_allclose(fast_sqrt(x).numpy(), np.sqrt(x.numpy()),
                               rtol=3e-7)
    bad = fast_sqrt(torch.tensor([-1.0, 0.0, -0.0], dtype=torch.float32))
    assert torch.isnan(bad).all()
    want = np.asarray(jfast_sqrt(jnp.asarray([-1.0, 0.0], jnp.float32)))
    assert np.isnan(want).all()


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast_math"])
def test_viewproj_rays_match_fovy(fast):
    """Both camera forms give the same rays within 2e-3 (the JAX pair's
    tolerance, tests/test_oracle.py), with and without the fast normalize;
    and each form equals the JAX package's rays (float32, 1e-6)."""
    cfg = RenderConfig(width=128, height=96, fast_math=fast).validate()
    cam = Camera.from_config(cfg).packed()
    gen = np.random.Generator(np.random.PCG64(32))
    px = gen.integers(0, 128, 500).astype(np.float32)
    py = gen.integers(0, 96, 500).astype(np.float32)
    u, v = gen.random((2, 500), dtype=np.float32)
    from l2n_tpu.ops.pathtrace import generate_rays as jgenerate_rays
    rays = {}
    for form in ("fovy", "viewproj"):
        c = cfg.replace(ray_gen=form)
        got = generate_rays(c, torch.from_numpy(cam), *(torch.from_numpy(a)
                                                        for a in (px, py, u, v)))
        want = jgenerate_rays(JRenderConfig.from_json(c.to_json()),
                              jnp.asarray(cam),
                              *(jnp.asarray(a) for a in (px, py, u, v)))
        for g, w in zip(got[3:], want[3:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)
        rays[form] = [g.numpy() for g in got[3:]]
    for a, b in zip(rays["fovy"], rays["viewproj"]):
        np.testing.assert_allclose(a, b, atol=2e-3)
    assert max(np.abs(a - b).max() for a, b in zip(rays["fovy"],
                                                   rays["viewproj"])) > 0


# ---------------------------------------------------------------------------
# The slice against the JAX oracle step
# ---------------------------------------------------------------------------

SUN = np.array([1.0, 1.0, -1.0]) / np.sqrt(3.0)


def _view(cfg, along_sun: bool):
    """A lit view: from between a diffuse (odd) sphere and its nearest
    emissive (even) one at the diffuse one (spheres), or up close at the
    emissive sphere 0 (meshes); `along_sun` looks at that sphere along the
    sun's direction instead, so the misses around it see the sun lobe."""
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c = np.stack([sc.center_x.numpy(), sc.center_y.numpy(),
                  sc.center_z.numpy()], 1).astype(np.float64)
    r = np.sqrt(sc.sqr_radius.numpy().astype(np.float64))
    if cfg.scene_kind == "sphere":
        odd = np.arange(1, cfg.sphere_count, 2)
        even = np.arange(0, cfg.sphere_count, 2)
        dm = np.linalg.norm(c[odd][:, None] - c[even][None], axis=2)
        oi, ei = np.unravel_index(np.argmin(dm), dm.shape)
        j, e = odd[oi], even[ei]
        to = (c[e] - c[j]) / np.linalg.norm(c[e] - c[j])
        dist = 5.0
    else:
        j, to, dist = 0, np.array([0.0, 0.0, 1.0]), 2.5
    if along_sun:
        to, dist = -SUN, 8.0
    eye = c[j] + to * dist * r[j]
    return look_at(eye.astype(np.float32), c[j].astype(np.float32),
                   np.array([0.0, 1.0, 0.0], np.float32))


def _parity(cfg, steps: int):
    """The port's plain step and the JAX oracle step, run op by op, from
    the JAX initial state for `steps` steps, held to the gates of the
    module docstring; returns the port's accum."""
    jcfg = JRenderConfig.from_json(cfg.to_json())
    if cfg.scene_kind == "sphere":
        jscene = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
        scene = SphereScene.from_numpy(jscene.center_x, jscene.center_y,
                                       jscene.center_z, jscene.sqr_radius)
    else:
        jscene = jtessellate(jcompute(cfg.sphere_count, cfg.world_size,
                                      cfg.scene_seed),
                             cfg.disc_lat, cfg.disc_long)
        scene = build_triangle_scene(compute_spheres(
            cfg.sphere_count, cfg.world_size, cfg.scene_seed),
            cfg.disc_lat, cfg.disc_long)
    cam = Camera.from_config(cfg, _view(cfg, cfg.env_mode == "sun")).packed()
    jstep = jbuild(jcfg, jscene, backend="xla")
    jst = jinit(jcfg)
    st = FrameState.from_numpy(
        np.asarray(jst.accum), np.asarray(jst.output),
        rng_state=None if jst.rng_state is None else np.asarray(jst.rng_state))
    step = build_render_step(cfg, scene, backend="torch", device="cpu")
    with jax.disable_jit():
        for _ in range(steps):
            jst = jstep(jst, cam)
    for _ in range(steps):
        st = step(st, cam)

    ja, jo = np.asarray(jst.accum), np.asarray(jst.output)
    ta, to = st.accum.numpy(), st.output.numpy()
    assert (st.tile_offset, st.iteration) == (int(jst.tile_offset),
                                              int(jst.iteration))
    if jst.rng_state is not None:
        np.testing.assert_array_equal(st.rng_state.numpy().view(np.uint32),
                                      np.asarray(jst.rng_state))
    lit = (np.abs(ja[:3, :cfg.height, :cfg.width]).max(0) > 0).mean()
    assert lit > 0.05, f"lit coverage {lit}"
    np.testing.assert_array_equal(ta[3], ja[3])
    rmse = np.sqrt(((ta - ja) ** 2).mean())
    if cfg.fast_math and cfg.aov == "ambient_occlusion":
        # A binary AOV: where XLA:CPU's rsqrt and the port's differ in the
        # last ulp, a grazing occlusion ray can flip a sample by a whole 1,
        # so its fast-math budget is counted in flipped values.
        flipped = (np.abs(ta - ja)[:3] > 1e-3).mean()
        assert flipped < 1e-3, f"flipped AO values {flipped}"
    else:
        assert rmse < 1e-3, f"port/oracle RMSE {rmse}"
    flips = (np.abs(to - jo) > 1e-3).mean()
    assert flips < (1e-3 if cfg.fast_math else 2e-3), f"flips {flips}"
    return ta


MODES = ("threefry", "tinymt", "tauslcg")
SETTINGS = {
    "normal": {"aov": "normal"},
    "hit": {"aov": "hit"},
    "ao": {"aov": "ambient_occlusion"},
    "sun": {"env_mode": "sun"},
    "viewproj": {"ray_gen": "viewproj"},
    "sun_viewproj_wavefront": {"env_mode": "sun", "ray_gen": "viewproj",
                               "wavefront": True},
}
SPHERE_ONLY = {"tex_coords": {"aov": "tex_coords"},
               "param_uv": {"aov": "param_uv"}}
FAST = {"fast": {"fast_math": True},
        "fast_sun_viewproj_wavefront": {"fast_math": True, "env_mode": "sun",
                                        "ray_gen": "viewproj",
                                        "wavefront": True},
        "fast_ao": {"fast_math": True, "aov": "ambient_occlusion"},
        "fast_normal": {"fast_math": True, "aov": "normal"}}


def _cases(settings, modes):
    return [pytest.param(kw, mode, id=f"{name}-{mode}")
            for name, kw in settings.items() for mode in modes
            if not (kw.get("wavefront") and mode != "threefry")]


SPHERE_CFG = RenderConfig(width=128, height=64, sphere_count=16,
                          emissive_every=2)
TRI_CFG = RenderConfig(width=128, height=32, sphere_count=4, disc_lat=4,
                       disc_long=4, scene_kind="triangle", max_bounces=1)


@pytest.mark.parametrize("kw,mode", _cases({**SETTINGS, **SPHERE_ONLY}, MODES)
                         + _cases(FAST, ("threefry",)))
def test_sphere_step_matches_xla_oracle(kw, mode):
    cfg = SPHERE_CFG.replace(rng=mode, **kw).validate()
    accum = _parity(cfg, 2)
    if cfg.env_mode == "sun":  # the sun lobe lights the misses
        assert (accum[:3].max(0) > 0.1).mean() > 0.02
    if kw.get("aov") == "ambient_occlusion":  # both occluded and open hits
        assert 0 < (accum[0] > 0).sum() < (accum[3] > 0).sum()


@pytest.mark.parametrize("kw,mode", _cases(SETTINGS, MODES)
                         + _cases(FAST, ("threefry",)))
def test_triangle_step_matches_xla_oracle(kw, mode):
    """One step of one bounce at most: the JAX triangle oracle op by op
    sweeps every triangle in Python (tests/test_torch_rng_modes.py)."""
    cfg = TRI_CFG.replace(rng=mode, **kw).validate()
    accum = _parity(cfg, 1)
    if kw.get("aov") == "normal":  # magenta misses
        miss = (accum[0] == 1) & (accum[1] == 0) & (accum[2] == 1)
        assert 0 < miss[:cfg.height, :cfg.width].mean() < 1
    if cfg.env_mode == "sun":
        assert (accum[:3].max(0) > 0.1).mean() > 0.02
