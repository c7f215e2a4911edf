"""The material modes (microfacet, Disney) and normal mapping of
l2n_tpu_torch against the JAX package on the CPU.

Units, on lanes made from a numpy seed, the JAX side op by op
(jax.disable_jit): eval_brdf, eval_disney, sample_brdf and sample_disney
at roughness 0.1, 0.4, 1.0 and metallic 0, 1, with lanes at grazing angles
and below the horizon (eval atol 1e-6; sample atol 1e-6 wherever XLA's
and torch's sin and cos of the azimuth agree, and elsewhere 1e-2 relative
on the steep GGX pdf and weight); perturb_normal and
procedural_bump_amplitude; and the port's material table against the JAX
package's hash: each channel's raw hash within 4e-3, so metallic (8 times
the hash) within 3.2e-2, subsurface (2 times) within 8e-3, and no flip of
metallic's 0.75 or subsurface's 0.5 threshold at <= 128 objects.

The slice: the port's plain step (backend="torch") against
l2n_tpu.render.step._xla_step run op by op, with the JAX package's hash
values carried into the port's tables (the hash magnifies sin's last ulp,
so both sides then shade every object alike), for microfacet, Disney and
the bump on the sphere scene (128x64, 16 spheres) in every rng mode the
oracle takes, on a small triangle scene (one bounce, one step), and the
wavefront step with microfacet. Each JAX render is made once per module
and shared by the cases that need it. Gates: the north star's (accum[3]
equal, accum RMSE < 1e-3, output |d| > 1e-3 on fewer than 2e-3 of the
values), the stateful modes' state planes bit-equal, a lit frame.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.maths import brdf as jbrdf
from l2n_tpu.maths import bump as jbump
from l2n_tpu.maths.sampling import frame_z as jframe_z
from l2n_tpu.maths.sampling import procedural_color as jprocedural_color
from l2n_tpu.render.state import init_frame_state as jinit
from l2n_tpu.render.step import build_render_step as jbuild
from l2n_tpu.scene.spheres import compute_spheres as jcompute
from l2n_tpu.scene.tessellate import build_triangle_scene as jtessellate
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths import brdf
from l2n_tpu_torch.maths.bump import perturb_normal, procedural_bump_amplitude
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.maths.sampling import frame_z
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.render.state import FrameState
from l2n_tpu_torch.render.step import build_render_step
from l2n_tpu_torch.scene.materials import material_table
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

def _lanes(n=6000, seed=41):
    """(n, wo, wi, kd, material rows (6, n)): unit normals, wo above the
    surface, wi anywhere (about half below the horizon); every seventh lane
    grazing (wo and wi 1e-3 off the tangent plane); roughness cycling 0.1,
    0.4, 1.0 and random, metallic 0, 1 and random."""
    gen = np.random.Generator(np.random.PCG64(seed))

    def unit(k):
        v = gen.normal(size=(3, k))
        return v / np.linalg.norm(v, axis=0)

    nv, wo, wi = unit(n), unit(n), unit(n)
    wo *= np.sign((wo * nv).sum(0))
    graze = np.arange(n) % 7 == 0
    for w in (wo, wi):
        t = w - (w * nv).sum(0) * nv
        t /= np.linalg.norm(t, axis=0)
        w[:, graze] = (t + 1e-3 * nv)[:, graze]
        w /= np.linalg.norm(w, axis=0)
    mat = gen.random((6, n))
    mat[0] = np.choose(np.arange(n) % 4, [0.1, 0.4, 1.0, mat[0]])
    mat[1] = np.choose(np.arange(n) // 4 % 3, [0.0, 1.0, mat[1]])
    kd = gen.random((3, n))
    return tuple(np.asarray(a, np.float32) for a in (nv, wo, wi, kd, mat))


def _t(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in a)


def _j(a):
    return tuple(jnp.asarray(c) for c in a)


@pytest.mark.parametrize("mode", ["microfacet", "disney"])
def test_eval_matches_jax(mode):
    nv, wo, wi, kd, mat = _lanes()
    m = _t(mat)
    with jax.disable_jit():
        if mode == "disney":
            got = brdf.eval_disney(_t(nv), _t(wo), _t(wi), _t(kd), m[0],
                                   *m[1:5])
            want = jbrdf.eval_disney(*_j(nv), *_j(wo), *_j(wi), *_j(kd),
                                     *_j(mat[:5]))
        else:
            got = brdf.eval_brdf(_t(nv), _t(wo), _t(wi), _t(kd), m[0])
            want = jbrdf.eval_brdf(*_j(nv), *_j(wo), *_j(wi), *_j(kd),
                                   jnp.asarray(mat[0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    below = (nv * wi).sum(0) <= 0
    assert below.mean() > 0.3 and (got[3].numpy()[below] == 0).all()
    # every roughness and metallic cycle covered, lit lanes nonzero
    assert (got[3].numpy()[~below] > 0).mean() > 0.99


@pytest.mark.parametrize("mode", ["microfacet", "disney"])
def test_sample_matches_jax(mode):
    nv, wo, _, kd, mat = _lanes(seed=42)
    gen = np.random.Generator(np.random.PCG64(43))
    u = gen.random((3, nv.shape[1]), dtype=np.float32)
    m = _t(mat)
    tn = _t(nv)
    with jax.disable_jit():
        jn = _j(nv)
        jt, jb = jframe_z(*jn)
        if mode == "disney":
            wi, w, pdf = brdf.sample_disney(*_t(u), tn, frame_z(*tn), _t(wo),
                                            _t(kd), m[0], *m[1:5])
            want = jbrdf.sample_disney(*_j(u), *jn, jt, jb, *_j(wo), *_j(kd),
                                       *_j(mat[:5]))
        else:
            wi, w, pdf = brdf.sample_brdf(*_t(u), tn, frame_z(*tn), _t(wo),
                                          _t(kd), m[0])
            want = jbrdf.sample_brdf(*_j(u), *jn, jt, jb, *_j(wo), *_j(kd),
                                     jnp.asarray(mat[0]))
    want = [np.asarray(x) for x in want]
    got = [torch.stack(wi).numpy(), torch.stack(w).numpy(), pdf.numpy()]
    want = [np.stack(want[:3]), np.stack(want[3:6]), want[6]]
    # Where XLA's sin and cos of the azimuth equal torch's the two sides
    # take the same floats: atol 1e-6. Elsewhere the pdf and the weight
    # f n.l / pdf of a GGX lobe at roughness 0.1 are steep in the
    # direction, and an ulp of sin/cos moves them by up to ~2e-3
    # relative: there the directions are held to 1e-6, the rest to 1e-2.
    phi = torch.from_numpy((2.0 * np.pi) * u[2]).float()
    with jax.disable_jit():
        jphi = jnp.asarray(phi.numpy())
        same = ((np.asarray(jnp.sin(jphi)) == torch.sin(phi).numpy())
                & (np.asarray(jnp.cos(jphi)) == torch.cos(phi).numpy()))
    assert same.mean() > 0.9
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g[..., same], wt[..., same], rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    for g, wt in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, wt, rtol=1e-2, atol=1e-6)
    assert (got[2] > 0).mean() > 0.5


def test_bump_matches_jax():
    gen = np.random.Generator(np.random.PCG64(44))
    n = 6000
    pts = (gen.random((3, n)) * 1024 - 512).astype(np.float32)
    nv = (gen.normal(size=(3, n)) * (0.1 + 3 * gen.random(n))).astype(
        np.float32)
    idx = np.arange(n) % 300
    cfg = RenderConfig(normal_map=0.8, normal_map_freq=0.35).validate()
    jcfg = JRenderConfig.from_json(cfg.to_json())
    with jax.disable_jit():
        jamp = np.asarray(jbump.procedural_bump_amplitude(jnp.asarray(idx)))
        want = jbump.perturb_normal(jcfg, jnp.asarray(idx), *_j(pts),
                                    *_j(nv))
    amp = procedural_bump_amplitude(torch.from_numpy(idx)).numpy()
    # the hash: sin's last ulp, times 43758.5453, times 0.75
    assert np.abs(amp - jamp).max() <= 4e-3
    got = perturb_normal(cfg, torch.from_numpy(jamp.copy()), _t(pts), _t(nv))
    np.testing.assert_allclose(torch.stack(got).numpy(),
                               np.stack([np.asarray(w) for w in want]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(torch.stack(got).numpy(),
                                              axis=0), 1.0, atol=1e-6)


def _jax_material_table(n: int) -> np.ndarray:
    """(n, 6) MATERIAL_CHANNELS from the JAX package's hash functions."""
    idx = jnp.arange(n)
    with jax.disable_jit():
        cols = [jbrdf.procedural_roughness(idx),
                *jbrdf.procedural_disney_params(idx),
                jbump.procedural_bump_amplitude(idx)]
    return np.stack([np.asarray(c) for c in cols], 1).astype(np.float32)


def _jax_albedo(n: int) -> np.ndarray:
    with jax.disable_jit():
        return np.stack([np.asarray(c) for c in
                         jprocedural_color(jnp.arange(n))], 1)


def test_material_table_matches_jax_hash():
    """The port's table against the JAX hash at 128 objects: every raw hash
    within 4e-3 (metallic within 3.2e-2, subsurface 8e-3), and no object on
    the other side of metallic's 0.75 or subsurface's 0.5 threshold (a flip
    would make a dielectric a metal)."""
    n = 128
    got = material_table(n).numpy()
    want = _jax_material_table(n)
    d = np.abs(got - want).max(0)
    # Each channel's factor on its raw hash (roughness 0.92, metallic 8
    # above its threshold, subsurface 2, bump 0.75).
    scale = {"roughness": 0.92, "metallic": 8.0, "specular": 1.0,
             "sheen": 1.0, "subsurface": 2.0, "bump": 0.75}
    for i, (name, k) in enumerate(scale.items()):
        assert d[i] <= 4e-3 * k, (name, d[i])
    np.testing.assert_array_equal(got[:, 1] > 0, want[:, 1] > 0)
    np.testing.assert_array_equal(got[:, 4] > 0, want[:, 4] > 0)
    assert (want[:, 1] > 0).sum() > 10 and (want[:, 4] > 0).sum() > 40


# ---------------------------------------------------------------------------
# The slice against the JAX oracle step
# ---------------------------------------------------------------------------

def _view(cfg):
    """A lit view: between a diffuse (odd) sphere and its nearest emissive
    (even) one, looking at the diffuse one (spheres); up close at the
    diffuse mesh 1, whose material the camera sees (meshes)."""
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
        to, dist = (c[e] - c[j]) / np.linalg.norm(c[e] - c[j]), 5.0
    else:
        j, to, dist = 1, np.array([0.0, 0.0, 1.0]), 2.5
    eye = c[j] + to * dist * r[j]
    return look_at(eye.astype(np.float32), c[j].astype(np.float32),
                   np.array([0.0, 1.0, 0.0], np.float32))


def _scenes(cfg):
    """(JAX scene, the port's scene with the JAX hash tables carried in)."""
    jsph = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    if cfg.scene_kind == "sphere":
        scene = SphereScene.from_numpy(jsph.center_x, jsph.center_y,
                                       jsph.center_z, jsph.sqr_radius)
        n = scene.count
        return jsph, scene.with_tables(_jax_albedo(n), _jax_material_table(n))
    jscene = jtessellate(jsph, cfg.disc_lat, cfg.disc_long)
    scene = build_triangle_scene(compute_spheres(
        cfg.sphere_count, cfg.world_size, cfg.scene_seed),
        cfg.disc_lat, cfg.disc_long)
    return jscene, scene


@functools.cache
def _oracle(cfg_json: str, steps: int):
    """The JAX oracle's (accum, output, rng_state, tile_offset, iteration)
    after `steps` op-by-op steps: once per module and configuration."""
    cfg = RenderConfig.from_json(cfg_json)
    jcfg = JRenderConfig.from_json(cfg_json)
    jscene, _ = _scenes(cfg)
    cam = Camera.from_config(cfg, _view(cfg)).packed()
    jstep = jbuild(jcfg, jscene, backend="xla")
    jst = jinit(jcfg)
    init = (np.asarray(jst.accum), np.asarray(jst.output),
            None if jst.rng_state is None else np.asarray(jst.rng_state))
    with jax.disable_jit():
        for _ in range(steps):
            jst = jstep(jst, cam)
    return init, (np.asarray(jst.accum), np.asarray(jst.output),
                  None if jst.rng_state is None
                  else np.asarray(jst.rng_state),
                  int(jst.tile_offset), int(jst.iteration))


def _parity(cfg, steps: int):
    """The port's plain step against the JAX oracle's render of the same
    configuration (the wavefront flag aside: the oracle is single-pass),
    from the JAX initial state, held to the module docstring's gates."""
    oracle_cfg = cfg.replace(wavefront=False)
    (a0, o0, s0), (ja, jo, js, offset, iteration) = _oracle(
        oracle_cfg.to_json(), steps)
    _, scene = _scenes(cfg)
    cam = Camera.from_config(cfg, _view(cfg)).packed()
    if cfg.scene_kind == "triangle":  # the JAX hash tables, per mesh
        buf = TriangleBuffers.from_scene(scene)
        m = buf.albedo.shape[1]
        scene = buf.with_tables(_jax_albedo(m), _jax_material_table(m))
    step = build_render_step(cfg, scene, backend="torch", device="cpu")
    st = FrameState.from_numpy(a0, o0, rng_state=s0)
    for _ in range(steps):
        st = step(st, cam)
    ta, to = st.accum.numpy(), st.output.numpy()
    assert (st.tile_offset, st.iteration) == (offset, iteration)
    if js is not None:
        np.testing.assert_array_equal(st.rng_state.numpy().view(np.uint32),
                                      js)
    lit = (np.abs(ja[:3, :cfg.height, :cfg.width]).max(0) > 0).mean()
    assert lit > 0.05, f"lit coverage {lit}"
    np.testing.assert_array_equal(ta[3], ja[3])
    rmse = np.sqrt(((ta - ja) ** 2).mean())
    assert rmse < 1e-3, f"port/oracle RMSE {rmse}"
    flips = (np.abs(to - jo) > 1e-3).mean()
    assert flips < 2e-3, f"flips {flips}"
    return ta


MODES = ("threefry", "tinymt", "tauslcg")
SETTINGS = {
    "microfacet": {"material_mode": "microfacet"},
    "disney": {"material_mode": "disney"},
    "normal_map": {"normal_map": 0.8},
}
SPHERE_CFG = RenderConfig(width=128, height=64, sphere_count=16,
                          emissive_every=2)
TRI_CFG = RenderConfig(width=128, height=32, sphere_count=4, disc_lat=4,
                       disc_long=4, scene_kind="triangle", max_bounces=1)


def _cases(settings, modes):
    return [pytest.param(kw, mode, id=f"{name}-{mode}")
            for name, kw in settings.items() for mode in modes]


@pytest.mark.parametrize("kw,mode", _cases(SETTINGS, MODES))
def test_sphere_step_matches_xla_oracle(kw, mode):
    cfg = SPHERE_CFG.replace(rng=mode, **kw).validate()
    accum = _parity(cfg, 2)
    assert (accum[:3].max(0) > 0).mean() > 0.3


@pytest.mark.parametrize("kw,mode", _cases(SETTINGS, MODES))
def test_triangle_step_matches_xla_oracle(kw, mode):
    """One step of one bounce at most: the JAX triangle oracle op by op
    sweeps every triangle in Python."""
    accum = _parity(TRI_CFG.replace(rng=mode, **kw).validate(), 1)
    assert (accum[:3].max(0) > 0).mean() > 0.05


def test_wavefront_step_matches_xla_oracle():
    """The wavefront step with microfacet and the bump: the oracle's render
    of the single-pass configuration (pass B resumes at (3, False))."""
    cfg = SPHERE_CFG.replace(material_mode="microfacet", normal_map=0.8,
                             wavefront=True).validate()
    _parity(cfg, 2)
