"""l2n_tpu_torch tensor ops against l2n_tpu's on inputs made from a numpy
seed: sphere sweeps, the sky, the sampling math, ray generation, the
procedural albedo, and the uv_demo kernel's plain version (against the JAX
Pallas kernel in interpret mode).

The JAX side runs op by op (`jax.disable_jit`, autouse fixture below):
XLA:CPU's fused loops contract a*b+c into FMAs, and a near-tangent root
amplifies that to ~1e-4 relative; op by op both sides compute the same IEEE
float32 operations. Tolerances: sweeps and the sky are discrete (winner
index, escape count), so they must agree except on at most 1e-3 of lanes;
continuous outputs agree to 1e-6 (sin/cos may differ by an ulp). The albedo hash fract(sin(x) * 43758.5453) turns one
ulp of sin into up to 4e-3 for indices below 128 (measured), which is why
the renderer evaluates it once into a shared table.
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l2n_tpu.camera import Camera as JCamera
from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.maths import fastmath as jfastmath
from l2n_tpu.maths import sampling as jsampling
from l2n_tpu.ops import envlight as jenvlight
from l2n_tpu.ops import intersect as jintersect
from l2n_tpu.ops import pathtrace as jpathtrace
from l2n_tpu.ops.kernels.uv_demo import uv_demo as juv_demo
from l2n_tpu.scene.spheres import compute_spheres as jcompute
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths import fastmath, sampling
from l2n_tpu_torch.ops import envlight, intersect, pathtrace
from l2n_tpu_torch.ops.kernels.common import launches
from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt, sphere_pt_plain
from l2n_tpu_torch.ops.kernels.uv_demo import uv_demo, uv_demo_plain
from l2n_tpu_torch.render.state import init_rng_state
from l2n_tpu_torch.scene.spheres import compute_spheres


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


N = 20_000


@pytest.fixture(autouse=True)
def _op_by_op(request):
    if "pallas" in request.node.name:
        yield
        return
    with jax.disable_jit():
        yield


def _gen(seed=11):
    return np.random.Generator(np.random.PCG64(seed))


def _unit(gen, n):
    d = gen.normal(size=(3, n)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0).astype(np.float32)


@pytest.fixture(scope="module")
def rays():
    """Rays from the world cube aimed near random sphere centers (most hit),
    plus fully random directions (most miss)."""
    gen = _gen()
    sc = jcompute(16)
    c = np.stack([sc.center_x, sc.center_y, sc.center_z])
    o = gen.uniform(-512, 512, size=(3, N)).astype(np.float32)
    tgt = c[:, gen.integers(0, 16, N)] + gen.normal(scale=20.0, size=(3, N))
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    d[:, N // 2:] = _unit(gen, N - N // 2)
    return sc, o.astype(np.float32), d.astype(np.float32)


def _jfetch(sc):
    arrs = [jnp.asarray(a) for a in (sc.center_x, sc.center_y, sc.center_z,
                                     sc.sqr_radius)]
    return lambda i: tuple(a[i] for a in arrs)


def _tscene(sc):
    return [torch.from_numpy(np.asarray(a)) for a in
            (sc.center_x, sc.center_y, sc.center_z, sc.sqr_radius)]


def test_intersect_sphere_scene(rays):
    sc, o, d = rays
    j = jintersect.intersect_sphere_scene(
        *(jnp.asarray(a) for a in (*o, *d)), sc.count, _jfetch(sc))
    t = intersect.intersect_sphere_scene(
        *(torch.from_numpy(a) for a in (*o, *d)), *_tscene(sc))
    jt, ti = np.asarray(j[0]), t[0].numpy()
    jidx, tidx = np.asarray(j[7]), t[7].numpy()
    assert 0.2 < (jidx >= 0).mean() < 0.8  # both hits and misses
    same = jidx == tidx
    assert (~same).mean() <= 1e-3
    np.testing.assert_allclose(ti[same], jt[same], rtol=1e-5)
    for k in range(4, 7):  # normals of agreeing lanes
        np.testing.assert_allclose(t[k].numpy()[same], np.asarray(j[k])[same],
                                   atol=1e-4)
    np.testing.assert_array_equal(t[8].numpy()[same], np.asarray(j[8])[same])


def test_sphere_scene_anyhit(rays):
    sc, o, d = rays
    j = np.asarray(jintersect.sphere_scene_anyhit(
        *(jnp.asarray(a) for a in (*o, *d)), sc.count, _jfetch(sc)))
    t = intersect.sphere_scene_anyhit(
        *(torch.from_numpy(a) for a in (*o, *d)), *_tscene(sc)).numpy()
    assert 0.2 < j.mean() < 0.8
    assert (j != t).mean() <= 1e-3
    # any-hit is exactly "nearest t >= 0"
    near = intersect.intersect_sphere_scene(
        *(torch.from_numpy(a) for a in (*o, *d)), *_tscene(sc))[0].numpy()
    assert ((near >= 0) != t).mean() <= 1e-3


def test_mandelbrot_le():
    gen = _gen(3)
    d = _unit(gen, 4 * N)
    d[0] = np.abs(d[0])  # bias towards the sky's patch
    j = np.asarray(jenvlight.mandelbrot_le(*(jnp.asarray(a) for a in d)))
    t = envlight.mandelbrot_le(*(torch.from_numpy(a) for a in d)).numpy()
    assert (j > 0).mean() > 0.05
    assert (j != t).mean() <= 1e-3


def test_env_radiance_none_and_sun():
    """The sun sky was refused (ROADMAP Queue 1 #9) until it was ported:
    it now dispatches to sun_le, equal to the JAX sky's on directions near
    the sun's; an unknown mode raises."""
    d = [torch.ones(4)] * 3
    assert (envlight.env_radiance("none", *d) == 0).all()
    gen = _gen(7)
    s = np.float32(1.0 / np.sqrt(3.0))
    near = (np.array([s, s, -s], np.float32)[:, None]
            + 0.1 * gen.normal(size=(3, N)).astype(np.float32))
    near = (near / np.linalg.norm(near, axis=0)).astype(np.float32)
    t = envlight.env_radiance("sun", *(torch.from_numpy(a) for a in near))
    j = np.asarray(jenvlight.env_radiance("sun", *(jnp.asarray(a)
                                                   for a in near)))
    np.testing.assert_array_equal(t.numpy(), j)
    assert (j > 0.1).mean() > 0.1
    with pytest.raises(ValueError, match="env_mode"):
        envlight.env_radiance("moon", *d)


def test_atan2():
    gen = _gen(4)
    y, x = gen.normal(size=(2, N)).astype(np.float32)
    x[:10] = 0.0
    y[5:15] = 0.0
    j = np.asarray(jfastmath.atan2(jnp.asarray(y), jnp.asarray(x)))
    t = fastmath.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)


def test_frame_z_and_cosine_hemisphere():
    gen = _gen(5)
    z = _unit(gen, N)
    jt, jb = jsampling.frame_z(*(jnp.asarray(a) for a in z))
    tt, tb = sampling.frame_z(*(torch.from_numpy(a) for a in z))
    for a, b in zip(jt + jb, tt + tb):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    u1, u2 = gen.random((2, N), dtype=np.float32)
    (jx, jy, jz), jj = jsampling.cosine_sample_hemisphere(jnp.asarray(u1),
                                                          jnp.asarray(u2))
    (tx, ty, tz), tj = sampling.cosine_sample_hemisphere(torch.from_numpy(u1),
                                                         torch.from_numpy(u2))
    for a, b in ((jx, tx), (jy, ty), (jz, tz)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=1e-5)
    jw = jsampling.local_to_world(jx, jy, jz, jt, jb, tuple(jnp.asarray(a) for a in z))
    tw = sampling.local_to_world(tx, ty, tz, tt, tb, tuple(torch.from_numpy(a) for a in z))
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_generate_rays():
    cfg = RenderConfig(width=128, height=64)
    cam = JCamera.from_config(_jcfg(cfg)).packed()
    gen = _gen(6)
    px = gen.integers(0, 128, N).astype(np.float32)
    py = gen.integers(0, 64, N).astype(np.float32)
    u1, u2 = gen.random((2, N), dtype=np.float32)
    j = jpathtrace.generate_rays(_jcfg(cfg), jnp.asarray(cam), *(jnp.asarray(a) for a in
                                                          (px, py, u1, u2)))
    t = pathtrace.generate_rays(cfg, torch.from_numpy(cam),
                                *(torch.from_numpy(a) for a in (px, py, u1, u2)))
    for a, b in zip(j, t):
        np.testing.assert_allclose(np.broadcast_to(b.numpy(), (N,)),
                                   np.broadcast_to(np.asarray(a), (N,)),
                                   atol=1e-6)
    # viewproj was refused (ROADMAP Queue 1 #9) until it was ported: its
    # rays now match the JAX package's too
    vcfg = cfg.replace(ray_gen="viewproj")
    j = jpathtrace.generate_rays(_jcfg(vcfg), jnp.asarray(cam),
                                 *(jnp.asarray(a) for a in (px, py, u1, u2)))
    t = pathtrace.generate_rays(vcfg, torch.from_numpy(cam),
                                *(torch.from_numpy(a)
                                  for a in (px, py, u1, u2)))
    for a, b in zip(j, t):
        np.testing.assert_allclose(np.broadcast_to(b.numpy(), (N,)),
                                   np.broadcast_to(np.asarray(a), (N,)),
                                   atol=1e-6)


def test_procedural_color():
    n = np.arange(-1, 128, dtype=np.int32)
    j = jsampling.procedural_color(jnp.asarray(n))
    t = sampling.procedural_color(torch.from_numpy(n))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=4e-3)
    # the scene's table is that function, evaluated once on the host
    sc = compute_spheres(16)
    np.testing.assert_array_equal(
        sc.albedo.numpy(),
        torch.stack(sampling.procedural_color(torch.arange(16)), 1).numpy())


def test_uv_demo_plain_matches_pallas():
    t = np.float32(0.7)
    want = np.asarray(juv_demo(32, 128, t))
    got = uv_demo(torch.tensor([t]), 32, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(got.numpy(),
                                  uv_demo_plain(torch.tensor([t]), 32, 128).numpy())
    assert launches["uv_demo"] == 0  # the plain version is not a launch


def _step_inputs(cfg, device="cpu"):
    sc = compute_spheres(cfg.sphere_count)
    sched = torch.tensor([[0, 0], [0, 1]], dtype=torch.int32, device=device)
    accum = torch.zeros((4, cfg.padded_height, cfg.padded_width),
                        device=device)
    output = torch.zeros((3, cfg.padded_height, cfg.padded_width),
                         device=device)
    cam = JCamera.from_config(_jcfg(cfg)).packed()
    return sched, cam, sc.packed().to(device), accum, output


def test_sphere_pt_wrapper_cpu_is_plain():
    cfg = RenderConfig(width=128, height=64, sphere_count=16)
    a = _step_inputs(cfg)
    b = _step_inputs(cfg)
    sphere_pt(cfg, *a)
    sphere_pt_plain(cfg, *b)
    np.testing.assert_array_equal(a[3].numpy(), b[3].numpy())
    np.testing.assert_array_equal(a[4].numpy(), b[4].numpy())
    assert (a[3][3] == 1).all()
    assert launches["sphere_pt"] == 0


def test_sphere_pt_wrapper_checks():
    cfg = RenderConfig(width=128, height=64, sphere_count=16)
    sched, cam, spheres, accum, output = _step_inputs(cfg)
    with pytest.raises(TypeError, match="sched"):
        sphere_pt(cfg, sched.to(torch.int64), cam, spheres, accum, output)
    with pytest.raises(ValueError, match="accum"):
        sphere_pt(cfg, sched, cam, spheres, accum[:, :32], output)
    with pytest.raises(ValueError, match="contiguous"):
        sphere_pt(cfg, sched, cam, spheres.T.contiguous().T, accum, output)
    with pytest.raises(ValueError, match="camera"):
        sphere_pt(cfg, sched, cam[:9], spheres, accum, output)
    meta = [t.to("meta") for t in (sched, spheres, accum, output)]
    with pytest.raises(ValueError, match="no kernel"):
        sphere_pt(cfg, meta[0], cam, meta[1], meta[2], meta[3])
    # rng="tinymt" was refused (ROADMAP Queue 1 #10) until the stateful
    # modes were ported: the wrapper now takes the state planes, checks
    # them, and steps them in place with the frame.
    tcfg = cfg.replace(rng="tinymt")
    with pytest.raises(ValueError, match="rng_state"):
        sphere_pt(tcfg, sched, cam, spheres, accum, output)
    with pytest.raises(ValueError, match="rng_state"):
        sphere_pt(cfg, sched, cam, spheres, accum, output,
                  torch.zeros((8, 64, 128), dtype=torch.int32))
    planes = init_rng_state(tcfg)
    with pytest.raises(TypeError, match="rng_state"):
        sphere_pt(tcfg, sched, cam, spheres, accum, output, planes.long())
    before = planes.clone()
    sphere_pt(tcfg, sched, cam, spheres, accum, output, planes)
    assert (accum[3] == 1).all()
    assert (planes[:4] != before[:4]).any(0).all()  # every pixel drew
    assert torch.equal(planes[4:], before[4:])  # parameters untouched
