"""The explicit lights and the Phong albedo override of l2n_tpu_torch
against the JAX package on the CPU.

Units: the containers carried across from the JAX package's
(scene/materials.py carry_across) and ExplicitLights' host arrays
byte-equal to the JAX package's (the directional rows' wi = -d/|d| too);
explicit_light_contribution against the JAX function op by op
(jax.disable_jit) at vertices on the spheres' surfaces, with Lambert's
kd / pi and with the microfacet BSDF.

The slice: the port's plain step with a program's buffers (tests/
test_tpu_hw.py's: two Phong albedos, a point light at the origin, a
directional light) against l2n_tpu.render.step._xla_step with the same
buffers, op by op, the JAX hash tables carried into the port's, with the
procedural and the microfacet mode, on spheres and on a small triangle
scene. Dirac lights cast knife-edge shadows, so, as the JAX package gates
its kernel against its oracle, the gate counts flipped values: accum[3]
equal, fewer than 1% of the accum values off by more than 1e-3, and each
channel's mean within 2%; plus a lit frame that the lights brighten.
"""

from __future__ import annotations

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.maths import brdf as jbrdf
from l2n_tpu.ops.lights import ExplicitLights as JExplicitLights
from l2n_tpu.ops.lights import (
    explicit_light_contribution as jexplicit_light_contribution,
)
from l2n_tpu.ops.scenes import sphere_intersector as jsphere_intersector
from l2n_tpu.render.state import init_frame_state as jinit
from l2n_tpu.render.step import build_render_step as jbuild
from l2n_tpu.scene import materials as jmaterials
from l2n_tpu.scene.spheres import compute_spheres as jcompute
from l2n_tpu.scene.tessellate import build_triangle_scene as jtessellate
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths import brdf
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.kernels.triangle_pt import TriangleBuffers
from l2n_tpu_torch.ops.lights import (
    ExplicitLights,
    explicit_light_contribution,
)
from l2n_tpu_torch.ops.scenes import sphere_intersector
from l2n_tpu_torch.render.program import SphereProgram, TriangleProgram
from l2n_tpu_torch.render.state import FrameState
from l2n_tpu_torch.scene import materials
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


def _jax_buffers():
    """tests/test_tpu_hw.py::test_explicit_lights_kernel_on_hw's buffers,
    as the JAX package's containers."""
    mats = jmaterials.PhongMaterials.from_arrays(
        np.array([[0.9, 0.2, 0.1, 1.0], [0.1, 0.8, 0.3, 1.0]], np.float32),
        np.zeros((2, 3), np.float32), np.zeros(2, np.float32))
    pls = jmaterials.PointLights.from_arrays(
        np.array([[0.0, 0.0, 0.0]], np.float32),
        np.array([[5e7, 4e7, 3e7]], np.float32))
    dls = jmaterials.DirectionalLights.from_arrays(
        np.array([[0.3, -1.0, 0.2]], np.float32),
        np.array([[0.5, 0.5, 0.6]], np.float32))
    return mats, pls, dls


def _port_buffers():
    mats, pls, dls = _jax_buffers()
    return (materials.PhongMaterials.carry_across(mats),
            materials.PointLights.carry_across(pls),
            materials.DirectionalLights.carry_across(dls))


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------

def test_containers_carry_across():
    jm, jp, jd = _jax_buffers()
    pm, pp, pd = _port_buffers()
    for j, p in ((jm, pm), (jp, pp), (jd, pd)):
        assert p.count == j.count
        for name in j.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(p, name).numpy(),
                                          np.asarray(getattr(j, name)))
    empty = materials.empty_lights()
    assert [c.count for c in empty] == [0, 0, 0]
    assert not ExplicitLights(*empty).enabled


def test_explicit_lights_arrays_byte_equal():
    """The host arrays, directional wi = -d / max(|d|, 1e-20) included,
    byte for byte; and the gates enabled / has_lights."""
    want = JExplicitLights(*_jax_buffers())
    got = ExplicitLights(*_port_buffers())
    for name in ("albedo", "point", "directional"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name
    assert got.enabled and got.has_lights
    only_albedo = ExplicitLights(_port_buffers()[0])
    assert only_albedo.enabled and not only_albedo.has_lights
    table = torch.rand((16, 3))
    over = only_albedo.override_albedo(table)
    np.testing.assert_array_equal(over[:2].numpy(), want.albedo)
    assert torch.equal(over[2:], table[2:])


@pytest.mark.parametrize("mode", ["procedural", "microfacet"])
def test_explicit_light_contribution_matches_jax(mode):
    """At 4096 vertices on the surfaces of the 128 default spheres (normals
    of length 0.5 to 2, renormalized inside), the point light behind other
    spheres for some: rtol 1e-5 where the shadow casts agree; the casts
    themselves (the nearest-hit sweep, same floats) agree on all but a few
    grazing lanes."""
    cfg = RenderConfig(sphere_count=128).validate()
    jcfg = JRenderConfig.from_json(cfg.to_json())
    jsc = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    sc = SphereScene.from_numpy(jsc.center_x, jsc.center_y, jsc.center_z,
                                jsc.sqr_radius)
    gen = np.random.Generator(np.random.PCG64(51))
    n = 4096
    idx = gen.integers(0, 128, n)
    nv = gen.normal(size=(3, n))
    nv /= np.linalg.norm(nv, axis=0)
    c = np.stack([np.asarray(a) for a in (jsc.center_x, jsc.center_y,
                                          jsc.center_z)]).astype(np.float64)
    r = np.sqrt(np.asarray(jsc.sqr_radius, np.float64))
    h = (c[:, idx] + nv * r[idx]).astype(np.float32)
    nv = (nv * (0.5 + 1.5 * gen.random(n))).astype(np.float32)
    kd, tp = (gen.random((3, n), dtype=np.float32) for _ in range(2))
    wo = -nv / np.linalg.norm(nv, axis=0) * 0.6 + gen.normal(
        size=(3, n)) * 0.3
    wo = (wo / np.linalg.norm(wo, axis=0) * -1).astype(np.float32)
    rough = np.full(n, 0.4, np.float32)
    lights_j = JExplicitLights(*_jax_buffers())
    lights_t = ExplicitLights(*_port_buffers())
    t = [tuple(torch.from_numpy(np.ascontiguousarray(a[i])) for i in
               range(3)) for a in (h, nv, kd, tp, wo)]
    j = [tuple(jnp.asarray(a[i]) for i in range(3))
         for a in (h, nv, kd, tp, wo)]
    brdf_t = brdf_j = None
    if mode == "microfacet":
        nh = tuple(x / torch.sqrt(t[1][0] ** 2 + t[1][1] ** 2
                                  + t[1][2] ** 2) for x in t[1])
        nhj = tuple(jnp.asarray(x.numpy()) for x in nh)

        def brdf_t(wi):
            return brdf.eval_brdf(nh, t[4], wi, t[2],
                                  torch.from_numpy(rough))

        def brdf_j(lx, ly, lz):
            return jbrdf.eval_brdf(*nhj, *j[4], lx, ly, lz, *j[2],
                                   jnp.asarray(rough))
    with jax.disable_jit():
        want = jexplicit_light_contribution(
            jcfg, lights_j, jsphere_intersector(jsc), *j[0], *j[1], *j[2],
            *j[3], brdf_eval=brdf_j)
    got = explicit_light_contribution(
        cfg, lights_t, sphere_intersector(*sc.packed()[:4]), t[0], t[1],
        t[2], t[3], brdf_t)
    g = torch.stack(got).numpy()
    w = np.stack([np.asarray(x) for x in want])
    close = np.isclose(g, w, rtol=1e-5, atol=1e-6).all(0)
    assert close.mean() > 0.995, close.mean()
    lit = w.max(0) > 0
    assert 0.1 < lit.mean() < 0.9


# ---------------------------------------------------------------------------
# The slice against the JAX oracle step
# ---------------------------------------------------------------------------

def _jax_tables(n: int):
    """The (n, 3) albedo and (n, 6) material tables from the JAX package's
    hash functions, which the port's tables then hold (the hash magnifies
    sin's last ulp; tests/test_torch_materials.py gates the port's own)."""
    from l2n_tpu.maths.bump import procedural_bump_amplitude
    from l2n_tpu.maths.sampling import procedural_color
    idx = jnp.arange(n)
    with jax.disable_jit():
        albedo = [procedural_color(idx)]
        mat = [jbrdf.procedural_roughness(idx),
               *jbrdf.procedural_disney_params(idx),
               procedural_bump_amplitude(idx)]
    return tuple(np.stack([np.asarray(c) for c in cols], 1)
                 for cols in (albedo[0], mat))


def _view(cfg):
    """From between a diffuse (odd) sphere and its nearest emissive (even)
    one at the diffuse one (spheres); up close at the diffuse mesh 1, so
    the lights fall on what the camera sees (meshes)."""
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


def _render(cfg, steps):
    """(oracle accum, port accum, port accum without the buffers) after
    `steps` steps from the JAX initial state."""
    jcfg = JRenderConfig.from_json(cfg.to_json())
    jsph = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    cam = Camera.from_config(cfg, _view(cfg)).packed()
    if cfg.scene_kind == "sphere":
        jscene = jsph
        n = cfg.sphere_count
        scene = SphereScene.from_numpy(
            jsph.center_x, jsph.center_y, jsph.center_z,
            jsph.sqr_radius).with_tables(*_jax_tables(n))
        program = SphereProgram
    else:
        jscene = jtessellate(jsph, cfg.disc_lat, cfg.disc_long)
        buf = TriangleBuffers.from_scene(build_triangle_scene(
            compute_spheres(cfg.sphere_count, cfg.world_size,
                            cfg.scene_seed), cfg.disc_lat, cfg.disc_long))
        scene = buf.with_tables(*_jax_tables(buf.albedo.shape[1]))
        program = TriangleProgram
    jstep = jbuild(jcfg, jscene, backend="xla",
                   lights=JExplicitLights(*_jax_buffers()))
    jst = jinit(jcfg)
    a0, o0 = np.asarray(jst.accum), np.asarray(jst.output)
    with jax.disable_jit():
        for _ in range(steps):
            jst = jstep(jst, cam)
    out = [np.asarray(jst.accum)]
    for kw in (dict(zip(("materials", "point_lights", "directional_lights"),
                        _port_buffers())), {}):
        prog = program(cfg, scene=scene, backend="torch", **kw)
        st = FrameState.from_numpy(a0, o0)
        for _ in range(steps):
            st = prog.step(st, cam)
        out.append(st.accum.numpy())
    return out


def _lights_gates(ja, ta, base, cfg):
    lit = (np.abs(ja[:3, :cfg.height, :cfg.width]).max(0) > 0).mean()
    assert lit > 0.05, f"lit coverage {lit}"
    np.testing.assert_array_equal(ta[3], ja[3])
    flipped = (np.abs(ta - ja) > 1e-3).mean()
    assert flipped < 0.01, f"flipped values {flipped}"
    for c in range(3):
        mj, mt = float(ja[c].mean()), float(ta[c].mean())
        assert abs(mj - mt) < 0.02 * max(mj, 1e-6), (c, mj, mt)
    assert ta[:3].sum() > 1.05 * base[:3].sum()  # the lights add light


SPHERE_CFG = RenderConfig(width=128, height=64, sphere_count=16,
                          emissive_every=2)
TRI_CFG = RenderConfig(width=128, height=32, sphere_count=4, disc_lat=4,
                       disc_long=4, scene_kind="triangle", max_bounces=1)


@pytest.mark.parametrize("mode", ["procedural", "microfacet"])
def test_sphere_lights_match_xla_oracle(mode):
    cfg = SPHERE_CFG.replace(material_mode=mode).validate()
    _lights_gates(*_render(cfg, 2), cfg)


@pytest.mark.parametrize("mode", ["procedural", "microfacet"])
def test_triangle_lights_match_xla_oracle(mode):
    """One step of one bounce: the JAX triangle oracle op by op sweeps
    every triangle in Python, once more per light."""
    cfg = TRI_CFG.replace(material_mode=mode).validate()
    _lights_gates(*_render(cfg, 1), cfg)


def test_lights_refuse_the_wavefront_step():
    """As the JAX package: explicit lights, or the Phong override alone,
    with wavefront=True raise ValueError; empty buffers do not."""
    cfg = SPHERE_CFG.replace(wavefront=True).validate()
    mats, pls, dls = _port_buffers()
    for kw in ({"point_lights": pls}, {"directional_lights": dls},
               {"materials": mats}):
        with pytest.raises(ValueError, match="wavefront"):
            SphereProgram(cfg, backend="torch", **kw)
    SphereProgram(cfg, backend="torch", **dict(zip(
        ("materials", "point_lights", "directional_lights"),
        materials.empty_lights())))
