"""The wavefront sphere step of l2n_tpu_torch on the CPU (backend="torch"
and the wrappers' plain versions), held against the JAX package and the
port's own single-pass step.

Inputs come from numpy with a seed. The JAX side runs op by op
(`jax.disable_jit`, as tests/test_torch_render.py explains). The JAX
package's own wavefront step, a Pallas kernel in interpret mode, is not
run here: tests/test_kernels.py::TestWavefront holds it equal to the JAX
single pass and the XLA oracle, which this file holds the port against.
"""

import json
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.ops import pathtrace as jpathtrace
from l2n_tpu.ops.scenes import sphere_anyhit as jsphere_anyhit
from l2n_tpu.ops.scenes import sphere_intersector as jsphere_intersector
from l2n_tpu.render.state import init_frame_state as jinit
from l2n_tpu.render.step import build_render_step as jbuild
from l2n_tpu.rng import sampler as jsampler
from l2n_tpu.scene.spheres import compute_spheres as jcompute
from l2n_tpu_torch.app.application import main
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops import pathtrace
from l2n_tpu_torch.ops.kernels import wavefront as wf
from l2n_tpu_torch.ops.kernels.common import launches
from l2n_tpu_torch.ops.kernels.sphere_pt import sphere_pt_plain
from l2n_tpu_torch.ops.scenes import sphere_anyhit, sphere_intersector
from l2n_tpu_torch.render.state import FrameState, init_frame_state
from l2n_tpu_torch.render.step import build_render_step
from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
from l2n_tpu_torch.rng import sampler as tsampler
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
SMALL = dict(width=128, height=64, sphere_count=16, emissive_every=2)


def _jcfg(cfg):
    return JRenderConfig.from_json(cfg.to_json())


def _gen(seed):
    return np.random.Generator(np.random.PCG64(seed))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


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


# ---------------------------------------------------------------------------
# The sampler's resume point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("next_pair,has_spare", [(3, True), (3, False),
                                                 (1, True), (5, False)])
def test_sampler_resumed_bit_exact(next_pair, has_spare):
    """ThreefrySampler.resumed and draw_position against the JAX package's
    on random keys, pixels and samples: every draw bit-equal."""
    gen = _gen(31 + next_pair)
    seed, stream = (int(v) for v in gen.integers(0, 2**32, 2))
    pix = gen.integers(0, 2**32, 4096, dtype=np.uint32)
    samp = gen.integers(0, 10_000, 4096).astype(np.uint32)
    mp = jsampler.max_pairs_per_sample(3)
    js = jsampler.ThreefrySampler.resumed(seed, stream, jnp.asarray(pix),
                                          jnp.asarray(samp), mp, next_pair,
                                          has_spare)
    ts = tsampler.ThreefrySampler.resumed(seed, stream, _t(pix), _t(samp),
                                          mp, next_pair, has_spare)
    assert ts.draw_position == js.draw_position == (next_pair, has_spare)
    for call in ("draw1", "draw2", "draw1", "draw1"):
        j = getattr(js, call)()
        t = getattr(ts, call)()
        j = j if isinstance(j, tuple) else (j,)
        t = t if isinstance(t, tuple) else (t,)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert ts.draw_position == js.draw_position


@pytest.mark.parametrize("max_bounces", [1, 2, 3])
def test_wavefront_draw_position_matches_jax(max_bounces):
    """Jitter pair 0, hemisphere pair 1, RR on pair 2 with its second word
    pending: (3, True) whatever the depth, as the JAX package finds it."""
    cfg = RenderConfig(max_bounces=max_bounces, **SMALL)
    jscene = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    want = jpathtrace.wavefront_draw_position(_jcfg(cfg),
                                              jsphere_intersector(jscene))
    assert pathtrace.wavefront_draw_position(cfg) == tuple(want) == (3, True)


# ---------------------------------------------------------------------------
# The split path functions, op by op against JAX's
# ---------------------------------------------------------------------------

N_LANES = 20_000


def _primary_inputs(cfg, seed):
    """Random pixels of the aimed view with random pixel and sample
    indices: the same threefry-jittered primary rays on both sides."""
    gen = _gen(seed)
    px = gen.integers(0, cfg.width, N_LANES).astype(np.float32)
    py = gen.integers(0, cfg.height, N_LANES).astype(np.float32)
    pix = gen.integers(0, 2**32, N_LANES, dtype=np.uint32)
    samp = gen.integers(0, 1000, N_LANES).astype(np.uint32)
    return _aimed_camera(cfg).packed(), px, py, pix, samp


def _run_jax_primary(cfg, cam, px, py, pix, samp):
    jscene = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    mp = jsampler.max_pairs_per_sample(cfg.max_bounces)
    with jax.disable_jit():
        s = jsampler.ThreefrySampler(cfg.seed, 0, jnp.asarray(pix),
                                     jnp.asarray(samp), mp)
        rays = jpathtrace.generate_rays(_jcfg(cfg), jnp.asarray(cam),
                                        jnp.asarray(px), jnp.asarray(py),
                                        *s.draw2())
        out = jpathtrace.trace_wavefront_primary(
            _jcfg(cfg), jsphere_intersector(jscene), s, *rays)
    return [np.broadcast_to(np.asarray(a), (N_LANES,)) for a in out[:12]]


def _port_scene(cfg):
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    cx, cy, cz, r2 = sc.center_x, sc.center_y, sc.center_z, sc.sqr_radius
    return (sphere_intersector(cx, cy, cz, r2), sphere_anyhit(cx, cy, cz, r2),
            sc.albedo)


@pytest.mark.parametrize("extra", [{}, {"env_mode": "none"}],
                         ids=["reference", "env_none"])
def test_trace_wavefront_primary_matches_jax(extra):
    """All 12 outputs bit-equal (radiance, cast origin, throughput) except
    the scattered direction, where torch's and XLA's CPU sin/cos differ by
    an ulp on a few lanes: at most 1.2e-7 on under 1% of lanes. The cast
    origin absorbs that ulp (eps * d rounds away)."""
    cfg = RenderConfig(max_bounces=3, **SMALL, **extra)
    cam, px, py, pix, samp = _primary_inputs(cfg, 41)
    want = _run_jax_primary(cfg, cam, px, py, pix, samp)
    intersect, _, albedo = _port_scene(cfg)
    s = tsampler.ThreefrySampler(cfg.seed, 0, _t(pix), _t(samp),
                                 tsampler.max_pairs_per_sample(3))
    rays = pathtrace.generate_rays(cfg, torch.from_numpy(cam),
                                   torch.from_numpy(px), torch.from_numpy(py),
                                   *s.draw2())
    got = pathtrace.trace_wavefront_primary(cfg, intersect, albedo, s, *rays)
    assert len(got) == 12
    got = [np.broadcast_to(a.numpy(), (N_LANES,)) for a in got]
    for i in (0, 1, 2, 3, 4, 5, 9, 10, 11):
        np.testing.assert_array_equal(got[i], want[i], err_msg=str(i))
    for i in (6, 7, 8):
        d = np.abs(got[i] - want[i])
        assert d.max() <= 1.2e-7 and (d > 0).mean() < 1e-2
    alive = want[3] < pathtrace.WAVEFRONT_FAR_THRESHOLD
    assert 0.02 < alive.mean() < 0.5  # survivors and dead lanes alike
    # primary emission, and the sky unless it is off
    assert (want[0] > 0).mean() > (1e-3 if extra else 0.05)


@pytest.mark.parametrize("max_bounces", [1, 2, 3])
def test_trace_wavefront_continue_matches_jax(max_bounces):
    """Pass B's path function on the survivors of JAX's pass A, each side
    with its own resumed sampler: the contributions bit-equal."""
    cfg = RenderConfig(max_bounces=max_bounces, **SMALL)
    cam, px, py, pix, samp = _primary_inputs(cfg, 43)
    primary = _run_jax_primary(cfg, cam, px, py, pix, samp)
    alive = primary[3] < pathtrace.WAVEFRONT_FAR_THRESHOLD
    planes = [np.ascontiguousarray(a[alive]) for a in primary[3:12]]
    mp = jsampler.max_pairs_per_sample(max_bounces)
    jscene = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    with jax.disable_jit():
        js = jsampler.ThreefrySampler.resumed(
            cfg.seed, 0, jnp.asarray(pix[alive]), jnp.asarray(samp[alive]),
            mp, 3, True)
        want = jpathtrace.trace_wavefront_continue(
            _jcfg(cfg), jsphere_intersector(jscene), js,
            *(jnp.asarray(a) for a in planes),
            intersect_anyhit=jsphere_anyhit(jscene))
    intersect, anyhit, albedo = _port_scene(cfg)
    ts = tsampler.ThreefrySampler.resumed(cfg.seed, 0, _t(pix[alive]),
                                          _t(samp[alive]), mp, 3, True)
    got = pathtrace.trace_wavefront_continue(
        cfg, intersect, anyhit, albedo, ts,
        *(torch.from_numpy(a) for a in planes))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # survivors found light (with one bounce only the sky, mostly occluded)
    assert (np.asarray(want[0]) > 0).mean() > (0.05 if max_bounces > 1
                                               else 1e-3)


# ---------------------------------------------------------------------------
# The compaction
# ---------------------------------------------------------------------------

def _jax_compaction(rays, meta):
    """The JAX step's compaction (l2n_tpu/ops/kernels/wavefront.py
    kernel_step: the rank permutation, its inverse and the gathers), with
    jnp on numpy lane arrays: (comp rays, comp meta, inv, n_alive)."""
    raysf = jnp.asarray(rays.reshape(rays.shape[0], -1))
    n = raysf.shape[1]
    alive = raysf[0] < jnp.float32(pathtrace.WAVEFRONT_FAR_THRESHOLD)
    csum = jnp.cumsum(alive.astype(jnp.int32))
    n_alive = csum[-1:]
    iota = jnp.arange(n, dtype=jnp.int32)
    perm = jnp.where(alive, csum - 1, n_alive[0] + iota - (csum - 1) - 1)
    inv = jnp.zeros((n,), jnp.int32).at[perm].set(iota, unique_indices=True)
    metaf = jnp.asarray(meta.reshape(2, n))
    return (np.asarray(raysf[:, inv]), np.asarray(metaf[:, inv]),
            np.asarray(inv), int(n_alive[0]))


@pytest.mark.parametrize("alive_fraction", [0.0, 0.2, 0.5, 1.0])
def test_compact_survivors_matches_jax_formula(alive_fraction):
    """The plain pass A's compaction on a random alive mask equals the JAX
    package's formula (wavefront.py's kernel_step, run with jnp): the ray
    and meta planes gathered by the inverse rank permutation, the lane
    plane that permutation itself, and n_alive; write_back then puts each
    of the first n_alive slots back at its lane."""
    gen = _gen(int(alive_fraction * 10) + 51)
    n = 4 * 4096
    alive = gen.random(n) < alive_fraction
    rays = gen.normal(size=(9, n)).astype(np.float32)
    rays[0] = np.where(alive, rays[0], np.float32(3.0e30))
    meta = gen.integers(-2**31, 2**31, (2, n)).astype(np.int32)
    comp, comp_meta, n_alive = wf.compact_survivors(
        torch.from_numpy(rays).view(9, 4, 64, 64),
        torch.from_numpy(meta).view(2, 4, 64, 64))
    jcomp, jmeta, jinv, jn = _jax_compaction(rays, meta)
    np.testing.assert_array_equal(comp.numpy(), jcomp)
    np.testing.assert_array_equal(comp_meta[:2].numpy(), jmeta)
    np.testing.assert_array_equal(comp_meta[2].numpy(), jinv)
    assert n_alive.dtype == torch.int32 and int(n_alive[0]) == jn
    na = int(alive.sum())
    assert jn == na
    np.testing.assert_array_equal(comp[:, :na].numpy(), rays[:, alive])

    back = torch.from_numpy(np.where(alive, np.float32(np.nan),
                                     np.float32(0.0))[None].repeat(3, 0))
    contrib = torch.full((3, n), float("nan"))
    contrib[:, :na] = comp[3:6, :na]
    wf.write_back(back, contrib, comp_meta, n_alive)
    np.testing.assert_array_equal(back.numpy(), np.where(alive, rays[3:6],
                                                         0.0))


def test_compaction_reads_nothing_back():
    """The compaction and the write-back run on the meta device, which
    holds shapes and no data: none of their operations reads a value back
    to the host (no .item(), no nonzero, no int(n_alive))."""
    rays = torch.empty((9, 2, 32, 128), device="meta")
    meta = torch.empty((2, 2, 32, 128), dtype=torch.int32, device="meta")
    comp, comp_meta, n_alive = wf.compact_survivors(rays, meta)
    assert comp.shape == (9, 8192) and comp_meta.shape == (3, 8192)
    assert n_alive.shape == (1,) and comp_meta.dtype == torch.int32
    back = torch.empty((3, 2, 32, 128), device="meta")
    wf.write_back(back, torch.empty((3, 8192), device="meta"), comp_meta,
                  n_alive)
    assert back.shape == (3, 2, 32, 128) and back.device.type == "meta"


@pytest.mark.parametrize("extra", [{}, {"spp_per_step": 2}],
                         ids=["reference", "spp2"])
def test_pass_a_plain_matches_jax_compaction(extra):
    """The plain pass A's outputs against the JAX step's compaction of its
    own lanes (run with jnp): the survivors' ray and meta planes in stable
    lane order, each slot's lane, n_alive; col by lane; back 0 at the dead
    lanes and NaN (pass B's to write) at the survivors'."""
    cfg = RenderConfig(**SMALL, **extra).validate()
    sched, cam, spheres, accum, _ = _pass_inputs(cfg)
    rays, col, meta = wf.primary_lanes_plain(cfg, sched, cam, spheres, accum)
    a = wf.wavefront_pass_a_plain(cfg, sched, cam, spheres, accum)
    jcomp, jmeta, jinv, jn = _jax_compaction(rays.numpy(), meta.numpy())
    assert int(a.n_alive[0]) == jn and 0 < jn < jinv.size
    np.testing.assert_array_equal(a.rays[:, :jn].numpy(), jcomp[:, :jn])
    np.testing.assert_array_equal(a.meta[:2, :jn].numpy(), jmeta[:, :jn])
    np.testing.assert_array_equal(a.meta[2, :jn].numpy(), jinv[:jn])
    np.testing.assert_array_equal(a.col.numpy(), col.numpy())
    alive = rays[0].numpy() < pathtrace.WAVEFRONT_FAR_THRESHOLD
    np.testing.assert_array_equal(np.isnan(a.back.numpy()), alive[None]
                                  .repeat(3, 0))
    assert (a.back.numpy()[:, ~alive] == 0).all()


def test_pass_b_write_back_matches_scatter_back():
    """The plain pass B's write by lane against the scatter-back it
    replaces (the JAX step's: contributions gathered from each lane's rank,
    0 where no path went on): the same back, bit for bit, on pass A's
    survivors of the aimed small config with a padded tail of garbage
    slots past n_alive."""
    cfg = RenderConfig(spp_per_step=2, max_bounces=3, **SMALL).validate()
    sched, cam, spheres, accum, _ = _pass_inputs(cfg)
    rays, col, meta = wf.primary_lanes_plain(cfg, sched, cam, spheres, accum)
    a = wf.wavefront_pass_a_plain(cfg, sched, cam, spheres, accum)
    na = int(a.n_alive[0])
    gen = _gen(61)
    comp_meta = a.meta.clone()
    comp_meta[:, na:] = torch.from_numpy(gen.integers(
        -2**31, 2**31, (3, comp_meta.shape[1] - na)).astype(np.int32))
    back = a.back.clone()
    wf.wavefront_pass_b_plain(cfg, cam, spheres, a.rays, comp_meta,
                              a.n_alive, back)

    # the scatter-back: the contributions of every slot, gathered by perm
    intersect, anyhit, albedo = wf._scene(cfg, spheres)
    next_pair, has_spare = pathtrace.wavefront_draw_position(cfg)
    sampler = tsampler.ThreefrySampler.resumed(
        cfg.seed, 0, a.meta[0], a.meta[1],
        tsampler.max_pairs_per_sample(cfg.max_bounces), next_pair, has_spare)
    contrib = torch.stack(pathtrace.trace_wavefront_continue(
        cfg, intersect, anyhit, albedo, sampler, *a.rays))
    alive = rays.reshape(9, -1)[0] < pathtrace.WAVEFRONT_FAR_THRESHOLD
    rank = torch.cumsum(alive, 0) - 1
    iota = torch.arange(alive.numel())
    perm = torch.where(alive, rank, na + iota - rank - 1)
    want = torch.where(alive, contrib.index_select(1, perm),
                       torch.zeros(())).view(col.shape)
    np.testing.assert_array_equal(back.numpy(), want.numpy())
    assert (want.view(3, -1)[:, alive] > 0).any()  # survivors found light


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [{}, {"spp_per_step": 2, "max_bounces": 3},
                                   {"max_bounces": 1}],
                         ids=["reference", "spp2_bounces3", "bounces1"])
def test_wavefront_step_matches_single_pass_and_xla_oracle(extra):
    """4 steps of the aimed small config through build_render_step(...,
    backend="torch"): the wavefront step is bit-equal to the port's single
    pass; against the JAX XLA step (op by op) accum[3] is equal, accum RMSE
    < 1e-3 and output flips < 2e-3 (0 expected: the gates of
    tests/test_torch_render.py)."""
    cfg = RenderConfig(**SMALL, **extra).validate()
    cam = _aimed_camera(cfg).packed()
    jscene = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    jstep = jbuild(_jcfg(cfg), jscene, backend="xla")
    jst = jinit(_jcfg(cfg))
    with jax.disable_jit():
        for _ in range(4):
            jst = jstep(jst, cam)
    ja, jo = np.asarray(jst.accum), np.asarray(jst.output)
    scene = SphereScene.from_numpy(jscene.center_x, jscene.center_y,
                                   jscene.center_z, jscene.sqr_radius)
    states = []
    for wavefront in (True, False):
        step = build_render_step(cfg.replace(wavefront=wavefront), scene,
                                 backend="torch", device="cpu")
        st = FrameState.from_numpy(np.zeros_like(ja), np.zeros_like(jo))
        for _ in range(4):
            st = step(st, cam)
        states.append(st.to_numpy())
    (wa, wo, offset, iteration), (sa, so, _, _) = states
    np.testing.assert_array_equal(wa, sa)
    np.testing.assert_array_equal(wo, so)
    assert (offset, iteration) == (int(jst.tile_offset), int(jst.iteration))
    assert (ja[:3].max(0) > 0).mean() > 0.3  # real lit coverage
    np.testing.assert_array_equal(wa[3], ja[3])
    assert np.sqrt(((wa - ja) ** 2).mean()) < 1e-3
    assert (np.abs(wo - jo) > 1e-3).mean() < 2e-3


def test_wavefront_step_matches_sphere_golden():
    """The sphere golden (the jitted XLA oracle, 256x128, 4 whole-frame
    steps, 128 spheres) through RenderConfig(wavefront=True), with
    tests/test_golden_render.py's cross-implementation gates."""
    with np.load(GOLDEN) as data:
        cfg = RenderConfig.from_json(bytes(data["config"]).decode())
        want = data["accum"]
    cfg = cfg.replace(wavefront=True)
    step = build_render_step(cfg, compute_spheres(
        cfg.sphere_count, cfg.world_size, cfg.scene_seed), backend="torch")
    st = init_frame_state(cfg)
    cam = Camera.from_config(cfg).packed()
    for _ in range(4):
        st = step(st, cam)
    got = st.accum.numpy()
    np.testing.assert_array_equal(got[3], want[3])
    assert (np.abs(got - want) > 1e-3).mean() < 0.03
    mean_diff = np.abs(got[:3] / np.maximum(got[3], 1)
                       - want[:3] / np.maximum(want[3], 1))
    assert np.sqrt((mean_diff ** 2).mean()) < 0.03


def _pass_inputs(cfg):
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    k = cfg.effective_tiles_per_step
    sched = scheduled_tiles(torch.as_tensor(tile_grid(cfg)), 0, k)
    st = init_frame_state(cfg)
    st.accum[3] = 5.0
    return sched, _aimed_camera(cfg).packed(), sc.packed(), st.accum, st.output


def test_wavefront_wrappers_cpu_are_plain():
    """On CPU tensors each pass's wrapper runs its plain version (no
    launch counted), and the step chains them: the fused step's image."""
    cfg = RenderConfig(spp_per_step=2, **SMALL).validate()
    sched, cam, spheres, accum, output = _pass_inputs(cfg)
    before = dict(launches)
    a = wf.wavefront_pass_a(cfg, sched, cam, spheres, accum)
    b = wf.wavefront_pass_a_plain(cfg, sched, cam, spheres, accum)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert a.col.shape == a.back.shape == (3, 1, 64, 128)
    assert a.rays.shape == (9, 8192) and a.meta.dtype == torch.int32
    na = int(a.n_alive[0])
    # meta: pixel index = col + row * padded width, sample = count + s
    # (lanes 0..4095 are sample 0), lane = its lane
    lane = a.meta[2, :na]
    np.testing.assert_array_equal(a.meta[1, :na].numpy(),
                                  np.where(lane.numpy() < 4096, 5, 6))
    tx, ty = (int(v) for v in sched[0])
    row, c = ty * 32 + lane % 4096 // 128, tx * 128 + lane % 128
    np.testing.assert_array_equal(a.meta[0, :na].numpy(),
                                  (row * cfg.padded_width + c).numpy())
    back1, back2 = a.back.clone(), a.back.clone()
    wf.wavefront_pass_b(cfg, cam, spheres, a.rays, a.meta, a.n_alive, back1)
    wf.wavefront_pass_b_plain(cfg, cam, spheres, a.rays, a.meta, a.n_alive,
                              back2)
    np.testing.assert_array_equal(back1.numpy(), back2.numpy())
    assert not back1.isnan().any()
    acc1, out1 = accum.clone(), output.clone()
    wf.wavefront_pass_c(cfg, sched, a.col, back1, acc1, out1)
    wf.wavefront_pass_c_plain(cfg, sched, a.col, back1, accum, output)
    np.testing.assert_array_equal(acc1.numpy(), accum.numpy())
    np.testing.assert_array_equal(out1.numpy(), output.numpy())
    # the whole step against the fused plain step from the same state
    st2, st3 = _pass_inputs(cfg)[3:], _pass_inputs(cfg)[3:]
    wf.sphere_wavefront_step(cfg, sched, cam, spheres, *st2)
    sphere_pt_plain(cfg, sched, cam, spheres, *st3)
    np.testing.assert_array_equal(st2[0].numpy(), st3[0].numpy())
    assert (st2[0][3] == 7).sum() == 32 * 128
    assert dict(launches) == before  # plain versions are no launches


def test_wavefront_wrapper_checks():
    cfg = RenderConfig(**SMALL).validate()
    sched, cam, spheres, accum, output = _pass_inputs(cfg)
    with pytest.raises(TypeError, match="sched"):
        wf.wavefront_pass_a(cfg, sched.long(), cam, spheres, accum)
    with pytest.raises(ValueError, match="camera"):
        wf.wavefront_pass_a(cfg, sched, cam[:9], spheres, accum)
    with pytest.raises(ValueError, match="no kernel"):
        wf.wavefront_pass_a(cfg, sched.to("meta"), cam, spheres.to("meta"),
                            accum.to("meta"))
    col, back, rays, meta, n_alive = wf.wavefront_pass_a(cfg, sched, cam,
                                                         spheres, accum)
    with pytest.raises(TypeError, match="n_alive"):
        wf.wavefront_pass_b(cfg, cam, spheres, rays, meta, n_alive.long(),
                            back)
    with pytest.raises(ValueError, match="whole tiles"):
        wf.wavefront_pass_b(cfg, cam, spheres, rays[:, :100].contiguous(),
                            meta[:, :100].contiguous(), n_alive, back)
    with pytest.raises(TypeError, match="meta"):
        wf.wavefront_pass_b(cfg, cam, spheres, rays, meta.float(), n_alive,
                            back)
    with pytest.raises(ValueError, match="meta"):
        wf.wavefront_pass_b(cfg, cam, spheres, rays, meta[:2].contiguous(),
                            n_alive, back)
    with pytest.raises(ValueError, match="back"):
        wf.wavefront_pass_b(cfg, cam, spheres, rays, meta, n_alive,
                            back.view(3, -1))
    with pytest.raises(ValueError, match="back"):
        wf.wavefront_pass_c(cfg, sched, col, col[:, :, :16], accum, output)
    with pytest.raises(ValueError, match="output"):
        wf.wavefront_pass_c(cfg, sched, col, col, accum, output[:, :32])
    # NEE was refused (Queue 1 #9) until its third slice: pass A now
    # renders it, and under MIS a survivor carries a 10th ray plane (the
    # pdf of its direction). Fog, which the port renders since #9's fourth
    # slice, the split takes no work of: the config's fog + wavefront error.
    with pytest.raises(ValueError, match=r"fog \+ wavefront"):
        wf.wavefront_pass_a(cfg.replace(fog_density=0.01), sched, cam,
                            spheres, accum)
    for mis, planes in ((False, 9), (True, 10)):
        ncfg = cfg.replace(nee=True, mis=mis)
        a = wf.wavefront_pass_a(ncfg, sched, cam, spheres, accum)
        assert a.rays.shape == (planes, 4096) and 0 < int(a.n_alive[0])
        assert bool(torch.isfinite(a.col).all())
        lanes = wf.wavefront_lanes(ncfg, 1, torch.device("cpu"))
        assert lanes.rays.shape == (planes, 4096)
    lanes = wf.wavefront_lanes(cfg, 1, torch.device("cpu"))
    assert [t.shape for t in lanes] == [(3, 1, 32, 128), (3, 1, 32, 128),
                                        (9, 4096), (3, 4096), (1,)]
    # rng="tpu_hw" was refused until the Philox sampler was ported: the
    # wavefront step now renders it, to the bit the fused step's image.
    hw = cfg.replace(rng="tpu_hw")
    accums = []
    for wavefront in (True, False):
        step = build_render_step(hw.replace(wavefront=wavefront),
                                 compute_spheres(16), backend="torch")
        st = step(init_frame_state(hw), cam)
        accums.append(st.accum.numpy())
    np.testing.assert_array_equal(accums[0], accums[1])
    assert accums[0][3].sum() > 0
    with pytest.raises(ValueError, match="stateful"):
        wf.wavefront_pass_a(cfg.replace(rng="tauslcg"), sched, cam, spheres,
                            accum)
    with pytest.raises(ValueError, match="stateless"):
        build_render_step(cfg.replace(wavefront=True, rng="tinymt"),
                          compute_spheres(16), backend="torch")


def test_wavefront_cli_config(tmp_path):
    """The path a user reaches with `--config` holding "wavefront": true:
    the CLI renders it (plain versions), and the frames equal the CLI's
    single-pass frames."""
    images = []
    for wavefront in (True, False):
        cfg = RenderConfig(wavefront=wavefront, **SMALL)
        path = tmp_path / f"cfg_{wavefront}.json"
        path.write_text(cfg.to_json())
        assert json.loads(path.read_text())["wavefront"] is wavefront
        out = tmp_path / f"frames_{wavefront}"
        assert main(["--config", str(path), "--frames", "2", "--out",
                     str(out), "--every", "1", "--backend", "torch",
                     "--renderer", "spherePT"]) == 0
        pngs = sorted(out.glob("*.png"))
        assert [p.name for p in pngs] == ["frame_00000.png",
                                          "frame_00001.png"]
        images.append([p.read_bytes() for p in pngs])
    assert images[0] == images[1]
