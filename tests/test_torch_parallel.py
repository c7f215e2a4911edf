"""The port's multi-card renderer (l2n_tpu_torch.parallel) on the CPU:
held against the JAX package's l2n_tpu.parallel.

In process: mesh_factors, slab_tile_grids and the scheduled pixel mask
equal the JAX package's; each (tile_rank, sample_rank) slab body of the
plain step (backend="torch") matches the JAX oracle step `_xla_step` on
the same slab, row offset and stream, run op by op (`jax.disable_jit`, see
tests/test_torch_render.py), for spheres, triangles and fog; a schedule
that names a tile twice renders it once; the refusals.

Spawned: one launch of 4 gloo ranks on the CPU (parallel/launch.py,
rendezvous through a file, so that concurrent test workers share no
port) runs every sharded case of this file in turn, at the small config
of tests/test_parallel.py (256x128, 128x32 tiles, 16 spheres), with
meshes (2, 2), (4, 1) and (1, 2) (ranks 2 and 3 outside the last). The
gathered results must equal the slab bodies rendered here, bit for bit;
the stateful modes on (4, 1) must equal one single-card render; sessions
move both ways between the packages.
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parallel_ranks
from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.parallel import make_device_mesh as jmake_device_mesh
from l2n_tpu.parallel import mesh_factors as jmesh_factors
from l2n_tpu.parallel.step import ShardedFrameState as JShardedFrameState
from l2n_tpu.parallel.step import slab_tile_grids as jslab_tile_grids
from l2n_tpu.render.state import FrameState as JFrameState
from l2n_tpu.render.step import _xla_step, make_intersector
from l2n_tpu.render.tiles import scheduled_pixel_mask as jscheduled_pixel_mask
from l2n_tpu.scene import build_triangle_scene as jbuild_triangles
from l2n_tpu.scene import compute_spheres as jcompute
from l2n_tpu.utils.checkpoint import load_sharded_session as jload_sharded
from l2n_tpu.utils.checkpoint import save_sharded_session as jsave_sharded
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.camera.camera import slab_camera
from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.kernels.wavefront import (
    sphere_wavefront_step_plain,
    wavefront_pass_a,
)
from l2n_tpu_torch.parallel import mesh_factors
from l2n_tpu_torch.parallel.launch import launch
from l2n_tpu_torch.parallel.step import (
    SlabStep,
    init_slab_state,
    slab_tile_grids,
)
from l2n_tpu_torch.render.state import init_frame_state
from l2n_tpu_torch.render.step import build_render_step
from l2n_tpu_torch.render.tiles import scheduled_pixel_mask
from l2n_tpu_torch.scene.spheres import SphereScene, compute_spheres
from l2n_tpu_torch.scene.tessellate import TriangleScene, build_triangle_scene


def _forget_port():
    """Drop the port's modules from sys.modules (ROADMAP Queue 3 #12):
    tests/test_aot_cache.py scans every loaded module named "l2n_tpu*"."""
    for name in [m for m in sys.modules if m.startswith("l2n_tpu_torch")]:
        del sys.modules[name]


_forget_port()


@pytest.fixture(scope="module", autouse=True)
def _port_unloaded_after_module():
    # One torch thread while this module runs (tests/test_torch_render.py).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _forget_port()


# tests/test_parallel.py's config, with every other sphere a light so that
# the aimed view is lit.
CFG = RenderConfig(width=256, height=128, tile_width=128, tile_height=32,
                   sphere_count=16, emissive_every=2,
                   tiles_per_step=1).validate()
# tests/test_torch_triangle.py's small mesh scene, two slabs of one tile.
TRI_CFG = RenderConfig(width=128, height=64, tile_width=128, tile_height=32,
                       sphere_count=8, disc_lat=8, disc_long=4,
                       tiles_per_step=1, scene_kind="triangle").validate()
SCENE_FIELDS = ("vertices", "normals", "tex_coords", "indices",
                "triangle_count", "index_offset")


def _jcfg(cfg):
    return JRenderConfig.from_json(cfg.to_json())


def _aimed_view(cfg):
    """Between a diffuse (odd) sphere and its nearest emissive (even) one,
    looking at the diffuse one (tests/test_brdf.py's aim); for meshes, up
    close at the emissive sphere 0 (tests/test_torch_triangle.py)."""
    sc = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c = np.stack([sc.center_x.numpy(), sc.center_y.numpy(),
                  sc.center_z.numpy()], 1)
    r = np.sqrt(sc.sqr_radius.numpy())
    up = np.array([0.0, 1.0, 0.0], np.float32)
    if cfg.scene_kind == "triangle":
        return look_at(c[0] + np.array([0.0, 0.0, 2.5 * r[0]], np.float32),
                       c[0].astype(np.float32), up)
    odd, even = np.arange(1, cfg.sphere_count, 2), np.arange(0, cfg.sphere_count, 2)
    dm = np.linalg.norm(c[odd][:, None] - c[even][None], axis=2)
    oi, ei = np.unravel_index(np.argmin(dm), dm.shape)
    j, e = odd[oi], even[ei]
    to_e = (c[e] - c[j]) / np.linalg.norm(c[e] - c[j])
    return look_at((c[j] + to_e * 5.0 * r[j]).astype(np.float32),
                   c[j].astype(np.float32), up)


def _camera(cfg):
    return Camera.from_config(cfg, _aimed_view(cfg)).packed()


def _scenes(cfg):
    """(the JAX scene, the port's scene built from the same arrays)."""
    jscene = jcompute(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    if cfg.scene_kind == "triangle":
        jscene = jbuild_triangles(jscene, cfg.disc_lat, cfg.disc_long)
        return jscene, TriangleScene(*(getattr(jscene, f)
                                       for f in SCENE_FIELDS))
    return jscene, SphereScene.from_numpy(jscene.center_x, jscene.center_y,
                                          jscene.center_z,
                                          jscene.sqr_radius)


def _port_scene(cfg):
    """The scene the spawned ranks build (torch_parallel_ranks)."""
    scene = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    if cfg.scene_kind == "triangle":
        scene = build_triangle_scene(scene, cfg.disc_lat, cfg.disc_long)
    return scene


def _slab_bodies(cfg, n_tile, n_sample, steps, scene=None, slabs=None):
    """{(tile_rank, sample_rank): slab FrameState after `steps` steps} of
    the plain slab body in this process, for every slab of the mesh or
    those of `slabs`."""
    scene = _port_scene(cfg) if scene is None else scene
    cam = _camera(cfg)
    out = {}
    for t in range(n_tile):
        for s in range(n_sample):
            if slabs is not None and (t, s) not in slabs:
                continue
            body = SlabStep(cfg, scene, n_tile, t, s, backend="torch")
            st = init_slab_state(cfg, n_tile, t)
            for _ in range(steps):
                st = body(st, cam)
            out[(t, s)] = st
    return out


def _jax_slab_step(cfg, jscene, n_tile, tile_rank, sample_rank, state, cam):
    """One JAX oracle step of a slab, op by op (the JAX sharded step's
    body without the fold)."""
    jcfg = _jcfg(cfg)
    intersect, miss, lights, anyhit = make_intersector(jcfg, jscene)
    h = cfg.padded_height // n_tile
    with jax.disable_jit():
        return _xla_step(jcfg, intersect, miss,
                         jnp.asarray(jslab_tile_grids(jcfg, n_tile)[tile_rank]),
                         state, jnp.asarray(cam), row_offset=tile_rank * h,
                         stream=sample_rank * n_tile + tile_rank,
                         light_sampler=lights, intersect_anyhit=anyhit)


def _jax_zero_slab(cfg, n_tile):
    h = cfg.padded_height // n_tile
    return JFrameState(accum=jnp.zeros((4, h, cfg.padded_width)),
                       output=jnp.zeros((3, h, cfg.padded_width)),
                       tile_offset=jnp.int32(0), iteration=jnp.int32(0),
                       rng_state=None)


def _display(folded, gamma):
    """The sharded step's display of a folded accumulation at its touched
    pixels (JAX's pow form), 0 elsewhere."""
    rgb = np.power(np.maximum(folded[:3], 0.0)
                   / np.maximum(folded[3:4], np.float32(1e-20)),
                   np.float32(gamma))
    return np.where(folded[3:4] > 0, rgb, 0.0).astype(np.float32)


# --- in process ------------------------------------------------------------

HEADLINE = RenderConfig(width=1024, height=1024, tile_height=32,
                        tile_width=128, tiles_per_step=1024,
                        spp_per_step=4, rng="tpu_hw", fast_math=True)


@pytest.mark.parametrize("cfg", [None, CFG, RenderConfig(), HEADLINE,
                                 TRI_CFG],
                         ids=["none", "small", "default", "headline",
                              "triangle"])
def test_mesh_factors_match_jax(cfg):
    jcfg = None if cfg is None else _jcfg(cfg)
    for n in range(1, 17):
        assert mesh_factors(n, cfg) == jmesh_factors(n, jcfg), n
    if cfg is not None and cfg.tile_count_y == 23:  # the default config
        assert mesh_factors(2, cfg) == (1, 2)


@pytest.mark.parametrize("cfg,n_tile", [
    (CFG, 1), (CFG, 2), (CFG, 4), (HEADLINE, 2), (HEADLINE, 8),
    (RenderConfig(tile_shuffle_seed=7), 23), (TRI_CFG, 2)])
def test_slab_tile_grids_match_jax(cfg, n_tile):
    got = slab_tile_grids(cfg, n_tile)
    want = jslab_tile_grids(_jcfg(cfg), n_tile)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_slab_tile_grids_indivisible_raises():
    with pytest.raises(ValueError):
        jslab_tile_grids(_jcfg(CFG), 3)
    with pytest.raises(ValueError):
        slab_tile_grids(CFG, 3)


@pytest.mark.parametrize("offset,count,n_tile", [
    (0, 1, 1), (5, 3, 1), (3, 5, 2), (1, 8, 2), (0, 2, 4)])
def test_scheduled_pixel_mask_matches_jax(offset, count, n_tile):
    """Over slab-local schedules too (height=), where count may exceed the
    slab's tiles."""
    grid = slab_tile_grids(CFG, n_tile)[0]
    h = CFG.padded_height // n_tile
    got = scheduled_pixel_mask(CFG, torch.as_tensor(grid), offset, count,
                               height=h)
    want = jscheduled_pixel_mask(_jcfg(CFG), jnp.asarray(grid),
                                 jnp.int32(offset), count, height=h)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["sphere", "triangle", "fog"])
def test_slab_body_matches_xla_step(case):
    """Each slab body of a (2, 2) mesh against the JAX oracle on the same
    slab, row offset and stream: the same coverage and offsets, RMSE < 1e-3
    (tests/test_torch_render.py), on lit slabs (fog dims them:
    chip_smoke.py's density darkens the sky, most of the lit share); 2
    steps. Meshes: the lower slab (row offset 32, stream 1) of a (2, 1)
    mesh, one step (the op-by-op oracle sweeps every triangle)."""
    cfg = {"sphere": CFG, "triangle": TRI_CFG,
           "fog": CFG.replace(fog_density=0.0008, fog_albedo=0.8)}[case]
    lit = {"sphere": 0.3, "triangle": 0.05, "fog": 0.03}[case]
    n_tile, n_sample = (2, 1) if case == "triangle" else (2, 2)
    steps = 1 if case == "triangle" else 2
    slabs = {(1, 0)} if case == "triangle" else None
    jscene, scene = _scenes(cfg)
    cam = _camera(cfg)
    bodies = _slab_bodies(cfg, n_tile, n_sample, steps, scene, slabs)
    streams = set()
    for (t, s), st in bodies.items():
        js = _jax_zero_slab(cfg, n_tile)
        for _ in range(steps):
            js = _jax_slab_step(cfg, jscene, n_tile, t, s, js, cam)
        ja, ta = np.asarray(js.accum), st.accum.numpy()
        assert (st.tile_offset, st.iteration) == (int(js.tile_offset), steps)
        np.testing.assert_array_equal(ta[3], ja[3])
        touched = ja[3] > 0
        assert (ja[:3].max(0)[touched] > 0).mean() > lit
        rmse = np.sqrt(((ta - ja) ** 2).mean())
        assert rmse < 1e-3, f"slab {(t, s)}: port/oracle RMSE {rmse}"
        streams.add(ta[:3].tobytes())
    assert len(streams) == len(bodies)  # every slab and stream differs
    if case == "fog":
        clear = _slab_bodies(CFG, n_tile, n_sample, 2, scene)
        for key, st in bodies.items():
            d = np.abs(st.accum.numpy() - clear[key].accum.numpy())
            assert (d[:3].max(0) > 0).mean() > 0.05


def test_duplicate_tile_schedule():
    """k = 6 tiles per step over slabs of 4 (n_tile 2): the JAX schedule
    wraps and names tiles twice. The slab body renders each distinct tile
    once (the JAX oracle's mask, not two racing blocks), advances the
    offset by k mod 4 as the JAX step does, and matches the oracle."""
    cfg = CFG.replace(tiles_per_step=6)
    jscene, scene = _scenes(cfg)
    cam = _camera(cfg)
    body = SlabStep(cfg, scene, 2, 1, 1, backend="torch")
    assert body.k == 6 and body.tiles.shape[0] == 4
    sched = body.schedule(3)
    ids = (sched[:, 1] * cfg.tile_count_x + sched[:, 0]).tolist()
    assert sorted(ids) == [0, 1, 2, 3]
    st, js = init_slab_state(cfg, 2, 1), _jax_zero_slab(cfg, 2)
    for want_offset in (2, 0, 2):
        st = body(st, cam)
        js = _jax_slab_step(cfg, jscene, 2, 1, 1, js, cam)
        assert st.tile_offset == int(js.tile_offset) == want_offset
    ja, ta = np.asarray(js.accum), st.accum.numpy()
    np.testing.assert_array_equal(ta[3], np.full_like(ta[3], 3.0))
    np.testing.assert_array_equal(ta[3], ja[3])
    assert np.sqrt(((ta - ja) ** 2).mean()) < 1e-3


def test_wavefront_and_card_refusals():
    """The wavefront passes refuse a slab's camera (its row offset or
    stream); backend="cuda" without a card raises; the launcher names its
    backends."""
    cfg = CFG.replace(wavefront=True, tiles_per_step=2)
    scene = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    spheres = scene.packed()
    st = init_frame_state(cfg)
    sched = torch.as_tensor(slab_tile_grids(cfg, 1)[0][:2])
    frame = _camera(cfg)
    for extras in ((32, 0), (0, 1)):
        with pytest.raises(ValueError, match="slab"):
            wavefront_pass_a(cfg, sched, slab_camera(frame, *extras),
                             spheres, st.accum)
        with pytest.raises(ValueError, match="slab"):
            sphere_wavefront_step_plain(cfg, sched,
                                        slab_camera(frame, *extras),
                                        spheres, st.accum, st.output)
    sphere_wavefront_step_plain(cfg, sched, frame, spheres, st.accum,
                                st.output)
    with pytest.raises(ValueError, match="whole numbers"):
        wavefront_pass_a(cfg, sched, slab_camera(frame, -1, 0), spheres,
                         st.accum)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SlabStep(CFG, scene, 2, 0, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        launch(torch_parallel_ranks.run_cases, 2, "mpi")


def test_sharded_step_equals_single_card_at_one_slab():
    """A (1, 1) slab body is the single-card step (stream 0, offset 0),
    bit for bit, but for its display form."""
    scene = _port_scene(CFG)
    body = SlabStep(CFG, scene, 1, 0, backend="torch")
    step = build_render_step(CFG, scene, backend="torch")
    st, ref = init_slab_state(CFG, 1, 0), init_frame_state(CFG)
    for _ in range(3):
        st, ref = body(st, _camera(CFG)), step(ref, _camera(CFG))
    np.testing.assert_array_equal(st.accum.numpy(), ref.accum.numpy())
    assert st.tile_offset == ref.tile_offset


# --- spawned ranks -----------------------------------------------------------

STATEFUL = CFG.replace(tiles_per_step=CFG.tile_count)  # whole frames
CASES = [
    ("render_2x2", CFG, (2, 2), 3),
    ("render_4x1_whole", CFG.replace(tiles_per_step=8), (4, 1), 2),
    ("render_1x2", CFG, (1, 2), 2),
    ("render_triangle_2x1", TRI_CFG, (2, 1), 2),
]


def _case(name, cfg, mesh, steps, kind="render", **extra):
    return {"name": name, "cfg": cfg.to_json(), "mesh": mesh,
            "steps": steps, "kind": kind, "view": _aimed_view(cfg), **extra}


def _jax_session(path):
    """A (2, 2) session of CFG saved by the JAX package's saver: one
    oracle step per slab, op by op, folded as its sharded step folds.
    Returns the slabs' JAX states."""
    jscene, _ = _scenes(CFG)
    cam = _camera(CFG)
    h = CFG.padded_height // 2
    slabs = {(t, s): _jax_slab_step(CFG, jscene, 2, t, s,
                                    _jax_zero_slab(CFG, 2), cam)
             for t in range(2) for s in range(2)}
    accum = np.stack([np.concatenate([np.asarray(slabs[(t, s)].accum)
                                      for t in range(2)], axis=1)
                      for s in range(2)])
    state = JShardedFrameState(
        accum=jnp.asarray(accum),
        output=jnp.asarray(_display(accum.sum(0), CFG.gamma)),
        tile_offset=slabs[(0, 0)].tile_offset,
        iteration=jnp.int32(1))
    jsave_sharded(path, _jcfg(CFG), state, _aimed_view(CFG))
    assert accum.shape == (2, 4, 2 * h, CFG.padded_width)
    return slabs


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One launch of 4 gloo ranks runs every sharded case; returns
    (rank 0's results by case, the JAX session's slabs, the work dir)."""
    work = tmp_path_factory.mktemp("sharded")
    jslabs = _jax_session(work / "jax_session.npz")
    cases = [_case(*c) for c in CASES]
    cases += [
        _case(f"stateful_{rng}", STATEFUL.replace(rng=rng), (4, 1), 2)
        for rng in ("tinymt", "tauslcg")]
    cases += [
        _case("stateful_sample_axis", CFG.replace(rng="tinymt"), (2, 2), 0,
              kind="stateful_sample_axis"),
        _case("port_session", CFG, (2, 2), 2, kind="save", more=1),
        _case("tauslcg_session", STATEFUL.replace(rng="tauslcg"), (4, 1), 2,
              kind="save", more=1),
        _case("jax_session", CFG, (2, 2), 1, kind="load",
              path=str(work / "jax_session.npz"))]
    # The launcher as imported now: the module-level import was dropped
    # from sys.modules (_forget_port), and a pickled function must be the
    # one its module holds.
    from l2n_tpu_torch.parallel.launch import launch as launch_ranks
    results = launch_ranks(torch_parallel_ranks.run_cases, 4, "gloo",
                     args=(str(work), cases),
                     init_method=f"file://{work / 'pg'}", timeout=300.0)
    assert results[1:] == [None, None, None]
    return results[0], jslabs, work


@pytest.mark.parametrize("name,cfg,mesh,steps", CASES,
                         ids=[c[0] for c in CASES])
def test_gather_equals_slab_bodies(spawned, name, cfg, mesh, steps):
    """The gathered replicas equal the slab bodies rendered here, bit for
    bit; the display is the fold's (JAX's pow form) at every touched pixel;
    the counters advanced."""
    got = spawned[0][name]["state"]
    n_tile, n_sample = mesh
    h = cfg.padded_height // n_tile
    bodies = _slab_bodies(cfg, n_tile, n_sample, steps)
    acc = got["sharded_accum"]
    assert acc.shape == (n_sample, 4, cfg.padded_height, cfg.padded_width)
    for (t, s), st in bodies.items():
        np.testing.assert_array_equal(acc[s, :, t * h:(t + 1) * h],
                                      st.accum.numpy())
    assert (int(got["tile_offset"]), int(got["iteration"])) == (
        bodies[(0, 0)].tile_offset, steps)
    np.testing.assert_allclose(got["output"],
                               _display(acc.sum(0), cfg.gamma),
                               rtol=2e-6, atol=0)
    assert (acc[:, 3] > 0).any()


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_display_and_clear(spawned, name):
    """display() at rank 0 has the frame's shape and is lit; clear() zeroes
    every replica's accumulation and leaves the display and counters."""
    out = spawned[0][name]
    cfg = RenderConfig.from_json(
        [c for c in CASES if c[0] == name][0][1].to_json())
    img = out["display"]
    assert img.shape == (cfg.height, cfg.width, 3)
    assert np.isfinite(img).all()
    assert (img.max(-1) > 0).mean() > 0.05
    np.testing.assert_array_equal(
        img, np.moveaxis(out["state"]["output"], 0, -1)[:cfg.height,
                                                        :cfg.width])
    assert not out["cleared"]["sharded_accum"].any()
    np.testing.assert_array_equal(out["cleared"]["output"],
                                  out["state"]["output"])
    assert int(out["cleared"]["iteration"]) == int(out["state"]["iteration"])


@pytest.mark.parametrize("rng", ["tinymt", "tauslcg"])
def test_stateful_tile_axis_equals_single_card(spawned, rng):
    """(4, 1) with whole-frame steps renders every pixel once per step from
    the frame's own state planes: accum and rng_state equal one
    single-card render's, bit for bit."""
    got = spawned[0][f"stateful_{rng}"]["state"]
    cfg = STATEFUL.replace(rng=rng)
    step = build_render_step(cfg, _port_scene(cfg), backend="torch")
    st = init_frame_state(cfg)
    for _ in range(2):
        st = step(st, _camera(cfg))
    np.testing.assert_array_equal(got["sharded_accum"][0], st.accum.numpy())
    np.testing.assert_array_equal(got["rng_state"],
                                  st.rng_state.numpy().view(np.uint32))
    assert (st.accum[:3].amax(0) > 0).float().mean() > 0.3


def test_stateful_sample_axis_raises(spawned):
    """Both packages refuse a stateful mode on a sample axis."""
    msg = spawned[0]["stateful_sample_axis"]
    assert "per-pixel" in msg
    from l2n_tpu.parallel.step import init_sharded_state as jinit_sharded
    with pytest.raises(ValueError, match="per-pixel"):
        jinit_sharded(_jcfg(CFG.replace(rng="tinymt")),
                      jmake_device_mesh(2, 2))


def test_mesh_past_ranks(spawned):
    """Ranks 2 and 3 lie outside the (1, 2) mesh: they rendered nothing
    and returned nothing, and rank 0 gathered the two replicas."""
    acc = spawned[0]["render_1x2"]["state"]["sharded_accum"]
    assert acc.shape[0] == 2 and not np.array_equal(acc[0], acc[1])


@pytest.mark.parametrize("name", ["port_session", "tauslcg_session"])
def test_port_session_loads_in_jax(spawned, name):
    """A session the port's ranks saved loads in the JAX package's
    load_sharded_session on its mesh: the same config and arrays."""
    results, _, work = spawned
    saved = results[name]["state"]
    cfg = CFG if name == "port_session" else STATEFUL.replace(rng="tauslcg")
    n_tile, n_sample = (2, 2) if name == "port_session" else (4, 1)
    jcfg, jstate, view = jload_sharded(work / f"{name}.npz",
                                       jmake_device_mesh(n_tile, n_sample))
    assert jcfg == _jcfg(cfg)
    np.testing.assert_array_equal(np.asarray(jstate.accum),
                                  saved["sharded_accum"])
    np.testing.assert_array_equal(np.asarray(jstate.output), saved["output"])
    assert int(jstate.tile_offset) == int(saved["tile_offset"])
    assert int(jstate.iteration) == int(saved["iteration"])
    np.testing.assert_array_equal(view, _aimed_view(cfg))
    if "rng_state" in saved:
        np.testing.assert_array_equal(np.asarray(jstate.rng_state),
                                      saved["rng_state"])


@pytest.mark.parametrize("name", ["port_session", "tauslcg_session"])
def test_port_session_resume_bit_exact(spawned, name):
    """Saved after 2 steps, loaded into fresh ranks: the next step equals
    the uninterrupted one, bit for bit (accum, output, rng_state)."""
    out = spawned[0][name]
    for key, want in out["after"].items():
        np.testing.assert_array_equal(out["resumed"][key], want, err_msg=key)
    np.testing.assert_array_equal(out["view"], _aimed_view(CFG))


def test_jax_session_resumes_in_port(spawned):
    """A (2, 2) session the JAX package saved loads into the port's ranks
    (each reads its shard: gathered back, the file's arrays), and the
    next step matches the JAX oracle's next step on every slab."""
    results, jslabs, work = spawned
    out = results["jax_session"]
    with np.load(work / "jax_session.npz") as data:
        for key in ("sharded_accum", "output", "tile_offset", "iteration"):
            np.testing.assert_array_equal(out["loaded"][key], data[key],
                                          err_msg=key)
    np.testing.assert_array_equal(out["view"], _aimed_view(CFG))
    jscene, _ = _scenes(CFG)
    got = out["state"]["sharded_accum"]
    h = CFG.padded_height // 2
    for (t, s), js in jslabs.items():
        js = _jax_slab_step(CFG, jscene, 2, t, s, js, _camera(CFG))
        ja = np.asarray(js.accum)
        ta = got[s, :, t * h:(t + 1) * h]
        np.testing.assert_array_equal(ta[3], ja[3])
        assert np.sqrt(((ta - ja) ** 2).mean()) < 1e-3
    assert int(out["state"]["iteration"]) == 2
