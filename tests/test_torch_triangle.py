"""The port's triangle renderer on the CPU (backend="torch"): the host layer
byte-equal to the JAX package (tessellation, soup, OBJ loading, procedural
OBJ text, bound packing), the triangle intersector bit-equal to the JAX
oracle's, the plain step held against the JAX XLA step run op by op
(`jax.disable_jit`, see tests/test_torch_render.py) and the triangle
golden, and the entry points (Application, CLI, config gate, wrapper).
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from l2n_tpu.config import RenderConfig
from l2n_tpu.ops.kernels.triangle_pt import pack_mesh_blocks as jpack_blocks
from l2n_tpu.ops.kernels.triangle_pt import pack_slab_groups as jpack_groups
from l2n_tpu.ops.intersect import intersect_triangle_scene as jintersect
from l2n_tpu.ops.scenes import triangle_intersector as jtriangle_intersector
from l2n_tpu.render.state import init_frame_state as jinit
from l2n_tpu.render.step import build_render_step as jbuild
from l2n_tpu.scene import build_triangle_scene as jbuild_triangles
from l2n_tpu.scene import compute_spheres as jcompute
from l2n_tpu.scene import tessellate_sphere as jtessellate
from l2n_tpu.scene.obj import load_obj as jload_obj
from l2n_tpu.scene.procgen import torus_field_obj as jtorus_field
from l2n_tpu.scene.procgen import trefoil_obj as jtrefoil
from l2n_tpu_torch.app.application import Application, main
from l2n_tpu_torch.camera import Camera
from l2n_tpu_torch.maths.linalg import look_at
from l2n_tpu_torch.ops.intersect import intersect_triangle_scene
from l2n_tpu_torch.ops.kernels import build
from l2n_tpu_torch.ops.kernels.common import check_supported, launch, launches
from l2n_tpu_torch.ops.kernels.triangle_pack import (
    ROWS,
    pack_mesh_blocks,
    pack_slab_groups,
)
from l2n_tpu_torch.ops.kernels.triangle_pt import (
    TriangleBuffers,
    triangle_pt,
    triangle_pt_plain,
)
from l2n_tpu_torch.ops.scenes import triangle_intersector
from l2n_tpu_torch.render.program import TriangleProgram
from l2n_tpu_torch.render.state import FrameState, init_frame_state
from l2n_tpu_torch.render.step import build_render_step
from l2n_tpu_torch.render.tiles import scheduled_tiles, tile_grid
from l2n_tpu_torch.scene import (
    TriangleScene,
    build_triangle_scene,
    compute_spheres,
    load_obj,
    tessellate_sphere,
    torus_field_obj,
    trefoil_obj,
)


def _forget_port():
    """Drop the port's modules from sys.modules (ROADMAP Queue 3 #12):
    tests/test_aot_cache.py scans every loaded module named "l2n_tpu*"."""
    for name in [m for m in sys.modules if m.startswith("l2n_tpu_torch")]:
        del sys.modules[name]


_forget_port()


@pytest.fixture(scope="module", autouse=True)
def _port_unloaded_after_module():
    yield
    _forget_port()


GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "triangle_pt_256x128_4spp.npz")
SCENE_FIELDS = ("vertices", "normals", "tex_coords", "indices",
                "triangle_count", "index_offset")
# tests/test_kernels.py::TestTriangleKernel.TRI_CFG
TRI_CFG = RenderConfig(width=128, height=64, tile_width=128, tile_height=32,
                       sphere_count=8, disc_lat=8, disc_long=4,
                       tiles_per_step=1, scene_kind="triangle").validate()
HAND_OBJ = """
# a quad fan and a triangle, negative indices, no vn, no vt
o fan
v 0 0 0
v 2 0 0
v 2 2 0.5
v 0 2 0
f -4 -3 -2 -1
g tri
v 1 1 3
f 1 2 -1
"""


def _same_bytes(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _same_scene(jscene, scene):
    for f in SCENE_FIELDS:
        _same_bytes(getattr(jscene, f), getattr(scene, f), f)
    jsoup, soup = jscene.soup(), scene.soup()
    assert sorted(jsoup) == sorted(soup)
    for k in jsoup:
        _same_bytes(jsoup[k], soup[k], f"soup[{k}]")


# --- host layer ------------------------------------------------------------

@pytest.mark.parametrize("disc", [(8, 4), (16, 8)])
def test_tessellation_byte_equal(disc):
    lat, lon = disc
    center = np.array([3.5, -120.25, 47.0], np.float32)
    for got, want in zip(tessellate_sphere(center, 17.3, lat, lon),
                         jtessellate(center, 17.3, lat, lon)):
        _same_bytes(want, got, "tessellate_sphere")
    jscene = jbuild_triangles(jcompute(16), lat, lon)
    scene = build_triangle_scene(compute_spheres(16), lat, lon)
    _same_scene(jscene, scene)
    assert scene.mesh_count == 16
    assert scene.total_triangles == 16 * lat * lon * 2
    # A JAX-built scene hands straight over to the port.
    _same_scene(jscene, TriangleScene(*(getattr(jscene, f)
                                        for f in SCENE_FIELDS)))


@pytest.mark.parametrize("source", ["torus_field", "hand_written"])
def test_load_obj_byte_equal(source):
    text = torus_field_obj(n_tori=2) if source == "torus_field" else HAND_OBJ
    scene = load_obj(text)
    _same_scene(jload_obj(text), scene)
    if source == "hand_written":
        assert list(scene.triangle_count) == [2, 1]
        assert (scene.tex_coords == 0).all()


def test_procgen_text_byte_equal():
    assert torus_field_obj() == jtorus_field()
    assert trefoil_obj(seg_u=16, seg_v=9) == jtrefoil(seg_u=16, seg_v=9)


def _packing_scenes(name):
    if name == "golden16":
        return (jbuild_triangles(jcompute(16), 8, 4),
                build_triangle_scene(compute_spheres(16), 8, 4))
    if name == "default128":
        return (jbuild_triangles(jcompute(128)),
                build_triangle_scene(compute_spheres(128)))
    text = torus_field_obj(n_tori=4)
    return jload_obj(text), load_obj(text)


@pytest.mark.parametrize("name", ["golden16", "default128", "tori4"])
def test_packing_byte_equal(name, tmp_path, monkeypatch):
    # The JAX packer caches scenes of >= 20k triangles on disk: keep that
    # cache out of the repo.
    monkeypatch.setenv("L2N_AOT_CACHE_DIR", str(tmp_path))
    jscene, scene = _packing_scenes(name)
    want = jpack_blocks(jscene)
    got = pack_mesh_blocks(scene)
    for i, field in enumerate(("blocks", "bounds", "slab_bounds",
                               "sub_bounds", "slab_count")):
        _same_bytes(want[i], getattr(got, field), field)
    for gsub in (2, 8):
        for w, g in zip(jpack_groups(want[2], want[4], gsub),
                        pack_slab_groups(got.slab_bounds, got.slab_count,
                                         gsub)):
            _same_bytes(w, g, f"slab groups of {gsub}")
    # slot_index is the permutation the blocks were gathered with.
    soup = scene.soup()
    live = got.slot_index >= 0
    for r, key in enumerate(ROWS[:9]):
        np.testing.assert_array_equal(got.blocks[:, r][live],
                                      soup[key][got.slot_index[live]])
    pad = np.broadcast_to(~live[:, None], got.blocks[:, :9].shape)
    assert (got.blocks[:, :9][pad] == 0).all()
    assert sorted(got.slot_index[live]) == list(range(scene.total_triangles))
    if name == "tori4":
        assert (got.slab_count == 6).all()  # the multi-slab case


# --- intersection ----------------------------------------------------------

def _tie_rays(scene, n=3000, seed=11):
    """Seeded rays aimed at random points, shared edges (u = 0 or v = 0) and
    vertices of random triangles; the first 200 origins are parked at 3e30
    like the tracer's dead lanes."""
    soup = scene.soup()
    rng = np.random.default_rng(seed)
    ti = rng.integers(0, soup["v1x"].shape[0], n)

    def corner(name):
        return np.stack([soup[f"{name}{a}"][ti] for a in "xyz"], 1)

    kind = rng.integers(0, 4, n)
    u = rng.random(n).astype(np.float32)
    v = (rng.random(n) * (1.0 - u)).astype(np.float32)
    u[(kind == 1) | (kind == 3)] = 0.0
    v[(kind == 2) | (kind == 3)] = 0.0
    target = (corner("v1") + u[:, None] * corner("e1")
              + v[:, None] * corner("e2")).astype(np.float32)
    origin = rng.uniform(-600.0, 600.0, (n, 3)).astype(np.float32)
    d = target - origin
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    origin[:200] = 3.0e30
    return [origin[:, 0], origin[:, 1], origin[:, 2], d[:, 0], d[:, 1],
            d[:, 2]]


@pytest.fixture(scope="module")
def tie_scene():
    jscene = jbuild_triangles(jcompute(8), 8, 4)
    return jscene, TriangleScene(*(getattr(jscene, f) for f in SCENE_FIELDS))


@pytest.fixture(scope="module")
def tie_hits(tie_scene):
    """The JAX oracle's intersect_triangle_scene on the tie rays, op by op."""
    jscene, scene = tie_scene
    rays = _tie_rays(scene)
    jsoup = {k: jnp.asarray(v) for k, v in jscene.soup().items()}

    def fetch(i):
        return tuple(jsoup[k][i] for k in (
            "v1x", "v1y", "v1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z",
            "mesh_id"))

    with jax.disable_jit():
        want = jintersect(*(jnp.asarray(r) for r in rays),
                          scene.total_triangles, fetch)
    return rays, [np.asarray(w) for w in want]


@pytest.mark.parametrize("chunk", [None, 7])
def test_intersect_triangle_scene_matches_jax(tie_scene, tie_hits, chunk):
    _, scene = tie_scene
    rays, want = tie_hits
    soup = {k: torch.as_tensor(v) for k, v in scene.soup().items()}
    got = intersect_triangle_scene(*(torch.as_tensor(r) for r in rays), soup,
                                   chunk=chunk)
    for name, w, g in zip(("t", "u", "v", "tri", "mesh"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    hit = np.asarray(want[0]) >= 0
    assert 0.5 < hit.mean() < 1.0 and not hit[:200].any()


def test_triangle_intersector_matches_jax(tie_scene):
    jscene, scene = tie_scene
    rays = _tie_rays(scene, seed=12)
    with jax.disable_jit():
        want = jtriangle_intersector(jscene.soup())(
            *(jnp.asarray(r) for r in rays))
    soup = {k: torch.as_tensor(v) for k, v in scene.soup().items()}
    got = triangle_intersector(soup)(*(torch.as_tensor(r) for r in rays))
    for name in ("t", "nx", "ny", "nz", "index", "emis_r2", "tc_u", "tc_v",
                 "b_u", "b_v"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


# --- the step --------------------------------------------------------------

def _aimed_camera(cfg):
    """tests/test_kernels.py::TestTriangleKernel.aimed_camera: up close at
    the emissive sphere 0."""
    sp = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    c0 = np.array([float(sp.center_x[0]), float(sp.center_y[0]),
                   float(sp.center_z[0])], np.float32)
    r0 = float(np.sqrt(float(sp.sqr_radius[0])))
    vm = look_at(c0 + np.array([0.0, 0.0, 2.5 * r0], np.float32), c0,
                 np.array([0.0, 1.0, 0.0], np.float32))
    return Camera.from_config(cfg, view_matrix=vm)


@pytest.mark.parametrize("aov", ["pathtracing", "tex_coords", "param_uv"])
def test_torch_triangle_step_matches_xla_oracle(aov):
    """Gates of tests/test_kernels.py:125-151; the two are bit-equal."""
    cfg = TRI_CFG.replace(aov=aov)
    cam = _aimed_camera(cfg).packed()
    jscene = jbuild_triangles(jcompute(cfg.sphere_count, cfg.world_size,
                                       cfg.scene_seed),
                              cfg.disc_lat, cfg.disc_long)
    jstep = jbuild(cfg, jscene, backend="xla")
    jst = jinit(cfg)
    st = FrameState.from_numpy(np.asarray(jst.accum), np.asarray(jst.output),
                               int(jst.tile_offset), int(jst.iteration))
    step = build_render_step(
        cfg, TriangleScene(*(getattr(jscene, f) for f in SCENE_FIELDS)),
        backend="torch", device="cpu")
    with jax.disable_jit():
        for _ in range(2):
            jst = jstep(jst, cam)
    for _ in range(2):
        st = step(st, cam)
    ja = np.asarray(jst.accum)
    ta, _, offset, iteration = st.to_numpy()
    assert (offset, iteration) == (int(jst.tile_offset), int(jst.iteration))
    assert (ja[:3].max(0) > 0).mean() > 0.05  # real lit coverage
    np.testing.assert_array_equal(ta[3], ja[3])
    d = np.abs(ta - ja)
    if aov == "pathtracing":
        assert np.sqrt((d ** 2).mean()) < 1e-3
        assert (d > 1e-3).mean() < 1e-3
    else:
        assert (d > 1e-4).mean() < 1e-3
    assert d.max() == 0.0, f"port/oracle max abs {d.max()}"


def test_torch_triangle_golden():
    """The golden was rendered by the jitted XLA oracle (256x128, 16
    tessellated spheres, 4 whole-frame steps, its own view matrix); gates
    of tests/test_golden_render.py's cross-implementation checks."""
    with np.load(GOLDEN) as data:
        cfg = RenderConfig.from_json(bytes(data["config"]).decode())
        want, vm = data["accum"], data["view_matrix"]
    prog = TriangleProgram(cfg, backend="torch")
    st = init_frame_state(cfg)
    cam = Camera.from_config(cfg, view_matrix=vm).packed()
    for _ in range(4):
        st = prog.step(st, cam)
    got = st.accum.numpy()
    np.testing.assert_array_equal(got[3], want[3])
    d = np.abs(got - want)
    assert (d > 1e-3).mean() < 0.03
    mean_diff = np.abs(got[:3] / np.maximum(got[3], 1)
                       - want[:3] / np.maximum(want[3], 1))
    assert np.sqrt((mean_diff ** 2).mean()) < 0.03
    assert (got[:3].max(0) > 0).mean() > 0.05


# --- entry points ----------------------------------------------------------

def _small_cfg(**kw):
    return RenderConfig(width=128, height=64, sphere_count=8, disc_lat=8,
                        disc_long=4, **kw)


@pytest.mark.parametrize("scene", ["trianglePT", "obj"])
def test_cli_triangle_renderer_cpu(scene, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the camera cache lands in the cwd
    (tmp_path / "cfg.json").write_text(_small_cfg().to_json())
    (tmp_path / "scene.obj").write_text(HAND_OBJ)
    pick = (["--renderer", "trianglePT"] if scene == "trianglePT"
            else ["--obj", "scene.obj"])
    assert main(["--config", "cfg.json", "--frames", "2", "--out", "frames",
                 "--every", "1", "--backend", "torch", *pick]) == 0
    assert "rendered 2 trianglePT steps on cpu" in capsys.readouterr().out
    pngs = sorted(p.name for p in (tmp_path / "frames").glob("*.png"))
    assert pngs == ["frame_00000.png", "frame_00001.png"]


def test_switch_renderer_clears_accumulation(tmp_path):
    app = Application(_small_cfg(), workdir=tmp_path, backend="torch",
                      device="cpu")
    assert sorted(app.renderer.programs) == ["spherePT", "trianglePT"]
    app.run(1, save_camera=False)
    assert float(app.renderer.state.accum[3].sum()) > 0
    app.switch_renderer("trianglePT")
    assert float(app.renderer.state.accum.abs().sum()) == 0.0
    st = app.run(1, save_camera=False)
    assert app.renderer.program.cfg.scene_kind == "triangle"
    assert st.iteration == 2 and float(st.accum[3].sum()) > 0


@pytest.mark.parametrize("kw,ok", [
    ({}, True), ({"aov": "tex_coords"}, True), ({"aov": "param_uv"}, True),
    ({"nee": True}, "#9"), ({"aov": "normal"}, "#9"),
    ({"aov": "ambient_occlusion"}, "#9"), ({"wavefront": True}, "#13")])
def test_check_supported_triangle(kw, ok):
    cfg = _small_cfg(scene_kind="triangle", **kw)
    if ok is True:
        check_supported(cfg)
    else:
        with pytest.raises(NotImplementedError, match=f"Queue 1 {ok}"):
            check_supported(cfg)
    if "aov" in kw and ok is True:  # the texcoord AOVs are mesh-only
        with pytest.raises(NotImplementedError, match="Queue 1 #8"):
            check_supported(cfg.replace(scene_kind="sphere"))


def _step_inputs(cfg, device="cpu"):
    scene = build_triangle_scene(compute_spheres(cfg.sphere_count), 8, 4)
    buffers = TriangleBuffers.from_scene(scene, device)
    sched = scheduled_tiles(torch.as_tensor(tile_grid(cfg)), 0,
                            cfg.effective_tiles_per_step).to(device)
    st = init_frame_state(cfg, device)
    cam = _aimed_camera(cfg).packed()
    return sched, cam, buffers, st.accum, st.output


def test_triangle_pt_wrapper_cpu_is_plain():
    cfg = TRI_CFG
    before = launches["triangle_pt"]
    a = _step_inputs(cfg)
    b = _step_inputs(cfg)
    triangle_pt(cfg, *a)
    triangle_pt_plain(cfg, *b)
    np.testing.assert_array_equal(a[3].numpy(), b[3].numpy())
    np.testing.assert_array_equal(a[4].numpy(), b[4].numpy())
    assert int((a[3][3] == 1).sum()) == 32 * 128  # one tile, 1 spp
    assert int((a[3][3] == 0).sum()) == 32 * 128
    assert (a[3][:3].amax(0) > 0).float().mean() > 0.05
    assert launches["triangle_pt"] == before  # the plain version is no launch


def test_triangle_pt_wrapper_checks():
    cfg = TRI_CFG
    sched, cam, buffers, accum, output = _step_inputs(cfg)
    with pytest.raises(TypeError, match="sched"):
        triangle_pt(cfg, sched.to(torch.int64), cam, buffers, accum, output)
    with pytest.raises(ValueError, match="accum"):
        triangle_pt(cfg, sched, cam, buffers, accum[:, :32], output)
    with pytest.raises(ValueError, match="camera"):
        triangle_pt(cfg, sched, cam[:9], buffers, accum, output)
    with pytest.raises(TypeError, match="buffers"):
        triangle_pt(cfg, sched, cam, buffers.soup, accum, output)
    bad = TriangleBuffers(**{**buffers.__dict__,
                             "tris": buffers.tris.to(torch.float64)})
    with pytest.raises(TypeError, match="tris"):
        triangle_pt(cfg, sched, cam, bad, accum, output)
    bad = TriangleBuffers(**{**buffers.__dict__,
                             "slab_count": buffers.slab_count[:3]})
    with pytest.raises(ValueError, match="slab_count"):
        triangle_pt(cfg, sched, cam, bad, accum, output)
    with pytest.raises(ValueError, match="scene_kind"):
        triangle_pt(cfg.replace(scene_kind="sphere"), sched, cam, buffers,
                    accum, output)
    meta = _step_inputs(cfg, "meta")
    with pytest.raises(ValueError, match="no kernel"):
        triangle_pt(cfg, *meta)


def test_backend_cuda_triangle_raises_without_card_or_build(monkeypatch,
                                                            tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TriangleProgram(_small_cfg(), backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Application(_small_cfg(), workdir=tmp_path, backend="cuda",
                    renderer_names=("trianglePT",))
    # The first launch builds the kernel library; a failed build raises
    # instead of falling back, and counts no launch.
    def no_build():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "load", no_build)
    sched, _, _, accum, _ = _step_inputs(TRI_CFG)
    before = launches["triangle_pt"]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        launch("triangle_pt", TRI_CFG, accum.device, sched, accum)
    assert launches["triangle_pt"] == before
