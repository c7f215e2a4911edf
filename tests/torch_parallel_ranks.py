"""The rank side of tests/test_torch_parallel.py: what each spawned rank of
a sharded render runs. A spawned child imports the module its target
lives in, so this one imports no JAX; it reaches the port only inside the
functions, so that the test process, which drops the port's modules after
its test file, keeps no copy of them through this module.
"""

import torch


def _renderer(case, mesh):
    from l2n_tpu_torch.config import RenderConfig
    from l2n_tpu_torch.parallel import ShardedRenderer
    from l2n_tpu_torch.scene.spheres import compute_spheres
    from l2n_tpu_torch.scene.tessellate import build_triangle_scene

    cfg = RenderConfig.from_json(case["cfg"])
    scene = compute_spheres(cfg.sphere_count, cfg.world_size, cfg.scene_seed)
    if cfg.scene_kind == "triangle":
        scene = build_triangle_scene(scene, cfg.disc_lat, cfg.disc_long)
    return cfg, ShardedRenderer(cfg, scene, mesh, backend="torch")


def _steps(renderer, cam, n):
    for _ in range(n):
        renderer.step(cam)


def _case(rank, work_dir, case):
    """One case on this rank; its results at rank 0 (None elsewhere, and
    on a rank past the mesh)."""
    from l2n_tpu_torch.camera import Camera
    from l2n_tpu_torch.parallel import make_device_mesh
    from l2n_tpu_torch.parallel.mesh import mesh_coordinate
    from l2n_tpu_torch.parallel.step import gather_state

    mesh = make_device_mesh(*case["mesh"], device_type="cpu")
    if mesh_coordinate(mesh) is None:
        return None
    if case["kind"] == "stateful_sample_axis":
        try:
            _renderer(case, mesh)
        except ValueError as err:
            return str(err)
        return "no error"
    cfg, r = _renderer(case, mesh)
    cam = Camera.from_config(cfg, case["view"]).packed()
    out = {}
    if case["kind"] == "load":
        out["view"] = r.load_session(case["path"])
        out["loaded"] = gather_state(mesh, r.state)
    _steps(r, cam, case["steps"])
    out["state"] = gather_state(mesh, r.state)
    if case["kind"] == "render":
        out["display"] = r.display()
        r.clear()
        out["cleared"] = gather_state(mesh, r.state)
    elif case["kind"] == "save":
        path = f"{work_dir}/{case['name']}.npz"
        r.save_session(path, case["view"])
        _steps(r, cam, case["more"])
        out["after"] = gather_state(mesh, r.state)
        _, fresh = _renderer(case, mesh)
        out["view"] = fresh.load_session(path)
        _steps(fresh, cam, case["more"])
        out["resumed"] = gather_state(mesh, fresh.state)
    return out if rank == 0 else None


def run_cases(rank, work_dir, cases):
    """Every case in order; {name: results} at rank 0."""
    torch.set_num_threads(1)
    results = {case["name"]: _case(rank, work_dir, case) for case in cases}
    return results if rank == 0 else None
