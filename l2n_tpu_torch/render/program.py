"""Program layer: scene construction + render step, bundled (counterpart of
l2n_tpu.render.program): the sphere renderer and the triangle renderer."""

from __future__ import annotations

from l2n_tpu_torch.render.step import build_render_step, resolve_device
from l2n_tpu_torch.scene.obj import load_obj
from l2n_tpu_torch.scene.spheres import SphereScene, compute_spheres
from l2n_tpu_torch.scene.tessellate import TriangleScene, build_triangle_scene


class PathtracingProgram:
    """Base: owns the config, the scene, the device and the render step.

    The JAX package's explicit material/light buffers are not in this
    slice: passing any raises NotImplementedError.
    """

    name = "basePT"

    def __init__(self, cfg, scene, backend: str = "cuda", device=None,
                 materials=None, point_lights=None, directional_lights=None):
        if (materials, point_lights, directional_lights) != (None, None, None):
            raise NotImplementedError(
                "explicit lights and materials are ROADMAP Queue 1 #9")
        self.cfg = cfg
        self.backend = backend
        self.device = resolve_device(backend, device)
        self.scene = scene
        self.step = build_render_step(cfg, scene, backend=backend,
                                      device=self.device)


class SphereProgram(PathtracingProgram):
    """The analytic 128-sphere scene."""

    name = "spherePT"

    def __init__(self, cfg, scene: SphereScene | None = None,
                 backend: str = "cuda", device=None, **kw):
        cfg = cfg.replace(scene_kind="sphere")
        device = resolve_device(backend, device)
        if scene is None:
            scene = compute_spheres(cfg.sphere_count, cfg.world_size,
                                    cfg.scene_seed, device=device)
        super().__init__(cfg, scene, backend, device, **kw)


class TriangleProgram(PathtracingProgram):
    """The tessellated-mesh scene: the procedural spheres tessellated at
    (disc_lat, disc_long), or the OBJ file `cfg.obj_path`."""

    name = "trianglePT"

    def __init__(self, cfg, scene: TriangleScene | None = None,
                 backend: str = "cuda", device=None, **kw):
        cfg = cfg.replace(scene_kind="triangle")
        device = resolve_device(backend, device)
        if scene is None:
            if cfg.obj_path:
                scene = load_obj(cfg.obj_path)
            else:
                spheres = compute_spheres(cfg.sphere_count, cfg.world_size,
                                          cfg.scene_seed)
                scene = build_triangle_scene(spheres, cfg.disc_lat,
                                             cfg.disc_long)
        super().__init__(cfg, scene, backend, device, **kw)
