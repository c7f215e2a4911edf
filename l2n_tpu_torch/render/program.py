"""Program layer: scene construction + render step, bundled (counterpart of
l2n_tpu.render.program): the sphere renderer and the triangle renderer."""

from __future__ import annotations

from l2n_tpu_torch.ops.lights import ExplicitLights
from l2n_tpu_torch.render.step import build_render_step, resolve_device
from l2n_tpu_torch.scene.materials import empty_lights
from l2n_tpu_torch.scene.obj import load_obj
from l2n_tpu_torch.scene.spheres import SphereScene, compute_spheres
from l2n_tpu_torch.scene.tessellate import TriangleScene, build_triangle_scene


class PathtracingProgram:
    """Base: owns the config, the scene, the device, the material and light
    buffers (scene/materials.py containers; empty by default, the
    reference's own state) and the render step. Point and directional
    lights add direct lighting at diffuse vertices and PhongMaterials
    diffuse rows override the per-object albedo (ops/lights.py); empty
    buffers build today's step. Lights with `wavefront=True` raise
    ValueError, as in the JAX package. `steps_per_call` > 1 runs that many
    scheduler steps per call of `step`, on the card as one CUDA-graph
    replay (render/step.py); the image equals as many single steps.
    """

    name = "basePT"

    def __init__(self, cfg, scene, backend: str = "cuda", device=None,
                 materials=None, point_lights=None, directional_lights=None,
                 steps_per_call: int = 1):
        self.cfg = cfg
        self.backend = backend
        self.device = resolve_device(backend, device)
        self.scene = scene
        default_mats, default_pl, default_dl = empty_lights()
        self.materials = materials if materials is not None else default_mats
        self.point_lights = (point_lights if point_lights is not None
                             else default_pl)
        self.directional_lights = (directional_lights
                                   if directional_lights is not None
                                   else default_dl)
        self.lights = ExplicitLights(self.materials, self.point_lights,
                                     self.directional_lights)
        self.steps_per_call = steps_per_call
        self.step = build_render_step(cfg, scene, backend=backend,
                                      device=self.device, lights=self.lights,
                                      steps_per_call=steps_per_call)


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
