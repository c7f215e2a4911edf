"""Scenes: the procedural analytic-sphere scene, its lat/long tessellation
into an indexed triangle scene, OBJ loading and procedural OBJ demos."""

from l2n_tpu_torch.scene.obj import load_obj  # noqa: F401
from l2n_tpu_torch.scene.procgen import torus_field_obj, trefoil_obj  # noqa: F401
from l2n_tpu_torch.scene.spheres import SphereScene, compute_spheres  # noqa: F401
from l2n_tpu_torch.scene.tessellate import (  # noqa: F401
    TriangleScene,
    build_triangle_scene,
    tessellate_sphere,
    tessellate_sphere_info,
)
