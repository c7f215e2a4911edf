"""Scenes: the procedural analytic-sphere scene."""

from l2n_tpu_torch.scene.spheres import SphereScene, compute_spheres  # noqa: F401
