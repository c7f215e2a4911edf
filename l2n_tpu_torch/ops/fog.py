"""Host constants of homogeneous fog (cfg.fog_density > 0; counterpart of
l2n_tpu.ops.pathtrace's _fog_sigma / _fog_sky and the factors of
l2n_tpu.ops.lights): float32 roundings of float64 expressions, computed
once, which the plain path (ops/pathtrace.py, ops/lights.py) and the
kernels' parameter block (ops/kernels/common.step_params) read alike, so
that both use the same bits."""

from __future__ import annotations

import numpy as np


def fog_sky(cfg) -> float:
    """The sky shell's distance: a miss ends its flight there."""
    return float(cfg.fog_sky_distance or 4.0 * cfg.world_size)


def fog_inv_sigma(cfg) -> float:
    """float32(1 / sigma), the division in float64."""
    return float(np.float32(1.0 / cfg.fog_density))


def fog_directional_transmittance(cfg) -> float:
    """float32(exp(-sigma * sky)), in float64: a directional light's
    Beer-Lambert factor (1 without fog)."""
    if cfg.fog_density <= 0.0:
        return 1.0
    return float(np.float32(np.exp(-cfg.fog_density * fog_sky(cfg))))
