"""Render layer: tile schedule, frame state, step, programs, renderer."""

from l2n_tpu_torch.render.tiles import tile_grid, advance_offset  # noqa: F401
from l2n_tpu_torch.render.state import FrameState, init_frame_state, clear_accumulation  # noqa: F401
from l2n_tpu_torch.render.step import build_render_step  # noqa: F401
from l2n_tpu_torch.render.program import (  # noqa: F401
    PathtracingProgram,
    SphereProgram,
    TriangleProgram,
)
from l2n_tpu_torch.render.renderer import Renderer  # noqa: F401
