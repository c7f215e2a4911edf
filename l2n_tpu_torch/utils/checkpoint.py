"""Render-session checkpoints (counterpart of l2n_tpu.utils.checkpoint).

One NPZ holds the FrameState planes plus the config and the camera, so a
progressive render resumes bit-exactly across process restarts, the rng
state planes of the stateful modes included. The file is the JAX
package's: the same keys, dtypes and config bytes (render/state.py's
session form), so a session saved by either package loads in the other.
Sharded sessions (several cards) are not ported yet (ROADMAP Queue 1 #11).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from l2n_tpu_torch.config import RenderConfig
from l2n_tpu_torch.render.state import FrameState


def save_session(path: str | Path, cfg: RenderConfig, state: FrameState,
                 view_matrix: np.ndarray) -> Path:
    path = Path(path)
    arrays = state.to_session()
    rng_state = arrays.pop("rng_state", None)
    arrays["view_matrix"] = np.asarray(view_matrix, np.float32)
    if rng_state is not None:
        arrays["rng_state"] = rng_state
    np.savez_compressed(path, config=np.frombuffer(
        cfg.to_json().encode(), dtype=np.uint8), **arrays)
    return path


def load_session(path: str | Path, device="cuda"
                 ) -> tuple[RenderConfig, FrameState, np.ndarray]:
    """(config, the state on `device`, view matrix) of a session file."""
    with np.load(Path(path)) as data:
        cfg = RenderConfig.from_json(bytes(data["config"]).decode())
        state = FrameState.from_session(data, device)
        view = data["view_matrix"]
    return cfg, state, view
