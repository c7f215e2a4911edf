"""Camera pose persistence: the `l2n_cache.json` file.

Mirrors the reference exactly (src/main.cpp:794-816 load,
:1004-1012 save): a JSON object with a 16-float `view_matrix` key next to
the executable; any load failure falls back to the hard-coded default pose.
The reference serializes its column-major float4x4 as a flat list; we keep
that on-disk order (column-major) for file-level compatibility.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from l2n_tpu_torch.maths.linalg import DEFAULT_VIEW_MATRIX

CACHE_FILENAME = "l2n_cache.json"
_log = logging.getLogger(__name__)


def load_view_matrix(directory: str | Path = ".") -> np.ndarray:
    """Load the cached view matrix, or the default pose (main.cpp:794-816)."""
    path = Path(directory) / CACHE_FILENAME
    try:
        if path.exists():
            data = json.loads(path.read_text())
            values = data.get("view_matrix")
            if values is not None and len(values) == 16:
                # On-disk order is column-major (glm value_ptr).
                return np.asarray(values, np.float32).reshape(4, 4).T.copy()
    except Exception:  # fall back like the reference's catch(...) (:812-816)
        _log.warning("Unable to load json settings file")
    return DEFAULT_VIEW_MATRIX.copy()


def save_view_matrix(view: np.ndarray, directory: str | Path = ".") -> Path:
    """Save the pose on exit (main.cpp:1004-1012)."""
    path = Path(directory) / CACHE_FILENAME
    values = np.asarray(view, np.float32).T.reshape(-1).tolist()
    path.write_text(json.dumps({"view_matrix": values}, indent=4))
    return path
