"""frame_p50_ms.frame: the median of the same frames as frame_p95_ms."""

import numpy as np


def read(run):
    frames = run["window"].frame_ms
    return float(np.median(frames)) if frames else None
