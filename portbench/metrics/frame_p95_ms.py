"""frame_p95_ms: the 95th percentile of every frame of the window, each
timed on the host clock from the camera update to the synchronized
output."""

import numpy as np


def read(run):
    frames = run["window"].frame_ms
    return float(np.percentile(frames, 95)) if frames else None
