"""host_ms_per_frame.frame: the host's time per frame before it waits for
the device, from the camera update to the return of Renderer.step (the
camera block, the clear, the step's dispatch); the mean over the frames."""

import numpy as np


def read(run):
    host = run["window"].host_frame_ms
    return float(np.mean(host)) if host else None
