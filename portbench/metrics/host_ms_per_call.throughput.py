"""host_ms_per_call.throughput: the host clock around each Renderer.step
call of a mix that does not wait per frame (the replay's dispatch, and any
wait for room in the launch queue); the mean over the calls."""

import numpy as np


def read(run):
    w = run["window"]
    if w.frame_ms or not w.host_call_ms:
        return None
    return float(np.mean(w.host_call_ms))
