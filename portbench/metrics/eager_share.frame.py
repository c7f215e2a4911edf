"""eager_share.frame: the share of render-step calls that the host
dispatched launch by launch, by the program's own counter
(l2n_tpu_torch/ops/kernels/common.py `graph_calls`): eager / (eager +
replays), in percent. The counter runs from the process's start, so this
covers the run's set-up, window and traced stretch: a reader is handed no
bounds of the stretch. None for a program without the counter."""

import sys


def read(run):
    common = sys.modules.get("l2n_tpu_torch.ops.kernels.common")
    calls = getattr(common, "graph_calls", None)
    if calls is None:
        return None
    n = calls.get("eager", 0) + calls.get("replay", 0)
    return 100.0 * calls.get("eager", 0) / n if n else None
