"""launches_per_call.throughput: kernel launches per Renderer.step call, by
the program's own counters (l2n_tpu_torch/ops/kernels/common.py
`launches`, which counts a replay's held launches, over `graph_calls`'
eager calls and replays; a capture is replayed at once, so it counts as
its replay). The counters run from the process's start, so this covers
the run's set-up, window and traced stretch: a reader is handed no bounds
of the stretch. None for a program without `graph_calls`."""

import sys


def read(run):
    common = sys.modules.get("l2n_tpu_torch.ops.kernels.common")
    calls = getattr(common, "graph_calls", None)
    launches = getattr(common, "launches", None)
    if calls is None or launches is None:
        return None
    n = calls.get("eager", 0) + calls.get("replay", 0)
    return sum(launches.values()) / n if n else None
