"""Multi-card scaling over a torch.distributed (tile, sample) mesh
(counterpart of l2n_tpu.parallel).

The reference is single-process/single-GPU; its parallelism axes are
SIMT-over-pixels and progressive accumulation over time. Over several
ranks, one process each:

  * "tile" axis: the framebuffer is sharded into row slabs, one per rank;
    sampling is embarrassingly parallel (no traffic while rendering);
  * "sample" axis: replicas render the same slab with decorrelated random
    streams; their accumulations fold with one all_reduce per step (the
    one collective), so the display converges n_sample times faster per
    step.

`mesh.py` builds the mesh, `launch.py` starts the ranks of one host,
`step.py` holds the sharded step and `ShardedRenderer`, which runs it.
"""

from l2n_tpu_torch.parallel.mesh import make_device_mesh, mesh_factors  # noqa: F401
from l2n_tpu_torch.parallel.step import ShardedRenderer, build_sharded_step, init_sharded_state  # noqa: F401
