"""The kernel tier: hand-written CUDA kernels for Hopper, each beside its
plain torch version (counterpart of l2n_tpu.ops.kernels, whose Pallas TPU
kernels they replace).

  * `sphere_pt.sphere_pt` — csrc/sphere_pt.cu, replaces
    l2n_tpu/ops/kernels/sphere_pt.py::_kernel;
  * `triangle_pt.triangle_pt` — csrc/triangle_pt.cu, replaces
    l2n_tpu/ops/kernels/triangle_pt.py::_kernel (host packing in
    `triangle_pack`);
  * `uv_demo.uv_demo` — csrc/uv_demo.cu, replaces
    l2n_tpu/ops/kernels/uv_demo.py::_kernel.

The path body the two path-tracing kernels share is csrc/pathtrace.cuh.

A wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors; `common.launches` counts kernel launches.
The kernels build at first launch (`build.load`), never at import.
"""
