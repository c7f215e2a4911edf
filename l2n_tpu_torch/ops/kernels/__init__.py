"""The kernel tier: hand-written CUDA kernels for Hopper, each beside its
plain torch version (counterpart of l2n_tpu.ops.kernels, whose Pallas TPU
kernels they replace).

  * `sphere_pt.sphere_pt` — csrc/sphere_pt.cu, replaces
    l2n_tpu/ops/kernels/sphere_pt.py::_kernel;
  * `uv_demo.uv_demo` — csrc/uv_demo.cu, replaces
    l2n_tpu/ops/kernels/uv_demo.py::_kernel.

A wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors; `common.launches` counts kernel launches.
The kernels build at first launch (`build.load`), never at import.
"""
