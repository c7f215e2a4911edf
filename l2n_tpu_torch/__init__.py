"""l2n_tpu_torch — the progressive sphere path tracer in PyTorch and CUDA.

The port of `l2n_tpu` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA H100.
The layout mirrors `l2n_tpu/`: the counterpart of `l2n_tpu/rng/threefry.py`
is `l2n_tpu_torch/rng/threefry.py`, and so on. The JAX package is the
reference each module is tested against; this package imports neither
jax nor anything of `l2n_tpu`. Its `RenderConfig` (`config.py`) is its own
copy of the JAX package's, with the same fields and JSON form, so the two
packages read each other's configs and share goldens.

Two render backends (`render.step.build_render_step`):
  * "cuda"  — the hand-written CUDA kernels (`csrc/sphere_pt.cu`,
    `csrc/triangle_pt.cu`, and `csrc/wavefront.cu` for
    `RenderConfig(wavefront=True)`) over the scheduled tiles, built with
    nvcc at first use (ops/kernels/build.py);
  * "torch" — the plain tensor version of the same step, the counterpart of
    the JAX package's XLA oracle; it runs on the CPU or on a CUDA device.

Every `RenderConfig.rng` mode renders: threefry, tpu_hw (on the card a
Philox4x32-10 sampler, not a hardware stream: rng/philox.py) and the
stateful tinymt and tauslcg parity modes, whose per-pixel state planes ride
in the FrameState and through the kernels.

There is no automatic fallback: backend="cuda" without a card raises.
Every config the JAX package accepts renders (ops/kernels/common.
check_supported validates it; were a part still unported, it would raise
NotImplementedError naming the ROADMAP item that ports it).
"""

__version__ = "0.1.0"

from l2n_tpu_torch.config import RenderConfig  # noqa: F401
