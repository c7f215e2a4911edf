"""Animated UV-gradient kernel (counterpart of
l2n_tpu/ops/kernels/uv_demo.py): (3, H, W) =
(0.5(1+cos t) * col/W, 0.5(1+sin t) * row/H, 0). The smallest kernel of the
build chain, used as its smoke test."""

from __future__ import annotations

import ctypes

import torch

from l2n_tpu_torch.ops.kernels.common import check_tensor, launches


def uv_demo(time_s: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(3, height, width) float32 on the device of `time_s` (a one-element
    float32 tensor): the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    check_tensor("time_s", time_s, torch.float32, (1,), time_s.device)
    if height <= 0 or width <= 0:
        raise ValueError("uv_demo: height and width must be positive")
    if time_s.device.type == "cpu":
        return uv_demo_plain(time_s, height, width)
    if time_s.device.type != "cuda":
        raise ValueError(f"uv_demo: no kernel for device {time_s.device}")
    from l2n_tpu_torch.ops.kernels import build
    lib = build.load()
    out = torch.empty((3, height, width), dtype=torch.float32,
                      device=time_s.device)
    with torch.cuda.device(time_s.device):
        stream = torch.cuda.current_stream(time_s.device).cuda_stream
        rc = lib.l2n_uv_demo(height, width, ctypes.c_void_p(time_s.data_ptr()),
                             ctypes.c_void_p(out.data_ptr()),
                             ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"uv_demo kernel launch failed: CUDA error {rc}")
    launches["uv_demo"] += 1
    return out


def uv_demo_plain(time_s: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The plain torch version of `uv_demo`, on `time_s`'s device."""
    dev = time_s.device
    f32 = torch.float32
    row = torch.arange(height, dtype=f32, device=dev).view(-1, 1)
    col = torch.arange(width, dtype=f32, device=dev).view(1, -1)
    # Divide by device tensors: a CUDA division by a Python scalar is a
    # multiplication by its reciprocal, which the kernel does not do.
    u = (col / torch.full((1, 1), width, dtype=f32, device=dev)).expand(height, width)
    v = (row / torch.full((1, 1), height, dtype=f32, device=dev)).expand(height, width)
    t = time_s[0]
    return torch.stack([0.5 * (1.0 + torch.cos(t)) * u,
                        0.5 * (1.0 + torch.sin(t)) * v,
                        torch.zeros((height, width), dtype=f32, device=dev)])
