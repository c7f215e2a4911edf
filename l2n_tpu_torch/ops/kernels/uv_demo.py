"""Animated UV-gradient kernel (counterpart of
l2n_tpu/ops/kernels/uv_demo.py): (3, H, W) =
(0.5(1+cos t) * col/W, 0.5(1+sin t) * row/H, 0). The smallest kernel of the
build chain, used as its smoke test."""

from __future__ import annotations

import torch

from l2n_tpu_torch.ops.kernels.common import check_tensor, launch_raw


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
    out = torch.empty((3, height, width), dtype=torch.float32,
                      device=time_s.device)
    launch_raw("uv_demo", time_s.device, height, width, time_s, out)
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
