"""Row 7 of the kernel table (PERF.md): GroupNorm channel statistics
(``csrc/gn_stats.cu``).

Replaces ``var_tpu/ops/pallas/gn_stats.py::gn_channel_stats``: per-(batch,
channel) float32 sum and sum of squares over the spatial dims, the
statistics pass of ``models/vae.py::group_norm(impl="pallas")``. The JAX
kernel reads NHWC; the port's activations on that path are dense NCHW, so
each (b, c) pair is one contiguous row and the kernel is a row reduction.
The VJP is JAX's ``_stats_bwd`` (``dx = g_s + 2 x g_ss``), computed in
PyTorch as JAX computes it in XLA: the backward has no kernel on either side.
"""

from __future__ import annotations

from typing import Tuple

import torch

from var_tpu_torch.ops.cuda import build


def gn_channel_stats_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version; the CPU path and the kernel's oracle.
    x: (B, C, H, W) -> two (B, C) float32 tensors."""
    xf = x.float()
    return xf.sum((2, 3)), (xf * xf).sum((2, 3))


def _stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward: the plain version for a CPU tensor, else the kernel."""
    if x.device.type == "cpu":
        return gn_channel_stats_plain(x)
    build.require_cuda("gn_channel_stats", x)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("gn_channel_stats: x must be a contiguous (B, C, H, W) tensor, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    b, c, h, w = x.shape
    s = torch.empty(b, c, dtype=torch.float32, device=x.device)
    ss = torch.empty_like(s)
    rc = build.lib().var_gn_channel_stats(
        x.data_ptr(), s.data_ptr(), ss.data_ptr(), b * c, h * w, build.dtype_code(x.dtype),
        x.device.index, build.stream_of(x))
    build.check(rc, "gn_channel_stats")
    gn_channel_stats.launches += 1
    return s, ss


class _GNChannelStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _stats(x)

    @staticmethod
    def backward(ctx, g_s, g_ss):
        (x,) = ctx.saved_tensors
        dx = g_s[:, :, None, None] + 2.0 * x.float() * g_ss[:, :, None, None]
        return dx.to(x.dtype)


def gn_channel_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, C, H, W) float32 or bfloat16 -> (sum, sum of squares), two
    (B, C) float32 tensors, differentiable. A CPU tensor takes the plain
    version; a CUDA tensor must be contiguous NCHW and launches the kernel."""
    return _GNChannelStats.apply(x)


gn_channel_stats.launches = 0
