"""Image resizes with PyTorch ``F.interpolate`` semantics (counterpart of
``var_tpu/ops/resize.py``).

The reference quantizer calls ``F.interpolate`` itself (``models/quant.py``:
area downsample of residuals, bicubic upsample of code embeddings); the JAX
package re-derives those as weight matrices. Here the functions are the
reference's own operator. Public layout is NHWC, as in the JAX package; the
computation runs in float32 on NCHW and returns the input dtype.

Every mode is separable and linear, so its gradient is ``Wh^T g Ww`` with
the operator's own weight matrices (the operator applied to an identity).
Where a gradient is wanted the backward is taken that way, as two
matrix products: ``F.interpolate``'s CUDA backward scatters with atomic
adds, whose order (and last bits) varies from run to run, and the
tokenizer's training step must give the same bits eagerly and as a replay
of its CUDA graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize", "resize_area", "resize_bicubic", "resize_bilinear", "resize_nearest"]


def resize(x: torch.Tensor, out_hw: tuple, mode: str) -> torch.Tensor:
    """Resize NHWC ``x`` to ``(N, out_h, out_w, C)``; identity sizes return
    ``x`` unchanged."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    if mode not in ("area", "bicubic", "bilinear", "nearest"):
        raise ValueError(f"unknown resize mode: {mode}")
    x_nchw = x.permute(0, 3, 1, 2).float()
    if torch.is_grad_enabled() and x_nchw.requires_grad:
        y = _Resize.apply(x_nchw, tuple(out_hw), mode)
    else:
        y = _interpolate(x_nchw, tuple(out_hw), mode)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _interpolate(x: torch.Tensor, out_hw: tuple, mode: str) -> torch.Tensor:
    kw = {"align_corners": False} if mode in ("bicubic", "bilinear") else {}
    return F.interpolate(x, size=out_hw, mode=mode, **kw)


def _weights(n_in: int, n_out: int, mode: str, ref: torch.Tensor) -> torch.Tensor:
    """(n_out, n_in) weights of the 1-D operator along one axis: the
    operator applied to the identity (a width-1 axis passes through)."""
    eye = torch.eye(n_in, dtype=torch.float32, device=ref.device).reshape(n_in, 1, n_in, 1)
    return _interpolate(eye, (n_out, 1), mode)[:, 0, :, 0].T


class _Resize(torch.autograd.Function):
    """``F.interpolate`` forward; backward by the matrix products."""

    @staticmethod
    def forward(ctx, x, out_hw, mode):
        ctx.in_hw, ctx.mode = tuple(x.shape[2:]), mode
        return _interpolate(x, out_hw, mode)

    @staticmethod
    def backward(ctx, g):
        (h, w), (oh, ow) = ctx.in_hw, tuple(g.shape[2:])
        wh, ww = _weights(h, oh, ctx.mode, g), _weights(w, ow, ctx.mode, g)
        return torch.matmul(torch.matmul(wh.T, g), ww), None, None


def resize_area(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    return resize(x, out_hw, "area")


def resize_bicubic(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    return resize(x, out_hw, "bicubic")


def resize_bilinear(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    return resize(x, out_hw, "bilinear")


def resize_nearest(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    return resize(x, out_hw, "nearest")
