"""Image resizes with PyTorch ``F.interpolate`` semantics (counterpart of
``var_tpu/ops/resize.py``).

The reference quantizer calls ``F.interpolate`` itself (``models/quant.py``:
area downsample of residuals, bicubic upsample of code embeddings); the JAX
package re-derives those as weight matrices. Here the functions are the
reference's own operator. Public layout is NHWC, as in the JAX package; the
computation runs in float32 on NCHW and returns the input dtype.
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
    kw = {"align_corners": False} if mode in ("bicubic", "bilinear") else {}
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=tuple(out_hw), mode=mode, **kw)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def resize_area(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    return resize(x, out_hw, "area")


def resize_bicubic(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    return resize(x, out_hw, "bicubic")


def resize_bilinear(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    return resize(x, out_hw, "bilinear")


def resize_nearest(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    return resize(x, out_hw, "nearest")
