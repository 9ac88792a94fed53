"""Row 1 of the kernel table (PERF.md): fused modulated LayerNorm
(``csrc/fused_ln.cu``).

Replaces ``var_tpu/ops/pallas/fused_ln.py::modulated_layernorm``:
``LN(x) * (scale + 1) + shift`` over the last dim of (B, L, C) with
per-sample (B, C) modulation, fp32 statistics in E[x^2] - mu^2 form and the
normalise/affine steps in the input dtype (``models/var.py::_ln``). Memory
bound on the H100; one warp per row, the row held in registers, so rows
of at most ``_LN_MAX_ROW_BYTES`` (bf16 C <= 8192, fp32 C <= 4096); see the
source note in the .cu file for the design.
"""

from __future__ import annotations

import torch

from var_tpu_torch.ops.cuda import build

# 32 lanes x 32 chunks of 16 bytes: the widest instantiation of the kernel
_LN_MAX_ROW_BYTES = 32 * 32 * 16


def modulated_layernorm_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                              eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version; the CPU path and the kernel's oracle."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var + eps)
    dt = x.dtype
    y = (x - mu.to(dt)) * inv.to(dt)
    return y * (scale.to(dt)[:, None] + 1.0) + shift.to(dt)[:, None]


def modulated_layernorm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """x: (B, L, C) float32/bfloat16; scale, shift: (B, C) float32 (rows may
    be strided, e.g. slices of the (B, 6, C) AdaLN table). CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return modulated_layernorm_plain(x, scale, shift, eps)
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("modulated_layernorm: x must be a contiguous (B, L, C) tensor")
    b, l, c = x.shape
    if (c * x.element_size()) % 16 or x.data_ptr() % 16:  # 16-byte row loads
        raise ValueError(f"modulated_layernorm: rows of {c} {x.dtype} are not 16-byte aligned")
    if c * x.element_size() > _LN_MAX_ROW_BYTES:  # the row lives in one warp's registers
        raise ValueError(f"modulated_layernorm: rows of {c} {x.dtype} exceed "
                         f"{_LN_MAX_ROW_BYTES} bytes")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, c) or t.stride(1) != 1:
            raise ValueError(f"modulated_layernorm: {name} must be float32 (B, C) with unit "
                             f"last stride, got {t.dtype} {tuple(t.shape)} {t.stride()}")
    build.require_cuda("modulated_layernorm", x, scale, shift)
    out = torch.empty_like(x)
    rc = build.lib().var_modulated_layernorm(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), b * l, l, c,
        scale.stride(0), shift.stride(0), float(eps), build.dtype_code(x.dtype),
        x.device.index, build.stream_of(x))
    build.check(rc, "modulated_layernorm")
    modulated_layernorm.launches += 1
    return out


modulated_layernorm.launches = 0
