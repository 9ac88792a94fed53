"""Kernel 3: decode attention over the KV cache (``csrc/flash_attention.cu``).

Replaces ``var_tpu/ops/pallas/flash_attention.py::flash_decode_paired_chunks``.
The JAX decode keeps per-stage K/V chunks because its arrays are immutable;
the port keeps one preallocated (depth, 2B, L, C) K buffer and one V buffer
written in place each stage, and the kernel reads layer ``i``, rows
``[0, lk)``, by pointer and stride. That is the chunked kernel's function:
attention over the concatenation of every stage so far
(``flash_attention.py:576-577``).

q is read from the first C lanes of the fused (B, Lq, 3C) qkv. With
``q_l2_scale_mul`` ((H,) fp32, ``exp(min(scale_mul, ln 100))``) the per-head
q L2 norm runs in the kernel; ``scale`` multiplies the logits after the dot.
The kernel serves head_dim 64 (every published model); other head sizes run
only on the CPU through the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from var_tpu_torch.ops.attention import attention
from var_tpu_torch.ops.cuda import build

HEAD_DIM = 64


def flash_decode_plain(qkv: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lk: int,
                       num_heads: int, scale: float = 1.0,
                       q_l2_scale_mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version; the CPU path and the kernel's oracle.
    qkv: (B, Lq, >= C); k, v: (B, >= lk, C). Returns (B, Lq, C)."""
    b, lq, _ = qkv.shape
    c = k.shape[-1]
    h, d = num_heads, c // num_heads
    q = qkv[..., :c]
    if q_l2_scale_mul is not None:
        qf = q.float().reshape(b, lq, h, d)
        inv = torch.rsqrt((qf * qf).sum(-1, keepdim=True) + 1e-24)
        inv = inv * q_l2_scale_mul.float().reshape(h, 1)
        q = (qf * inv).to(qkv.dtype).reshape(b, lq, c)
    out = attention(q.reshape(b, lq, h, d), k[:, :lk].reshape(b, lk, h, d),
                    v[:, :lk].reshape(b, lk, h, d), scale)
    return out.reshape(b, lq, c)


def flash_decode(qkv: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lk: int,
                 num_heads: int, scale: float = 1.0,
                 q_l2_scale_mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of the Lq queries in ``qkv[..., :C]`` over cache rows
    ``[0, lk)`` of ``k``/``v`` (one layer's (B, Lmax, C) view of the cache).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if qkv.device.type == "cpu":
        return flash_decode_plain(qkv, k, v, lk, num_heads, scale, q_l2_scale_mul)
    tensors = (qkv, k, v) + ((q_l2_scale_mul,) if q_l2_scale_mul is not None else ())
    build.require_cuda("flash_decode", *tensors)
    b, lq, cq = qkv.shape
    c = k.shape[-1]
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"flash_decode: the CUDA kernel takes head_dim {HEAD_DIM}, "
                         f"got C={c} over {num_heads} heads")
    if k.dtype != qkv.dtype or v.dtype != qkv.dtype:
        raise ValueError("flash_decode: qkv, k and v must share one dtype")
    if k.dim() != 3 or k.shape != v.shape or k.shape[0] != b or cq < c:
        raise ValueError(f"flash_decode: bad shapes qkv {tuple(qkv.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if not 1 <= lk <= k.shape[1]:
        raise ValueError(f"flash_decode: lk={lk} outside [1, {k.shape[1]}]")
    if qkv.stride(-1) != 1 or k.stride(-1) != 1 or k.stride() != v.stride():
        raise ValueError("flash_decode: last dims must be contiguous and k, v strided alike")
    if qkv.dtype == torch.bfloat16 and any(  # the bf16 kernel loads 16-byte rows
            t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8 for t in (qkv, k, v)):
        raise ValueError("flash_decode: bf16 tensors need 16-byte aligned rows")
    sm_ptr = None
    if q_l2_scale_mul is not None:
        if (q_l2_scale_mul.dtype != torch.float32 or q_l2_scale_mul.numel() != num_heads
                or not q_l2_scale_mul.is_contiguous()):
            raise ValueError("flash_decode: q_l2_scale_mul must be contiguous float32 (H,)")
        sm_ptr = q_l2_scale_mul.data_ptr()
    out = torch.empty(b, lq, c, dtype=qkv.dtype, device=qkv.device)
    rc = build.lib().var_decode_attention(
        qkv.data_ptr(), qkv.stride(0), qkv.stride(1), k.data_ptr(), v.data_ptr(),
        k.stride(0), k.stride(1), out.data_ptr(), out.stride(0), out.stride(1), sm_ptr,
        b, lq, int(lk), num_heads, HEAD_DIM, float(scale), build.dtype_code(qkv.dtype),
        qkv.device.index, build.stream_of(qkv))
    build.check(rc, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
