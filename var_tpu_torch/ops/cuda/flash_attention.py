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

Kernels 4-5: teacher-forced block-causal attention for training
(``csrc/flash_attention_train.cu``), replacing
``var_tpu/ops/pallas/flash_attention.py::flash_attention_paired_train``:
:func:`flash_attention_paired_train` is a ``torch.autograd.Function`` whose
forward (:func:`paired_train_fwd`) returns ``out`` and saves the (B, H, L)
fp32 log-sum-exp, and whose backward (:func:`paired_train_bwd`) recomputes
p from it and returns dq, dk, dv.

The kernels serve head_dim 64 (every published model); other head sizes run
only on the CPU through the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from var_tpu_torch.ops.attention import attention, block_causal_logits
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


# ---------------------------------------------------------------------------
# teacher-forced training attention


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, c = t.shape
    return t.reshape(b, l, num_heads, c // num_heads)


def paired_train_fwd_plain(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                           ends: Optional[Tuple[int, ...]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward: (out (B, L, C) in the input dtype, lse (B, H, L)
    float32) of block-causal attention over merged tensors, q pre-scaled."""
    qh, kh, vh = (_heads(t, num_heads) for t in (qs, k, v))
    logits = block_causal_logits(qh, kh, 1.0, ends)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None]).to(v.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", p, vh).to(qs.dtype)
    return out.reshape(qs.shape), lse


def paired_train_bwd_plain(qs, k, v, do, lse, delta, num_heads: int,
                           ends: Optional[Tuple[int, ...]]):
    """Plain PyTorch backward from the saved lse: p = exp(s - lse),
    ds = p * (do v^T - delta), dq = ds k, dk = ds^T q, dv = p^T do, with p
    and ds rounded to the input dtype before their products, as the kernels
    (and the TPU kernels) do. ``delta``: (B, H, L) float32."""
    dt = qs.dtype
    qh, kh, vh, doh = (_heads(t, num_heads) for t in (qs, k, v, do))
    p = torch.exp(block_causal_logits(qh, kh, 1.0, ends) - lse[..., None])  # 0 where masked
    dp = torch.einsum("blhd,bmhd->bhlm", doh.float(), vh.float())
    ds = p * (dp - delta[..., None])
    p, ds = p.to(dt).float(), ds.to(dt).float()
    dq = torch.einsum("bhlm,bmhd->blhd", ds, kh.float())
    dk = torch.einsum("bhlm,blhd->bmhd", ds, qh.float())
    dv = torch.einsum("bhlm,blhd->bmhd", p, doh.float())
    return tuple(g.reshape(t.shape).to(dt) for g, t in ((dq, qs), (dk, k), (dv, v)))


def _ends_arg(ends):
    if not ends:
        return None, 0
    return (ctypes.c_int * len(ends))(*ends), len(ends)


def _check_train(name: str, num_heads: int, q_side, kv_side, lse=None) -> None:
    """q_side: tensors shaped like q (B, Lq, C); kv_side: like k (B, Lk, C);
    ``lse``: (B, H, Lq) float32."""
    build.require_cuda(name, *q_side, *kv_side, *([lse] if lse is not None else []))
    q, k = q_side[0], kv_side[0]
    if q.dim() != 3 or k.dim() != 3 or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"{name}: want q (B, Lq, C) and k (B, Lk, C), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, lq, c = q.shape
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim {HEAD_DIM}, "
                         f"got C={c} over {num_heads} heads")
    for t, want in [(t, q.shape) for t in q_side] + [(t, k.shape) for t in kv_side]:
        if t.shape != want or t.dtype != q.dtype:
            raise ValueError(f"{name}: want {tuple(want)} {q.dtype}, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and 16-byte aligned")
    if lse is not None and (lse.shape != (b, num_heads, lq) or lse.dtype != torch.float32
                            or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be contiguous float32 {(b, num_heads, lq)}")


def paired_train_fwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                     ends: Optional[Tuple[int, ...]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of :func:`flash_attention_paired_train` on pre-scaled q:
    (out, lse). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if qs.device.type == "cpu":
        return paired_train_fwd_plain(qs, k, v, num_heads, ends)
    _check_train("paired_train_fwd", num_heads, (qs,), (k, v))
    b, lq, c = qs.shape
    out = torch.empty_like(qs)
    lse = torch.empty(b, num_heads, lq, dtype=torch.float32, device=qs.device)
    arr, n = _ends_arg(ends)
    rc = build.lib().var_ptrain_fwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, lq,
        k.shape[1], num_heads, HEAD_DIM, arr, n, build.dtype_code(qs.dtype), qs.device.index,
        build.stream_of(qs))
    build.check(rc, "paired_train_fwd")
    paired_train_fwd.launches += 1
    return out, lse


def paired_train_delta(out: torch.Tensor, do: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, H, L) float32 delta = sum_d do * o within each head, the layout of lse."""
    b, l, c = out.shape
    delta = (do.float() * out.float()).reshape(b, l, num_heads, c // num_heads).sum(-1)
    return delta.transpose(1, 2).contiguous()


def paired_train_bwd(qs, k, v, out, lse, do, num_heads: int,
                     ends: Optional[Tuple[int, ...]]):
    """Backward of :func:`flash_attention_paired_train`: (dq, dk, dv), dq
    with respect to the pre-scaled q. delta = sum_d do * o per (row, head)
    is one elementwise pass here, as the JAX package computes it outside
    its kernels (``flash_attention.py:1047-1052``). CPU tensors take the
    plain version; CUDA tensors launch the dQ and the dK/dV kernel."""
    delta = paired_train_delta(out, do, num_heads)
    if qs.device.type == "cpu":
        return paired_train_bwd_plain(qs, k, v, do, lse, delta, num_heads, ends)
    _check_train("paired_train_bwd", num_heads, (qs, do), (k, v), lse)
    b, lq, _ = qs.shape
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v)
    arr, n = _ends_arg(ends)
    rc = build.lib().var_ptrain_bwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, lq, k.shape[1],
        num_heads, HEAD_DIM, arr, n, build.dtype_code(qs.dtype), qs.device.index,
        build.stream_of(qs))
    build.check(rc, "paired_train_bwd")
    paired_train_bwd.launches += 1
    return dq, dk, dv


paired_train_fwd.launches = 0
paired_train_bwd.launches = 0


class _PairedTrainAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qs, k, v, num_heads, ends):
        out, lse = paired_train_fwd(qs, k, v, num_heads, ends)
        ctx.save_for_backward(qs, k, v, out, lse)
        ctx.num_heads, ctx.ends = num_heads, ends
        return out

    @staticmethod
    def backward(ctx, do):
        qs, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = paired_train_bwd(qs, k, v, out, lse, do.contiguous(), ctx.num_heads,
                                      ctx.ends)
        return dq, dk, dv, None, None


def flash_attention_paired_train(q_m: torch.Tensor, k_m: torch.Tensor, v_m: torch.Tensor,
                                 num_heads: int, scale: float = 1.0,
                                 scale_ends: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Teacher-forced attention over merged (B, L, C) q/k/v with the
    block-causal mask of ``scale_ends`` (none: unmasked), differentiable,
    with O(B L C) residuals (q, k, v, out, lse). ``scale`` is folded into q
    before the call, rounded to q's dtype, as in the JAX package
    (``flash_attention.py:1182``)."""
    ends = tuple(int(e) for e in scale_ends) if scale_ends is not None else None
    if ends is not None and q_m.shape[1] != k_m.shape[1]:
        raise ValueError("scale_ends requires full-sequence q (no KV cache offset)")
    if ends is not None and (not ends or ends[0] < 1
                             or any(b <= a for a, b in zip(ends, ends[1:]))):
        raise ValueError(f"scale_ends must be positive and increasing, got {ends}")
    qs = q_m if scale == 1.0 else (q_m.float() * scale).to(q_m.dtype)
    return _PairedTrainAttention.apply(qs.contiguous(), k_m.contiguous(), v_m.contiguous(),
                                       num_heads, ends)
