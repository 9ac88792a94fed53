"""Attention kernels of the port, numbered as the kernel table in PERF.md.

Row 2: decode attention over the KV cache (``csrc/flash_attention.cu``,
:func:`flash_decode`), replacing
``var_tpu/ops/pallas/flash_attention.py::flash_decode_paired_chunks``. The
JAX decode keeps per-stage K/V chunks because its arrays are immutable;
the port keeps one preallocated (depth, 2B, L, C) K buffer and one V buffer
written in place each stage, and the kernel reads layer ``i``, rows
``[0, lk)``, by pointer and stride. That is the chunked kernel's function:
attention over the concatenation of every stage so far
(``flash_attention.py:576-577``). q is read from the first C lanes of the
fused (B, Lq, 3C) qkv. With ``q_l2_scale_mul`` ((H,) fp32,
``exp(min(scale_mul, ln 100))``) the per-head q L2 norm runs in the kernel;
``scale`` multiplies the logits after the dot.

Row 4: decode attention over a contiguous merged (B, Lk, C) cache
(``csrc/flash_attention.cu``, :func:`flash_decode_paired`), replacing
``flash_attention.py::flash_decode_paired``: the scale is folded into q
before the dot. q is read as row 2 reads it, from the first C lanes of
(B, Lq, >= C) ``q_m`` (the fused qkv, as the model passes it); with
``q_l2_scale_mul`` the per-head q norm runs in the launch (what JAX's
``_split_norm`` does before its kernel). It serves the
``prealloc``/``concat`` caches and ``kv_window`` pruning, over rows
``[0, lk)`` of the same in-place buffer.

Row 5: streaming flash attention over BLHD tensors, forward and backward
(``csrc/flash_attention_train.cu``, the ``kRow = 5`` instantiation, entries
``var_flash_fwd``/``var_flash_bwd``), replacing
``flash_attention.py::flash_attention`` (:375) and its VJP:
:func:`flash_attention` folds the scale into q, then runs
:func:`flash_attention_fwd` (out and the (B, H, Lq) fp32 log-sum-exp) and,
in backward, :func:`flash_attention_bwd` (dq, dk, dv from out and the lse;
on the card delta = sum_d do * out is computed in the dQ kernel's launch).
It serves the ``pallas`` and ``hybrid`` training impls and the eval of the
512px and 1024px presets; unmasked, Lq may differ from Lk. Fewer than 8
queries or keys take JAX's dense branch (``:398-406``), no kernel.

Row 6: teacher-forced block-causal attention for training
(``csrc/flash_attention_train.cu``, ``kRow = 6``), replacing
``flash_attention.py::flash_attention_paired_train``:
:func:`flash_attention_paired_train` is a ``torch.autograd.Function`` whose
forward (:func:`paired_train_fwd`) returns ``out`` and saves the (B, H, L)
fp32 log-sum-exp, and whose backward (:func:`paired_train_bwd`) recomputes
p from it and returns dq, dk, dv. Over merged (B, L, C) tensors it computes
what row 5 computes over the same bytes viewed as (B, L, H, 64).

The kernels serve head_dim 64 (every published model); other head sizes run
only on the CPU through the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from var_tpu_torch.ops.attention import attention_fp32_logits, block_causal_logits, dense_probs
from var_tpu_torch.ops.cuda import build

HEAD_DIM = 64


def _l2_norm_q(q: torch.Tensor, num_heads: int, scale_mul: torch.Tensor) -> torch.Tensor:
    """Per-head L2 norm of merged (B, L, C) ``q`` in fp32 times ``scale_mul``
    (H,), rounded to q's dtype: what the kernels do to q in their launch."""
    b, l, c = q.shape
    qf = q.float().reshape(b, l, num_heads, c // num_heads)
    inv = torch.rsqrt((qf * qf).sum(-1, keepdim=True) + 1e-24)
    inv = inv * scale_mul.float().reshape(num_heads, 1)
    return (qf * inv).to(q.dtype).reshape(b, l, c)


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
        q = _l2_norm_q(q, h, q_l2_scale_mul)
    out = attention_fp32_logits(q.reshape(b, lq, h, d), k[:, :lk].reshape(b, lk, h, d),
                                v[:, :lk].reshape(b, lk, h, d), scale)
    return out.reshape(b, lq, c)


def _check_decode(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lk: int,
                  num_heads: int, q_l2_scale_mul: Optional[torch.Tensor]) -> Optional[int]:
    """What both decode kernels take: CUDA tensors of one dtype, q (B, Lq,
    >= C) and k, v (B, Lmax, C) with head_dim 64, 1 <= lk <= Lmax, unit
    stride along C, k and v strided alike, 16-byte aligned bf16 rows, and
    ``q_l2_scale_mul`` None or contiguous float32 (H,) on q's device.
    Returns the pointer to pass for ``q_l2_scale_mul``."""
    build.require_cuda(name, q, k, v)
    c = k.shape[-1]
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes head_dim {HEAD_DIM}, "
                         f"got C={c} over {num_heads} heads")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v must share one dtype")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or q.shape[2] < c:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if not 1 <= lk <= k.shape[1]:
        raise ValueError(f"{name}: lk={lk} outside [1, {k.shape[1]}]")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or k.stride() != v.stride():
        raise ValueError(f"{name}: last dims must be contiguous and k, v strided alike")
    if q.dtype == torch.bfloat16 and any(  # the bf16 kernel loads 16-byte rows
            t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8 for t in (q, k, v)):
        raise ValueError(f"{name}: bf16 tensors need 16-byte aligned rows")
    if q_l2_scale_mul is None:
        return None
    if (q_l2_scale_mul.device != q.device or q_l2_scale_mul.dtype != torch.float32
            or q_l2_scale_mul.numel() != num_heads or not q_l2_scale_mul.is_contiguous()):
        raise ValueError(f"{name}: q_l2_scale_mul must be contiguous float32 (H,) "
                         "on q's device")
    return q_l2_scale_mul.data_ptr()


def flash_decode(qkv: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lk: int,
                 num_heads: int, scale: float = 1.0,
                 q_l2_scale_mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of the Lq queries in ``qkv[..., :C]`` over cache rows
    ``[0, lk)`` of ``k``/``v`` (one layer's (B, Lmax, C) view of the cache).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if qkv.device.type == "cpu":
        return flash_decode_plain(qkv, k, v, lk, num_heads, scale, q_l2_scale_mul)
    sm_ptr = _check_decode("flash_decode", qkv, k, v, lk, num_heads, q_l2_scale_mul)
    b, lq, _ = qkv.shape
    c = k.shape[-1]
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


def _prescale(q_m: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale rounded to q's dtype (``flash_attention.py:658``)."""
    return q_m if scale == 1.0 else (q_m.float() * scale).to(q_m.dtype)


def flash_decode_paired_plain(q_m: torch.Tensor, k_m: torch.Tensor, v_m: torch.Tensor,
                              num_heads: int, scale: float = 1.0, lk: Optional[int] = None,
                              q_l2_scale_mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of row 4; the CPU path and the kernel's oracle.
    q_m: (B, Lq, >= C), of which the first C lanes are read, normalised
    here first with ``q_l2_scale_mul`` (H,) (:func:`_l2_norm_q`); k_m, v_m:
    (B, >= lk, C). The scale is folded
    into q and rounded to its dtype before the dot, the softmax runs in fp32
    and its weights are rounded to v's dtype before the PV product. Returns
    (B, Lq, C) in q's dtype."""
    b, lq = q_m.shape[:2]
    c = k_m.shape[2]
    lk = k_m.shape[1] if lk is None else lk
    h, d = num_heads, c // num_heads
    q = q_m[..., :c]
    if q_l2_scale_mul is not None:
        q = _l2_norm_q(q, h, q_l2_scale_mul)
    out = attention_fp32_logits(_prescale(q, scale).reshape(b, lq, h, d),
                                k_m[:, :lk].reshape(b, lk, h, d),
                                v_m[:, :lk].reshape(b, lk, h, d), 1.0)
    return out.reshape(b, lq, c)


def flash_decode_paired(q_m: torch.Tensor, k_m: torch.Tensor, v_m: torch.Tensor,
                        num_heads: int, scale: float = 1.0, lk: Optional[int] = None,
                        q_l2_scale_mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of the Lq queries in ``q_m[..., :C]`` ((B, Lq, >= C), e.g.
    the fused qkv) over rows ``[0, lk)`` of ``k_m``/``v_m`` (B, >= lk, C; by
    default all of them), with ``scale`` folded into q before the dot. With
    ``q_l2_scale_mul`` ((H,) fp32) the kernel first normalises q per head in
    fp32, times the scales, and rounds to q's dtype -- JAX's ``_split_norm``
    followed by ``flash_decode_paired``, in one launch. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q_m.device.type == "cpu":
        return flash_decode_paired_plain(q_m, k_m, v_m, num_heads, scale, lk, q_l2_scale_mul)
    lk = k_m.shape[1] if lk is None else int(lk)
    sm_ptr = _check_decode("flash_decode_paired", q_m, k_m, v_m, lk, num_heads,
                           q_l2_scale_mul)
    b, lq, _ = q_m.shape
    c = k_m.shape[2]
    out = torch.empty(b, lq, c, dtype=q_m.dtype, device=q_m.device)
    rc = build.lib().var_decode_attention_paired(
        q_m.data_ptr(), q_m.stride(0), q_m.stride(1), k_m.data_ptr(), v_m.data_ptr(),
        k_m.stride(0), k_m.stride(1), out.data_ptr(), out.stride(0), out.stride(1), sm_ptr, b,
        lq, lk, num_heads, HEAD_DIM, float(scale), build.dtype_code(q_m.dtype),
        q_m.device.index, build.stream_of(q_m))
    build.check(rc, "flash_decode_paired")
    flash_decode_paired.launches += 1
    return out


flash_decode_paired.launches = 0


# ---------------------------------------------------------------------------
# teacher-forced training attention


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, c = t.shape
    return t.reshape(b, l, num_heads, c // num_heads)


def _stats_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype of the plain versions' softmax statistics: float64 on the
    CPU, where a float32 ``logsumexp`` gave another value for one intra-op
    thread's rows in some processes, so that the CPU path repeats bit for
    bit; float32 on CUDA, where these functions are the kernels' oracles at
    full size."""
    return torch.float64 if t.device.type == "cpu" else torch.float32


def paired_train_fwd_plain(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                           ends: Optional[Tuple[int, ...]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward: (out (B, L, C) in the input dtype, lse (B, H, L)
    float32) of block-causal attention over merged tensors, q pre-scaled.
    The float32 logits' lse is taken in :func:`_stats_dtype` and rounded to
    float32 before p = exp(s - lse) uses it, as the backward uses it: a
    float64 sum's last bits still vary between processes, its float32
    rounding does not."""
    qh, kh, vh = (_heads(t, num_heads) for t in (qs, k, v))
    logits = block_causal_logits(qh, kh, 1.0, ends).to(_stats_dtype(qs))
    lse = torch.logsumexp(logits, dim=-1).float()
    p = torch.exp(logits - lse[..., None]).to(v.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", p, vh).to(qs.dtype)
    return out.reshape(qs.shape), lse


def paired_train_bwd_plain(qs, k, v, do, lse, delta, num_heads: int,
                           ends: Optional[Tuple[int, ...]]):
    """Plain PyTorch backward from the saved lse: p = exp(s - lse),
    ds = p * (do v^T - delta), dq = ds k, dk = ds^T q, dv = p^T do, with p
    and ds rounded to the input dtype before their products, as the kernels
    (and the TPU kernels) do; p in :func:`_stats_dtype` before that.
    ``delta``: (B, H, L) float32."""
    dt = qs.dtype
    qh, kh, vh, doh = (_heads(t, num_heads) for t in (qs, k, v, do))
    logits = block_causal_logits(qh, kh, 1.0, ends).to(_stats_dtype(qs))
    p = torch.exp(logits - lse[..., None])  # 0 where masked
    dp = torch.einsum("blhd,bmhd->bhlm", doh.float(), vh.float())
    ds = p * (dp - delta[..., None])
    p, ds = p.to(dt).float(), ds.to(dt).float()
    dq = torch.einsum("bhlm,bmhd->blhd", ds, kh.float())
    dk = torch.einsum("bhlm,blhd->bmhd", ds, qh.float())
    dv = torch.einsum("bhlm,blhd->bmhd", p, doh.float())
    return tuple(g.reshape(t.shape).to(dt) for g, t in ((dq, qs), (dk, k), (dv, v)))


def _check_ends(ends: Optional[Tuple[int, ...]]) -> None:
    if ends is not None and (not ends or ends[0] < 1
                             or any(b <= a for a, b in zip(ends, ends[1:]))):
        raise ValueError(f"scale_ends must be positive and increasing, got {ends}")


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
    kernel: in bf16 the wgmma kernel, which reads q, k and v by TMA (hence
    contiguous, 16-byte aligned tensors), in fp32 the CUDA-core one."""
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
    """(B, H, L) float32 delta = sum_d do * o within each head, the layout of
    lse: the plain path's helper and the oracle of the delta the backward
    kernels compute in their launch."""
    b, l, c = out.shape
    delta = (do.float() * out.float()).reshape(b, l, num_heads, c // num_heads).sum(-1)
    return delta.transpose(1, 2).contiguous()


def _bwd_scratch(b: int, num_heads: int, lq: int, device) -> torch.Tensor:
    """The fp32 scratch a backward launch fills and reads: the bf16 dQ
    kernel writes the lse and delta of every query row, (B, H, 2, Lq
    rounded up to 64 rows), for the dK/dV kernel; the fp32 path its delta."""
    rows = -(-lq // 64) * 64
    return torch.empty(b * num_heads * 2 * rows, dtype=torch.float32, device=device)


def paired_train_bwd(qs, k, v, out, lse, do, num_heads: int,
                     ends: Optional[Tuple[int, ...]]):
    """Backward of :func:`flash_attention_paired_train`: (dq, dk, dv), dq
    with respect to the pre-scaled q. delta = sum_d do * o per (row, head),
    which the JAX package computes outside its kernels
    (``flash_attention.py:1047-1052``), is one elementwise pass on the CPU
    (:func:`paired_train_delta`) and part of the dQ kernel's launch on the
    card. CPU tensors take the plain version; CUDA tensors launch the dQ and
    the dK/dV kernel."""
    if qs.device.type == "cpu":
        return paired_train_bwd_plain(qs, k, v, do, lse, paired_train_delta(out, do, num_heads),
                                      num_heads, ends)
    _check_train("paired_train_bwd", num_heads, (qs, out, do), (k, v), lse)
    b, lq, _ = qs.shape
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v)
    scratch = _bwd_scratch(b, num_heads, lq, qs.device)
    arr, n = _ends_arg(ends)
    rc = build.lib().var_ptrain_bwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, lq,
        k.shape[1], num_heads, HEAD_DIM, arr, n, build.dtype_code(qs.dtype), qs.device.index,
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
    _check_ends(ends)
    qs = q_m if scale == 1.0 else (q_m.float() * scale).to(q_m.dtype)
    return _PairedTrainAttention.apply(qs.contiguous(), k_m.contiguous(), v_m.contiguous(),
                                       num_heads, ends)


# ---------------------------------------------------------------------------
# row 5: streaming flash attention over BLHD tensors


def _merged(t: torch.Tensor) -> torch.Tensor:
    """(B, L, H, D) -> (B, L, H * D): a view of a contiguous tensor."""
    b, l, h, d = t.shape
    return t.reshape(b, l, h * d)


def flash_attention_fwd_plain(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              ends: Optional[Tuple[int, ...]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch forward of row 5 on pre-scaled BLHD q: (out (B, Lq, H, D)
    in the input dtype, lse (B, H, Lq) float32); the CPU path and the
    kernel's oracle. ``ends``: the block-causal mask, or None (unmasked)."""
    out, lse = paired_train_fwd_plain(_merged(qs), _merged(k), _merged(v), qs.shape[2], ends)
    return out.reshape(qs.shape), lse


def flash_attention_bwd_plain(qs, k, v, do, lse, delta, ends: Optional[Tuple[int, ...]]):
    """Plain PyTorch backward of row 5 from the saved lse and delta (B, H,
    Lq) float32: (dq, dk, dv) BLHD in the input dtype, p and ds rounded to
    it before their products, as the kernels (and the TPU kernels) do."""
    grads = paired_train_bwd_plain(_merged(qs), _merged(k), _merged(v), _merged(do), lse, delta,
                                   qs.shape[2], ends)
    return tuple(g.reshape(t.shape) for g, t in zip(grads, (qs, k, v)))


def flash_attention_fwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        ends: Optional[Tuple[int, ...]]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of :func:`flash_attention` on pre-scaled contiguous BLHD q, k,
    v: (out, lse). CPU tensors take the plain version; CUDA tensors launch
    the kernel: in bf16 the wgmma kernel, which reads q, k and v by TMA
    (hence contiguous, 16-byte aligned tensors), in fp32 the CUDA-core one."""
    if qs.device.type == "cpu":
        return flash_attention_fwd_plain(qs, k, v, ends)
    b, lq, h, _ = qs.shape
    _check_train("flash_attention_fwd", h, (_merged(qs),), (_merged(k), _merged(v)))
    out = torch.empty_like(qs)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=qs.device)
    arr, n = _ends_arg(ends)
    rc = build.lib().var_flash_fwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, lq,
        k.shape[1], h, HEAD_DIM, arr, n, build.dtype_code(qs.dtype), qs.device.index,
        build.stream_of(qs))
    build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd(qs, k, v, out, lse, do, ends: Optional[Tuple[int, ...]]):
    """Backward of :func:`flash_attention`: (dq, dk, dv), dq with respect to
    the pre-scaled q. delta = sum_d do * out per (row, head), in float32 from
    the rounded output, which the JAX package computes outside its kernels
    (``flash_attention.py:303``), is one elementwise pass on the CPU and part
    of the dQ kernel's launch on the card. CPU tensors take the plain
    version; CUDA tensors launch the dQ and the dK/dV kernel."""
    h = qs.shape[2]
    if qs.device.type == "cpu":
        delta = paired_train_delta(_merged(out), _merged(do), h)
        return flash_attention_bwd_plain(qs, k, v, do, lse, delta, ends)
    b, lq = qs.shape[:2]
    _check_train("flash_attention_bwd", h, (_merged(qs), _merged(out), _merged(do)),
                 (_merged(k), _merged(v)), lse)
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v)
    scratch = _bwd_scratch(b, h, lq, qs.device)
    arr, n = _ends_arg(ends)
    rc = build.lib().var_flash_bwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, lq,
        k.shape[1], h, HEAD_DIM, arr, n, build.dtype_code(qs.dtype), qs.device.index,
        build.stream_of(qs))
    build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Row 5 with its VJP (``flash_attention.py:354-372``): the forward saves
    q, k, v, out and the lse; the backward recomputes p from the lse."""

    @staticmethod
    def forward(ctx, qs, k, v, ends):
        out, lse = flash_attention_fwd(qs, k, v, ends)
        ctx.save_for_backward(qs, k, v, out, lse)
        ctx.ends = ends
        return out

    @staticmethod
    def backward(ctx, do):
        qs, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(qs, k, v, out, lse, do.contiguous(), ctx.ends)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float = 1.0,
                    scale_ends: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Flash attention over BLHD tensors with VAR's block-causal scale mask
    (``flash_attention.py:375-419``), differentiable. q: (B, Lq, H, D); k, v:
    (B, Lk, H, D). ``scale_ends``: the cumulative per-scale token counts
    (attend where key level <= query level), or None: unmasked, and Lq may
    differ from Lk. Fewer than 8 queries or keys take the dense branch, as
    in the JAX package (progressive training at ``prog_si`` 0 and 1); else
    ``scale`` is folded into q and rounded to q's dtype before the kernel,
    inside autograd, so dq flows through the scale. Output in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash_attention: want q (B, Lq, H, D) and k, v (B, Lk, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    ends = tuple(int(e) for e in scale_ends) if scale_ends is not None else None
    _check_ends(ends)
    if q.shape[1] < 8 or k.shape[1] < 8:
        probs = dense_probs(q, k, scale, ends).to(v.dtype)
        return torch.einsum("bhlm,bmhd->blhd", probs, v)
    qs = (q.float() * scale).to(q.dtype)
    return _FlashAttention.apply(qs.contiguous(), k.contiguous(), v.contiguous(), ends)
