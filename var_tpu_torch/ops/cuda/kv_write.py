"""One decode stage's K and V into the KV cache, with the per-head L2 norm
of K (``csrc/kv_write.cu``): ``models/var.py::attn_apply`` between the fused
qkv GEMM and the cached attention.

Replaces no JAX kernel (the JAX package leaves the norm and the cache write
to XLA, which fuses them) and has no row in the kernel table. In PyTorch the
norm and the two strided cache writes were seven launches and ~28 bytes of
traffic an element of K; the kernel reads K and V once from the GEMM's
output and writes them once into the cache. Float32 sum of squares, float32
``rsqrt(sum + 1e-24)`` and product, one rounding to the cache's dtype: the
plain version's arithmetic, the 64-term sum in another order.
"""

from __future__ import annotations

import torch

from var_tpu_torch.ops.cuda import build

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # common.cuh's dtype codes
_MAX_PER = 4  # most 16-byte vectors of one head a lane holds (kMaxPer in the .cu file)


def kv_write_plain(k: torch.Tensor, v: torch.Tensor, k_dst: torch.Tensor, v_dst: torch.Tensor,
                   heads: int, l2_norm: bool) -> None:
    """Plain PyTorch version; the CPU path and the kernel's oracle. Writes
    ``k`` (per-head L2-normed in float32 when ``l2_norm``, rounded once) into
    ``k_dst`` and ``v`` into ``v_dst``, all (B, l, C) with C = heads * D."""
    if l2_norm:
        b, l, c = k.shape
        kf = k.float().reshape(b, l, heads, c // heads)
        inv = torch.rsqrt((kf * kf).sum(-1, keepdim=True) + 1e-24)
        torch.mul(kf, inv, out=k_dst.view(b, l, heads, c // heads))  # rounds to the cache dtype
    else:
        k_dst.copy_(k)
    v_dst.copy_(v)


def _check_shapes(k, v, k_dst, v_dst, heads: int) -> None:
    if k.dim() != 3 or any(t.shape != k.shape for t in (v, k_dst, v_dst)):
        raise ValueError("kv_write: k, v, k_dst and v_dst must be (B, l, C) of one shape, got "
                         f"{[tuple(t.shape) for t in (k, v, k_dst, v_dst)]}")
    if heads < 1 or k.shape[2] % heads:
        raise ValueError(f"kv_write: {k.shape[2]} channels do not split into {heads} heads")
    if any(t.dtype != k.dtype for t in (v, k_dst, v_dst)):
        raise ValueError("kv_write: k, v, k_dst and v_dst must share a dtype, got "
                         f"{[t.dtype for t in (k, v, k_dst, v_dst)]}")


def launch_shape(k: torch.Tensor, v: torch.Tensor, k_dst: torch.Tensor, v_dst: torch.Tensor,
                 heads: int) -> dict:
    """The kernel's launch arguments for these tensors, or a raise on what it
    does not take: a dtype outside float32, bfloat16 and float16, a head
    size that is no whole number of 16-byte vectors or more than
    ``_MAX_PER * 32`` of them, channels not contiguous, sources (or
    destinations) with other strides than each other, a stride or address
    that breaks 16-byte alignment. ``lg_lanes``: log2 of the lanes a head
    takes, the largest power of two not above its vectors, at most 32."""
    _check_shapes(k, v, k_dst, v_dst, heads)
    if k.dtype not in _CODES:
        raise TypeError(f"kv_write takes float32, bfloat16 or float16, got {k.dtype}")
    vec = 16 // k.element_size()
    b, l, c = k.shape
    d = c // heads
    if d % vec or d // vec > _MAX_PER * 32:
        raise ValueError(f"kv_write: heads of {d} {k.dtype} are not 1 to {_MAX_PER * 32} "
                         "16-byte vectors")
    if v.stride() != k.stride() or v_dst.stride() != k_dst.stride():
        raise ValueError(f"kv_write: k and v strides {k.stride()}, {v.stride()}, k_dst and "
                         f"v_dst strides {k_dst.stride()}, {v_dst.stride()} must agree")
    for name, t in (("k", k), ("v", v), ("k_dst", k_dst), ("v_dst", v_dst)):
        if t.stride(2) != 1 or t.stride(0) % vec or t.stride(1) % vec or t.data_ptr() % 16:
            raise ValueError(f"kv_write: {name} strides {t.stride()} at address "
                             f"{t.data_ptr()} break its 16-byte vectors")
    return {"rows": b * l, "l": l, "d": d,
            "lg_lanes": min(32, d // vec).bit_length() - 1,
            "src": (k.stride(0), k.stride(1)), "dst": (k_dst.stride(0), k_dst.stride(1))}


def kv_write(k: torch.Tensor, v: torch.Tensor, k_dst: torch.Tensor, v_dst: torch.Tensor,
             heads: int, l2_norm: bool) -> None:
    """Write ``k`` (per-head L2-normed when ``l2_norm``) and ``v`` into
    ``k_dst`` and ``v_dst``: (B, l, C) views, the sources the K and V column
    blocks of the fused qkv output, the destinations the stage's rows of a
    layer's cache buffers. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel once, or raises on what it does not take
    (:func:`launch_shape`)."""
    if k.device.type == "cpu":
        _check_shapes(k, v, k_dst, v_dst, heads)
        kv_write_plain(k, v, k_dst, v_dst, heads, l2_norm)
        return
    build.require_cuda("kv_write", k, v, k_dst, v_dst)
    a = launch_shape(k, v, k_dst, v_dst, heads)
    rc = build.lib().var_kv_write(
        k.data_ptr(), v.data_ptr(), k_dst.data_ptr(), v_dst.data_ptr(), a["rows"], a["l"],
        heads, a["d"], a["lg_lanes"], int(l2_norm), *a["src"], *a["dst"], _CODES[k.dtype],
        k.device.index, build.stream_of(k))
    build.check(rc, "kv_write")
    kv_write.launches += 1


kv_write.launches = 0
