"""Attention and rematerialisation (counterpart of ``var_tpu/ops/attention.py``).

Two dense forms, for two purposes:

* :func:`attention` is the JAX package's ``attention``: ``impl="pallas"``
  goes to the streaming flash-attention kernel (row 5 of PERF.md's kernel
  table, ``ops/cuda/flash_attention.py::flash_attention``); every other impl
  takes the dense path, whose probabilities are JAX's ``_dense_probs``: the
  q k^T product in the input dtype (bf16 inputs round the logits to bf16),
  then float32 scale and softmax, the probabilities cast to the value dtype
  before the PV product.
* :func:`attention_fp32_logits` is the plain version the attention kernels
  are held against: the logits from float32 copies of q and k
  (:func:`block_causal_logits`), as the kernels' and the TPU kernels'
  ``preferred_element_type=F32`` dots make them, so bf16 inputs do not round
  the logits.

Both take BLHD tensors and, with ``scale_ends``, VAR's block-causal mask in
factored form. :func:`recompute_grad` is the one rematerialisation helper of
the training forward (remat 1 and 2, and the hybrid impl's dense backward).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

IMPLS = ("xla", "pallas", "hybrid", "paired")


def _flatten(args):
    """(tensors, spec) of ``args``: every tensor of an argument (inside
    tuples and lists too) and every parameter of an ``nn.Module`` argument,
    and the arguments with each tensor replaced by its index."""
    flat = []

    def walk(a):
        if isinstance(a, torch.Tensor):
            flat.append(a)
            return ("t", len(flat) - 1)
        if isinstance(a, (tuple, list)):
            return ("seq", type(a), [walk(x) for x in a])
        if isinstance(a, nn.Module):
            flat.extend(a.parameters())
        return ("obj", a)

    return flat, [walk(a) for a in args]


def _unflatten(spec, flat):
    def build(s):
        if s[0] == "t":
            return flat[s[1]]
        if s[0] == "seq":
            return s[1](build(x) for x in s[2])
        return s[1]

    return [build(s) for s in spec]


class _Recompute(torch.autograd.Function):
    """Forward runs ``fn`` keeping nothing but its inputs; backward runs
    ``bwd_fn`` (default ``fn``) again under autograd and returns the
    gradients of its inputs, module parameters included."""

    @staticmethod
    def forward(ctx, fn, bwd_fn, spec, *flat):
        ctx.bwd_fn, ctx.spec = bwd_fn, spec
        ctx.save_for_backward(*flat)
        return fn(*_unflatten(spec, flat))

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        # non-leaf inputs are detached so the recomputation's graph ends here;
        # leaves (module parameters) reach autograd.grad as they are
        inputs = [t if t.is_leaf else t.detach().requires_grad_(t.requires_grad) for t in saved]
        wants = [i for i, t in enumerate(inputs) if t.requires_grad]
        with torch.enable_grad():
            out = ctx.bwd_fn(*_unflatten(ctx.spec, inputs))
        grads = torch.autograd.grad(out, [inputs[i] for i in wants], grad, allow_unused=True)
        full = [None] * len(inputs)
        for i, g in zip(wants, grads):
            full[i] = g
        return (None, None, None, *full)


def recompute_grad(fn, bwd_fn=None):
    """``fn`` whose intermediates are recomputed in backward instead of
    saved (``var_tpu/ops/attention.py:24-49``, checkpoint by custom VJP
    there): only its inputs are kept. ``fn`` returns one tensor; it reaches
    trainable parameters only through its arguments (tensors, tuples of
    tensors, ``nn.Module``s). ``bwd_fn``: a numerically equivalent function
    whose backward is taken instead of ``fn``'s -- the hybrid impl pairs the
    flash-attention forward with the dense backward."""

    def wrapped(*args):
        flat, spec = _flatten(args)
        return _Recompute.apply(fn, bwd_fn or fn, spec, *flat)

    return wrapped


def levels_mask(lq: int, lk: int, scale_ends, device) -> torch.Tensor:
    """(Lq, Lk) bool block-causal validity from the factored scale ends."""
    def _levels(n):
        pos = torch.arange(n, device=device)
        lvl = torch.zeros(n, dtype=torch.int32, device=device)
        for e in scale_ends:
            lvl = lvl + (pos >= e).to(torch.int32)
        return lvl

    return _levels(lk)[None, :] <= _levels(lq)[:, None]


def _mask(logits: torch.Tensor, scale_ends) -> torch.Tensor:
    if scale_ends is None:
        return logits
    mask = levels_mask(logits.shape[-2], logits.shape[-1], scale_ends, logits.device)
    return logits.masked_fill(~mask[None, None], float("-inf"))


def block_causal_logits(q: torch.Tensor, k: torch.Tensor, scale: float,
                        scale_ends: Optional[tuple] = None) -> torch.Tensor:
    """(B, H, Lq, Lk) float32 logits from float32 copies of q and k, times
    ``scale``, -inf where the block-causal mask of ``scale_ends`` hides the
    key: the kernels' logits. q: (B, Lq, H, D); k: (B, Lk, H, D)."""
    return _mask(torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale, scale_ends)


def attention_fp32_logits(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                          scale_ends: Optional[tuple] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with float32 logits and softmax, the
    probabilities cast to v's dtype: the plain version of the attention
    kernels. q: (B, Lq, H, D); k, v: (B, Lk, H, D). Output in q's dtype."""
    if scale_ends is not None and q.shape[1] != k.shape[1]:
        raise ValueError("scale_ends requires full-sequence q (no KV cache offset)")
    probs = torch.softmax(block_causal_logits(q, k, scale, scale_ends), dim=-1).to(v.dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs, v).to(q.dtype)


def dense_probs(q: torch.Tensor, k: torch.Tensor, scale: float,
                scale_ends: Optional[tuple] = None) -> torch.Tensor:
    """JAX's ``_dense_probs`` (``var_tpu/ops/attention.py:64-69``): the
    q k^T product in the input dtype, then float32, times ``scale``, masked,
    softmax in float32. (B, H, Lq, Lk) float32."""
    logits = torch.einsum("blhd,bmhd->bhlm", q, k).float() * scale
    return torch.softmax(_mask(logits, scale_ends), dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              scale_ends: Optional[tuple] = None, impl: str = "xla") -> torch.Tensor:
    """softmax(q k^T * scale) v (``var_tpu/ops/attention.py:72-119``). q:
    (B, Lq, H, D); k, v: (B, Lk, H, D). ``scale_ends`` gives the block-causal
    mask in factored form (full-length q only). ``impl="pallas"`` runs the
    streaming flash-attention kernel; any other impl the dense path. Output
    in v's dtype."""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}: want one of {IMPLS}")
    if scale_ends is not None and q.shape[1] != k.shape[1]:
        raise ValueError("scale_ends requires full-sequence q (no KV cache offset)")
    if impl == "pallas":
        from var_tpu_torch.ops.cuda.flash_attention import flash_attention

        return flash_attention(q, k, v, scale, scale_ends)
    probs = dense_probs(q, k, scale, scale_ends).to(v.dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)
