"""Dense attention and rematerialisation (counterpart of ``var_tpu/ops/attention.py``).

``attention`` is the plain PyTorch version of the attention kernels in
``ops/cuda/flash_attention.py``: softmax(q k^T * scale) v over BLHD tensors,
logits and softmax in float32, the PV product in the value dtype. The
logits are computed from float32 copies of q and k, as the TPU kernel's
``preferred_element_type=F32`` dot does, so bf16 inputs do not round the
logits. With ``scale_ends`` it is the block-causal teacher-forced attention
that the training kernel is held against. ``recompute_grad`` is the
activation checkpoint of the training forward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint


def recompute_grad(fn):
    """``fn`` whose intermediates are recomputed in backward instead of
    saved (``var_tpu/ops/attention.py:24``, checkpoint-by-custom-VJP there):
    only its tensor arguments are kept."""

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)

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


def block_causal_logits(q: torch.Tensor, k: torch.Tensor, scale: float,
                        scale_ends: Optional[tuple] = None) -> torch.Tensor:
    """(B, H, Lq, Lk) float32 logits q k^T * scale, -inf where the
    block-causal mask of ``scale_ends`` hides the key. q: (B, Lq, H, D);
    k: (B, Lk, H, D)."""
    logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    if scale_ends is not None:
        mask = levels_mask(q.shape[1], k.shape[1], scale_ends, q.device)
        logits = logits.masked_fill(~mask[None, None], float("-inf"))
    return logits


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              scale_ends: Optional[tuple] = None) -> torch.Tensor:
    """softmax(q @ k^T * scale) @ v. q: (B, Lq, H, D); k, v: (B, Lk, H, D).
    ``scale_ends`` gives the block-causal mask in factored form (full-length
    q only). Output in ``q.dtype``."""
    if scale_ends is not None and q.shape[1] != k.shape[1]:
        raise ValueError("scale_ends requires full-sequence q (no KV cache offset)")
    probs = torch.softmax(block_causal_logits(q, k, scale, scale_ends), dim=-1).to(v.dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs, v).to(q.dtype)
