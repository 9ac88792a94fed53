"""Dense attention (counterpart of ``var_tpu/ops/attention.py``).

``attention`` is the plain PyTorch version of the decode-attention kernel in
``ops/cuda/flash_attention.py``: softmax(q k^T * scale) v over BLHD tensors,
logits and softmax in float32, the PV product in the value dtype. The
logits are computed from float32 copies of q and k, as the TPU kernel's
``preferred_element_type=F32`` dot does, so bf16 inputs do not round the
logits. ``recompute_grad`` waits for the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch


def _levels_mask(lq: int, lk: int, scale_ends, device) -> torch.Tensor:
    """(Lq, Lk) bool block-causal validity from the factored scale ends."""
    def _levels(n):
        pos = torch.arange(n, device=device)
        lvl = torch.zeros(n, dtype=torch.int32, device=device)
        for e in scale_ends:
            lvl = lvl + (pos >= e).to(torch.int32)
        return lvl

    return _levels(lk)[None, :] <= _levels(lq)[:, None]


def _dense_probs(q, k, scale, scale_ends=None) -> torch.Tensor:
    logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    if scale_ends is not None:
        mask = _levels_mask(q.shape[1], k.shape[1], scale_ends, q.device)
        logits = logits.masked_fill(~mask[None, None], float("-inf"))
    return torch.softmax(logits, dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              scale_ends: Optional[tuple] = None) -> torch.Tensor:
    """softmax(q @ k^T * scale) @ v. q: (B, Lq, H, D); k, v: (B, Lk, H, D).
    ``scale_ends`` gives the block-causal mask in factored form (full-length
    q only). Output in ``q.dtype``."""
    if scale_ends is not None and q.shape[1] != k.shape[1]:
        raise ValueError("scale_ends requires full-sequence q (no KV cache offset)")
    probs = _dense_probs(q, k, scale, scale_ends).to(v.dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs, v).to(q.dtype)
