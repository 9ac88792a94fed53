"""Token sampling: top-k / top-p filtering and gumbel-softmax (counterpart of
``var_tpu/ops/sampling.py``).

``top_k_top_p_mask`` reproduces the reference's sorted-space filtering
(``models/helpers.py:6-36``) and is the exact oracle. The sampler itself is
sort-free: the bound kernel (``ops/cuda/select.py``) gives each row's
candidate key bound, and a Gumbel-max draw over the masked logits samples
from the same distribution as ``torch.multinomial(softmax(...))``. Random
numbers come from an explicit ``torch.Generator``; they differ from JAX's
streams, so sampled decodes are compared by candidate set, never token by
token.
"""

from __future__ import annotations

from typing import Optional

import torch

from var_tpu_torch.ops.cuda.select import float_key, topk_topp_bound

__all__ = ["top_k_top_p_mask", "sample_with_top_k_top_p", "gumbel_softmax"]

_NEG_INF = float("-inf")


def top_k_top_p_mask(logits: torch.Tensor, top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """Apply top-k then top-p filtering; removed entries become -inf. Ties at
    the k-th value are kept; the argmax is never removed by top-p."""
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, _NEG_INF)
    if top_p > 0.0:
        sorted_logits, sorted_idx = torch.sort(logits, dim=-1)  # ascending
        cumprobs = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        remove_sorted = cumprobs <= (1.0 - top_p)
        remove_sorted[..., -1] = False
        remove = remove_sorted.scatter(-1, sorted_idx, remove_sorted)
        logits = logits.masked_fill(remove, _NEG_INF)
    return logits


def _gumbel(shape, device, generator: Optional[torch.Generator]) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)  # u = 0 would give -inf
    return -torch.log(-torch.log(u))


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Gumbel-max draw over the last axis -> int64 indices."""
    return (logits + _gumbel(logits.shape, logits.device, generator)).argmax(-1)


def sample_with_top_k_top_p(logits: torch.Tensor, top_k: int = 0, top_p: float = 0.0,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample one token per position from the filtered logits (..., V).
    Returns int64 (...)."""
    v = logits.shape[-1]
    lf = logits.float()
    # k >= V selects everything; clamp so small-vocab configs keep top_k=900
    k = min(top_k, v) if top_k > 0 else v
    if top_k <= 0 and top_p <= 0.0:
        return _categorical(lf, generator)
    lf = lf.contiguous()
    bound = topk_topp_bound(lf, k, top_p)
    masked = lf.masked_fill(float_key(lf) < bound[..., None], _NEG_INF)
    return _categorical(masked, generator)


def gumbel_softmax(logits: torch.Tensor, tau: float = 1.0, hard: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Gumbel-softmax relaxation (reference ``helpers.py:22-36``), used by the
    ``more_smooth`` decode path to mix codebook rows by a soft distribution."""
    g = _gumbel(logits.shape, logits.device, generator)
    y_soft = torch.softmax((logits.float() + g) / tau, dim=-1)
    if hard:
        idx = y_soft.argmax(-1, keepdim=True)
        y_hard = torch.zeros_like(y_soft).scatter_(-1, idx, 1.0)
        return y_hard + y_soft - y_soft.detach()
    return y_soft
