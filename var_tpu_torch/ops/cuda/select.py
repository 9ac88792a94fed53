"""Kernel 2: sort-free exact top-k / top-p bound (``csrc/select.cu``).

Replaces ``var_tpu/ops/pallas/select.py::topk_topp_bound`` and carries its
``float_key``. Per row of fp32 logits the bound is one int32 key; position
v is a candidate iff ``float_key(l_v) >= bound``. Top-k finds the exact
k-th largest key by a 32-step MSB descent (ties at the k-th value kept);
top-p runs the same descent, strict, over the candidates' softmax mass;
``bound = max(tk, tq + 1)``. No sort anywhere.
"""

from __future__ import annotations

import torch

from var_tpu_torch.ops.cuda import build

INT32_MIN = -(2 ** 31)
# 8 bytes of dynamic shared memory per logit, next to the kernel's 264 static
# bytes (two 33-word reduction arrays), within the 232,448-byte opt-in limit
_SEL_MAX_V = (232_448 - 2 * 33 * 4) // 8


def float_key(l: torch.Tensor) -> torch.Tensor:
    """Monotone int32 key of finite fp32 values (sign-magnitude flip), with
    -0.0 canonicalised to +0.0 first."""
    lf = l.float()
    lf = torch.where(lf == 0.0, torch.zeros_like(lf), lf)
    i = lf.view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def _descend(key: torch.Tensor, weights: torch.Tensor, target, strict: bool) -> torch.Tensor:
    """Largest threshold T (unsigned key order) with
    sum(weights * (key >= T + strict)) >= target, per row."""
    t = torch.full(key.shape[:-1] + (1,), INT32_MIN, dtype=torch.int32, device=key.device)
    for b in range(31, -1, -1):
        cand = t ^ INT32_MIN if b == 31 else t | (1 << b)
        ok = key > cand if strict else key >= cand
        stat = (weights * ok.to(weights.dtype)).sum(-1, keepdim=True)
        t = torch.where(stat >= target, cand, t)
    return t


def topk_topp_bound_plain(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Plain PyTorch version; the CPU path and the kernel's oracle."""
    *lead, v = logits.shape
    l = logits.reshape(-1, v).float()
    k = top_k if top_k > 0 else v
    key = float_key(l)
    tk = _descend(key, torch.ones_like(l), float(k), strict=False)
    if top_p > 0.0:
        e = torch.exp(l - l.amax(-1, keepdim=True)) * (key >= tk).float()
        pm = e.sum(-1, keepdim=True) * float(torch.tensor(top_p, dtype=torch.float32))
        tq = _descend(key, e, pm, strict=True)
        bound = torch.maximum(tk, tq + 1)
    else:
        bound = tk
    return bound[:, 0].reshape(lead)


def bound_mass_gap(logits: torch.Tensor, tk: torch.Tensor, got: torch.Tensor,
                   want: torch.Tensor, top_p: float):
    """How far apart two top-p bounds of the same logits are, for holding
    one implementation against another: the largest |mass(key >= hi) -
    top_p * M| / M in float64 over the rows whose bounds differ (``hi`` the
    higher of the two bounds, M the mass of the top-k candidates, key >=
    ``tk``), and the number of such rows. Two correct implementations sum the
    fp32 masses in different orders, so they may disagree only where that
    gap is at the level of fp32 rounding. (0.0, 0) when every bound agrees."""
    rows = (got != want).reshape(-1).nonzero().reshape(-1)
    if rows.numel() == 0:
        return 0.0, 0
    l = logits.reshape(-1, logits.shape[-1])[rows].double()
    key = float_key(l.float())
    hi = torch.maximum(got.reshape(-1)[rows], want.reshape(-1)[rows])[:, None]
    e = torch.exp(l - l.amax(-1, keepdim=True))
    m = (e * (key >= tk.reshape(-1)[rows][:, None])).sum(-1)
    above = (e * (key >= hi)).sum(-1)
    return float(((above - top_p * m).abs() / m).max()), int(rows.numel())


def topk_topp_bound(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """(..., V) fp32 logits -> (...,) int32 key bound per row. ``top_k <= 0``
    means no top-k (k = V); ``top_p <= 0`` disables the mass threshold."""
    if logits.device.type == "cpu":
        return topk_topp_bound_plain(logits, top_k, top_p)
    build.require_cuda("topk_topp_bound", logits)
    *lead, v = logits.shape
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise ValueError("topk_topp_bound: logits must be contiguous float32")
    if not 1 <= v <= _SEL_MAX_V:
        raise ValueError(f"topk_topp_bound: V={v} outside [1, {_SEL_MAX_V}]")
    rows = logits.numel() // v
    bound = torch.empty(rows, dtype=torch.int32, device=logits.device)
    k = top_k if top_k > 0 else v
    rc = build.lib().var_topk_topp_bound(
        logits.data_ptr(), bound.data_ptr(), rows, v, int(k), float(top_p),
        logits.device.index, build.stream_of(logits))
    build.check(rc, "topk_topp_bound")
    topk_topp_bound.launches += 1
    return bound.reshape(lead)


topk_topp_bound.launches = 0
