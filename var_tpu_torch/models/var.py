"""VAR transformer, inference side (counterpart of ``var_tpu/models/var.py``).

``VAR`` holds the parameters under the reference state-dict names
(``models/var.py:55-116``, ``models/basic_var.py``), so a reference ``.pth``
loads with ``load_state_dict`` once the derived buffers are dropped. The
functions mirror the JAX package's: the AdaLN block (``block_apply``) with
the fused modulated LayerNorm kernel, fused QKV with a zero k bias and the
optional per-head QK L2 norm, decode attention over the KV cache through
the attention kernel, the GELU-tanh FFN, and the CFG-mixed fp32 head.

KV cache: one preallocated (depth, 2B, L, C) K buffer and one V buffer,
written in place each stage (:class:`KVCache`); layer ``i`` attends over
rows ``[0, cum + l)`` by pointer and stride. The JAX package keeps
per-stage chunks only because its arrays are immutable. Teacher-forced
``var_forward`` waits for the training slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from var_tpu_torch.config import VARConfig
from var_tpu_torch.device import fp32_exact
from var_tpu_torch.ops.cuda.flash_attention import flash_decode
from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm


def level_ids(cfg: VARConfig) -> np.ndarray:
    """(L,) int: which pyramid scale each flat position belongs to."""
    return np.concatenate([np.full(pn * pn, i, np.int64) for i, pn in enumerate(cfg.patch_nums)])


# ---------------------------------------------------------------------------
# modules (reference names)


class SelfAttention(nn.Module):
    def __init__(self, cfg: VARConfig):
        super().__init__()
        c, h = cfg.embed_dim, cfg.num_heads
        self.mat_qkv = nn.Linear(c, 3 * c, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(c))
        self.v_bias = nn.Parameter(torch.zeros(c))
        if cfg.attn_l2_norm:
            self.scale_mul_1H11 = nn.Parameter(torch.full((1, h, 1, 1), math.log(4.0)))
        self.proj = nn.Linear(c, c)


class FFN(nn.Module):
    def __init__(self, cfg: VARConfig):
        super().__init__()
        hidden = round(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = nn.Linear(cfg.embed_dim, hidden)
        self.fc2 = nn.Linear(hidden, cfg.embed_dim)


class AdaLNSelfAttn(nn.Module):
    def __init__(self, cfg: VARConfig):
        super().__init__()
        c = cfg.embed_dim
        self.attn = SelfAttention(cfg)
        self.ffn = FFN(cfg)
        if cfg.shared_aln:
            self.ada_gss = nn.Parameter(torch.zeros(1, 1, 6, c))
        else:
            self.ada_lin = nn.Sequential(nn.SiLU(), nn.Linear(c, 6 * c))


class AdaLNBeforeHead(nn.Module):
    def __init__(self, cfg: VARConfig):
        super().__init__()
        self.ada_lin = nn.Sequential(nn.SiLU(), nn.Linear(cfg.embed_dim, 2 * cfg.embed_dim))


class VAR(nn.Module):
    def __init__(self, cfg: VARConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.embed_dim
        self.word_embed = nn.Linear(cfg.z_channels, c)
        self.class_emb = nn.Embedding(cfg.num_classes + 1, c)
        self.pos_start = nn.Parameter(torch.zeros(1, cfg.first_l, c))
        self.pos_1LC = nn.Parameter(torch.zeros(1, cfg.seq_len, c))
        self.lvl_embed = nn.Embedding(len(cfg.patch_nums), c)
        if cfg.shared_aln:
            self.shared_ada_lin = nn.Sequential(nn.SiLU(), nn.Linear(c, 6 * c))
        self.blocks = nn.ModuleList([AdaLNSelfAttn(cfg) for _ in range(cfg.depth)])
        self.head_nm = AdaLNBeforeHead(cfg)
        self.head = nn.Linear(c, cfg.vocab_size)


@torch.no_grad()
def init_var_params(var: VAR, generator: torch.Generator, init_std: float = -1.0,
                    init_head: float = 0.02, init_adaln: float = 0.5,
                    init_adaln_gamma: float = 1e-5) -> VAR:
    """Seeded random init in place, with the rules of ``VAR.init_weights``
    (``models/var.py:577-627``): std = sqrt(1/C/3) unless ``init_std``;
    head *= init_head; AdaLN scale/shift *= init_adaln, gammas *=
    init_adaln_gamma; residual projections /= sqrt(2 * depth). Does not
    reproduce JAX's random stream."""
    cfg = var.cfg
    c = cfg.embed_dim
    std = math.sqrt(1.0 / c / 3.0) if init_std < 0 else init_std
    resi_div = math.sqrt(2.0 * cfg.depth)

    def tn(t: torch.Tensor, s: float) -> torch.Tensor:
        if s <= 0:
            return t.zero_()
        return nn.init.trunc_normal_(t, 0.0, s, -2.0, 2.0, generator=generator)

    def linear(lin: nn.Linear, s: float) -> None:
        tn(lin.weight, s)
        if lin.bias is not None:
            lin.bias.zero_()

    linear(var.word_embed, std)
    for t in (var.class_emb.weight, var.pos_start, var.pos_1LC, var.lvl_embed.weight):
        tn(t, std)
    linear(var.head_nm.ada_lin[1], std)
    var.head_nm.ada_lin[1].weight.mul_(init_adaln)
    linear(var.head, std)
    var.head.weight.mul_(init_head)
    if cfg.shared_aln:
        linear(var.shared_ada_lin[1], std)
    for blk in var.blocks:
        linear(blk.attn.mat_qkv, std)
        blk.attn.q_bias.zero_()
        blk.attn.v_bias.zero_()
        linear(blk.attn.proj, std)
        blk.attn.proj.weight.div_(resi_div)
        linear(blk.ffn.fc1, std)
        linear(blk.ffn.fc2, std)
        blk.ffn.fc2.weight.div_(resi_div)
        if cfg.attn_l2_norm:
            blk.attn.scale_mul_1H11.fill_(math.log(4.0))
        if cfg.shared_aln:
            gss = blk.ada_gss
            gss.normal_(0.0, 1.0, generator=generator).div_(math.sqrt(c))
            gss[:, :, :2].mul_(init_adaln_gamma)
            gss[:, :, 2:].mul_(init_adaln)
        else:
            lin = blk.ada_lin[1]
            linear(lin, std)
            lin.weight[: 2 * c].mul_(init_adaln_gamma)
            lin.weight[2 * c:].mul_(init_adaln)
    return var


@torch.no_grad()
def cast_block_matmul_params(var: VAR, dtype: torch.dtype) -> VAR:
    """Store the blocks' matmul weights and biases in the compute dtype, in
    place (``build_vae_var`` does this for its ``dtype``). Bit-identical
    decode: ``_linear`` casts them to the activation dtype at every use
    anyway. Everything consumed in float32 stays float32 (AdaLN, scale_mul,
    embeddings, head)."""
    for blk in var.blocks:
        blk.attn.mat_qkv.to(dtype)
        blk.attn.proj.to(dtype)
        blk.ffn.to(dtype)
        blk.attn.q_bias.data = blk.attn.q_bias.data.to(dtype)
        blk.attn.v_bias.data = blk.attn.v_bias.data.to(dtype)
    return var


# ---------------------------------------------------------------------------
# KV cache


@dataclass
class KVCache:
    """Preallocated decode cache: K, V of shape (depth, B, Lmax, C); rows
    ``[0, cum)`` hold every finished stage."""

    k: torch.Tensor
    v: torch.Tensor
    cum: int = 0


def init_prealloc_caches(cfg: VARConfig, batch: int, dtype: torch.dtype, device) -> KVCache:
    shape = (cfg.depth, batch, cfg.seq_len, cfg.embed_dim)
    return KVCache(torch.empty(shape, dtype=dtype, device=device),
                   torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# building blocks


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without affine params: float32 statistics, normalisation in
    the input dtype (``basic_var.py:141``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var + eps)
    dt = x.dtype
    return (x - mu.to(dt)) * inv.to(dt)


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


class BlockContext(NamedTuple):
    """What block ``i`` of a decode needs that never changes across its
    stages, computed once per decode (the JAX package hoists the AdaLN
    projection the same way, ``cond_context(decode=True)``)."""

    p6: torch.Tensor  # (B, 6, C) float32: gamma1, gamma2, scale1, scale2, shift1, shift2
    gammas: torch.Tensor  # (2, B, 1, C): gamma1, gamma2 in the compute dtype
    qkv_bias: torch.Tensor  # (3C,): [q_bias, 0, v_bias] in the compute dtype (zero k bias)
    scale_mul: Optional[torch.Tensor]  # (H,) float32 exp(min(scale_mul, ln 100)), or None


def _adaln6(blk: AdaLNSelfAttn, cfg: VARConfig, h: torch.Tensor,
            shared: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, 6, C) float32 AdaLN parameters of one block: with shared AdaLN,
    its ``ada_gss`` plus ``shared``, the (B, 6, C) ``shared_ada_lin`` output;
    else its own ``ada_lin`` of ``h`` = silu(class embedding)."""
    if cfg.shared_aln:
        return blk.ada_gss.float().reshape(1, 6, cfg.embed_dim) + shared
    return _linear(blk.ada_lin[1], h).reshape(-1, 6, cfg.embed_dim)


def cond_context(var: VAR, cond_bd: torch.Tensor, dtype: torch.dtype) -> List[BlockContext]:
    """Each block's :class:`BlockContext` for the (B, C) class embeddings
    ``cond_bd`` and the compute dtype."""
    cfg = var.cfg
    h = F.silu(cond_bd.float())
    shared = None
    if cfg.shared_aln:
        shared = _linear(var.shared_ada_lin[1], h).reshape(-1, 6, cfg.embed_dim)
    out = []
    for blk in var.blocks:
        p6 = _adaln6(blk, cfg, h, shared)
        attn = blk.attn
        sm = None
        if cfg.attn_l2_norm:
            sm = torch.exp(attn.scale_mul_1H11.float().clamp(max=math.log(100.0)))
            sm = sm.reshape(cfg.num_heads)
        bias = torch.cat([attn.q_bias, torch.zeros_like(attn.q_bias), attn.v_bias])
        out.append(BlockContext(p6, p6[:, :2].transpose(0, 1)[:, :, None].to(dtype),
                                bias.to(dtype), sm))
    return out


def lvl_pos_embed(var: VAR) -> torch.Tensor:
    """(1, L, C) = scale embedding + absolute positions (``var.py:153``)."""
    lvl = torch.as_tensor(level_ids(var.cfg), device=var.pos_1LC.device)
    return var.lvl_embed.weight[lvl][None] + var.pos_1LC


def attn_apply(attn: SelfAttention, cfg: VARConfig, x: torch.Tensor, ctx: BlockContext,
               cache: KVCache, layer: int) -> torch.Tensor:
    """Fused QKV with a zero k bias, per-head k L2 norm at cache-write time,
    then attention of this stage's queries over cache rows [0, cum + l)
    (``basic_var.py:90-119``)."""
    b, l, c = x.shape
    h, d = cfg.num_heads, cfg.head_dim
    dtype = x.dtype
    qkv = F.linear(x, attn.mat_qkv.weight.to(dtype), ctx.qkv_bias)  # (B, l, 3C)
    k, v = qkv[..., c:2 * c], qkv[..., 2 * c:]
    cum = cache.cum
    k_dst = cache.k[layer, :, cum:cum + l]
    if cfg.attn_l2_norm:
        scale = 1.0
        kf = k.float().reshape(b, l, h, d)
        inv = torch.rsqrt((kf * kf).sum(-1, keepdim=True) + 1e-24)
        torch.mul(kf, inv, out=k_dst.view(b, l, h, d))  # rounds to the cache dtype
    else:
        scale = 0.25 / math.sqrt(d)
        k_dst.copy_(k)
    cache.v[layer, :, cum:cum + l] = v
    out = flash_decode(qkv, cache.k[layer], cache.v[layer], cum + l, h, scale,
                       q_l2_scale_mul=ctx.scale_mul)
    return _linear(attn.proj, out)


def ffn_apply(ffn: FFN, x: torch.Tensor) -> torch.Tensor:
    """Linear-GELU(tanh)-Linear (``basic_var.py:33-52``)."""
    return _linear(ffn.fc2, F.gelu(_linear(ffn.fc1, x), approximate="tanh"))


def block_apply(blk: AdaLNSelfAttn, cfg: VARConfig, x: torch.Tensor, ctx: BlockContext,
                cache: KVCache, layer: int) -> torch.Tensor:
    """Pre-norm AdaLN block (``basic_var.py:152-158``):
    x += attn(ln(x)*(s1+1)+sh1) * g1; x += ffn(ln(x)*(s2+1)+sh2) * g2,
    each LN + modulation one launch of the fused kernel."""
    p6 = ctx.p6
    a_in = modulated_layernorm(x, p6[:, 2], p6[:, 4], eps=cfg.norm_eps)
    x = x + attn_apply(blk.attn, cfg, a_in, ctx, cache, layer) * ctx.gammas[0]
    f_in = modulated_layernorm(x, p6[:, 3], p6[:, 5], eps=cfg.norm_eps)
    return x + ffn_apply(blk.ffn, f_in) * ctx.gammas[1]


def _head_nm(var: VAR, h: torch.Tensor, cond_bd: torch.Tensor) -> torch.Tensor:
    ada = _linear(var.head_nm.ada_lin[1], F.silu(cond_bd.float()))
    ada = ada.reshape(-1, 1, 2, var.cfg.embed_dim)
    scale, shift = ada[:, :, 0], ada[:, :, 1]
    return _ln(h.float(), var.cfg.norm_eps) * (scale + 1.0) + shift


def get_logits_cfg(var: VAR, h_2b: torch.Tensor, cond_bd_2b: torch.Tensor,
                   t: float) -> torch.Tensor:
    """CFG-mixed float32 logits for a (cond | uncond) doubled batch, mixed
    before the head (``(1+t) - t = 1`` keeps its bias), so the C x V matmul
    runs on B rows instead of 2B. TF32 is off here: greedy tokens would flip."""
    b = h_2b.shape[0] // 2
    with fp32_exact():
        nm = _head_nm(var, h_2b, cond_bd_2b)
        mixed = (1.0 + t) * nm[:b] - t * nm[b:]
        return _linear(var.head, mixed)


def transformer_stage(var: VAR, x: torch.Tensor, ctx: List[BlockContext], cache: KVCache,
                      dtype: torch.dtype = torch.bfloat16) -> Tuple[torch.Tensor, KVCache]:
    """Run every block over one scale's token map (``var.py:166-169``),
    writing this stage's K/V into ``cache`` at row ``cache.cum``, which then
    advances by the stage length. Returns (x, cache)."""
    x = x.to(dtype)
    for i, blk in enumerate(var.blocks):
        x = block_apply(blk, var.cfg, x, ctx[i], cache, i)
    cache.cum += x.shape[1]
    return x, cache
