"""VAR transformer (counterpart of ``var_tpu/models/var.py``).

``VAR`` holds the parameters under the reference state-dict names
(``models/var.py:55-116``, ``models/basic_var.py``), so a reference ``.pth``
loads with ``load_state_dict`` once the derived buffers are dropped. The
functions mirror the JAX package's: the AdaLN block with fused QKV, a zero k
bias and the optional per-head QK L2 norm, the GELU-tanh FFN and the fp32
head.

Decode (``block_apply``, ``transformer_stage``): the fused modulated
LayerNorm kernel, attention over a KV cache through the decode-attention
kernel. KV cache: one preallocated (depth, 2B, L, C) K buffer and one V
buffer, written in place each stage (:class:`KVCache`); layer ``i`` attends
over rows ``[0, cum + l)`` by pointer and stride. The JAX package keeps
per-stage chunks only because its arrays are immutable.

Teacher-forced training (``var_forward``): one pass over all L tokens with
the block-causal mask through the training-attention kernel, the plain
LayerNorm (the LN kernel has no backward), cond-drop and drop-path from an
explicit ``torch.Generator``, ``prog_si`` truncation and remat 0/1/2.
Parameters stay float32 and are cast to the compute dtype at each use, as
in the JAX package; no autocast.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from var_tpu_torch.config import VARConfig
from var_tpu_torch.device import fp32_exact
from var_tpu_torch.ops.attention import recompute_grad
from var_tpu_torch.ops.cuda.flash_attention import flash_attention_paired_train, flash_decode
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


# ---------------------------------------------------------------------------
# teacher-forced forward (training / likelihood scoring)


def _mod_ln(eps: float, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    return _ln(x, eps) * (scale + 1.0) + shift


def _attn_core(cfg: VARConfig, scale_ends: Sequence[int], qkv: torch.Tensor,
               scale_mul: Optional[torch.Tensor]) -> torch.Tensor:
    """Merged qkv -> per-head QK L2 norm (or the 0.25/sqrt(d) scale) ->
    block-causal attention, (B, L, C) (``var.py:293-347``)."""
    b, l, _ = qkv.shape
    c, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    dtype = qkv.dtype
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    if cfg.attn_l2_norm:
        scale = 1.0
        sm = torch.exp(scale_mul.float().clamp(max=math.log(100.0))).reshape(h, 1)
        kf = k.float().reshape(b, l, h, d)
        k = (kf * torch.rsqrt((kf * kf).sum(-1, keepdim=True) + 1e-24)).to(dtype)
        qf = q.float().reshape(b, l, h, d)
        q = (qf * (torch.rsqrt((qf * qf).sum(-1, keepdim=True) + 1e-24) * sm)).to(dtype)
        q, k = q.reshape(b, l, c), k.reshape(b, l, c)
    else:
        scale = 0.25 / math.sqrt(d)
    return flash_attention_paired_train(q, k, v, h, scale, scale_ends)


def train_attn_apply(attn: SelfAttention, cfg: VARConfig, x: torch.Tensor,
                     scale_ends: Sequence[int], remat_core: bool) -> torch.Tensor:
    """Fused QKV with a zero k bias, then the attention core, then the
    projection (``var.py:402-410``). With ``remat_core`` (remat mode 2)
    the core is recomputed in backward: only the qkv tensor is kept
    (``var.py:322-359``)."""
    dtype = x.dtype
    bias = torch.cat([attn.q_bias, torch.zeros_like(attn.q_bias), attn.v_bias]).to(dtype)
    qkv = F.linear(x, attn.mat_qkv.weight.to(dtype), bias)
    core = functools.partial(_attn_core, cfg, scale_ends)
    if remat_core:
        core = recompute_grad(core)
    return _linear(attn.proj, core(qkv, attn.scale_mul_1H11 if cfg.attn_l2_norm else None))


def train_block_apply(blk: AdaLNSelfAttn, cfg: VARConfig, x: torch.Tensor,
                      cond_h: torch.Tensor, shared: Optional[torch.Tensor],
                      scale_ends: Sequence[int], remat: int = 0,
                      drop_path: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Pre-norm AdaLN block (``var.py:475-548``) for teacher forcing:
    x += dp(attn(ln(x)*(s1+1)+sh1) * g1); x += dp(ffn(ln(x)*(s2+1)+sh2) * g2),
    with the plain LayerNorm. ``cond_h`` = silu(class embedding) (B, C) fp32;
    ``shared``: the (B, 6, C) ``shared_ada_lin`` output with shared AdaLN.
    ``remat`` 2 recomputes the LN, the attention core and the FFN hidden
    states in backward. ``drop_path``: two (B, 1, 1) fp32 keep/keep-rate masks."""
    dtype = x.dtype
    p6 = _adaln6(blk, cfg, cond_h, shared)[:, None]  # (B, 1, 6, C) fp32
    g1, g2, s1, s2, sh1, sh2 = (p6[:, :, i].to(dtype) for i in range(6))
    mod_ln = functools.partial(_mod_ln, cfg.norm_eps)
    ffn = ffn_apply
    if remat == 2:
        mod_ln, ffn = recompute_grad(mod_ln), recompute_grad(ffn_apply)
    a_out = train_attn_apply(blk.attn, cfg, mod_ln(x, s1, sh1), scale_ends, remat == 2) * g1
    if drop_path is not None:
        a_out = a_out * drop_path[0].to(dtype)
    x = x + a_out
    f_out = ffn(blk.ffn, mod_ln(x, s2, sh2)) * g2
    if drop_path is not None:
        f_out = f_out * drop_path[1].to(dtype)
    return x + f_out


def get_logits(var: VAR, h: torch.Tensor, cond_bd: torch.Tensor) -> torch.Tensor:
    """AdaLN-before-head and the classifier head, all fp32 (``var.py:551``)."""
    return _linear(var.head, _head_nm(var, h, cond_bd))


def cond_drop(cfg: VARConfig, label_b: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Labels with each replaced by the unconditional class (``num_classes``)
    with probability ``cond_drop_rate`` (``var.py:643-647``)."""
    drop = torch.rand(label_b.shape[0], generator=generator, device=label_b.device)
    return torch.where(drop < cfg.cond_drop_rate, torch.full_like(label_b, cfg.num_classes),
                       label_b)


def drop_path_masks(cfg: VARConfig, batch: int, generator: torch.Generator,
                    device) -> List[Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Per block, None (rate 0) or the two (B, 1, 1) float32 masks of its
    residual branches: 1 / keep with probability keep = 1 - rate_i, else 0,
    rates linear in depth from 0 to ``drop_path_rate`` (``var.py:686-696``)."""
    out = []
    for rate in np.linspace(0.0, cfg.drop_path_rate, cfg.depth):
        keep = 1.0 - float(rate)
        out.append(None if rate <= 0 else tuple(
            (torch.rand(batch, 1, 1, generator=generator, device=device) < keep).float() / keep
            for _ in range(2)))
    return out


def var_forward(var: VAR, label_b: torch.Tensor, x_blcv_wo_first_l: Optional[torch.Tensor],
                *, generator: Optional[torch.Generator] = None, train: bool = False,
                prog_si: int = -1, dtype: torch.dtype = torch.bfloat16,
                remat: int = 0) -> torch.Tensor:
    """Teacher-forced forward (``var.py:614-723``) -> fp32 logits (B, ed, V).

    ``x_blcv_wo_first_l``: (B, L - first_l, Cvae) quantizer-space inputs from
    ``quantizer.idxBl_to_var_input``; ``prog_si`` >= 0 truncates the
    sequence at the end of scale ``prog_si`` (progressive training). With
    ``train``, cond-drop replaces labels by the unconditional class at
    ``cond_drop_rate`` and drop-path keeps each residual branch of block i
    with probability 1 - rate_i (rates linear in depth up to
    ``drop_path_rate``), both drawn from ``generator``. ``remat``: 0 off;
    1 recomputes each whole block in backward; 2 only the LN, attention core
    and FFN hidden states (``attn_remat``)."""
    cfg = var.cfg
    b, c = label_b.shape[0], cfg.embed_dim
    ed = cfg.seq_len if prog_si < 0 else cfg.begin_ends[prog_si][1]
    if train and (cfg.cond_drop_rate > 0 or cfg.drop_path_rate > 0) and generator is None:
        raise ValueError("a training forward needs a generator for cond-drop and drop-path")
    if train and cfg.cond_drop_rate > 0:
        label_b = cond_drop(cfg, label_b, generator)
    cond_bd = F.embedding(label_b, var.class_emb.weight)  # (B, C) fp32
    x = (cond_bd[:, None] + var.pos_start).expand(b, cfg.first_l, c)
    if prog_si != 0:
        tok = x_blcv_wo_first_l[:, :ed - cfg.first_l].float()
        x = torch.cat([x, _linear(var.word_embed, tok)], dim=1)
    x = (x + lvl_pos_embed(var)[:, :ed]).to(dtype)
    scale_ends = tuple(e for _, e in cfg.begin_ends)
    cond_h = F.silu(cond_bd.float())
    shared = None
    if cfg.shared_aln:
        shared = _linear(var.shared_ada_lin[1], cond_h).reshape(-1, 6, c)
    dps = [None] * cfg.depth
    if train and cfg.drop_path_rate > 0:
        dps = drop_path_masks(cfg, b, generator, x.device)
    for blk, dp in zip(var.blocks, dps):
        if remat == 1:
            x = recompute_grad(functools.partial(train_block_apply, blk, cfg))(
                x, cond_h, shared, scale_ends, 0, dp)
        else:
            x = train_block_apply(blk, cfg, x, cond_h, shared, scale_ends, remat, dp)
    return get_logits(var, x, cond_bd)
