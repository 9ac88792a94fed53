"""VAR transformer (counterpart of ``var_tpu/models/var.py``).

``VAR`` holds the parameters under the reference state-dict names
(``models/var.py:55-116``, ``models/basic_var.py``), so a reference ``.pth``
loads with ``load_state_dict`` once the derived buffers are dropped. The
functions mirror the JAX package's: the AdaLN block with fused QKV, a zero k
bias and the optional per-head QK L2 norm, the GELU-tanh FFN and the fp32
head.

Decode (``block_apply``, ``transformer_stage``): the fused modulated
LayerNorm kernel, attention over a KV cache through a decode-attention
kernel. KV cache: one preallocated (depth, 2B, L, C) K buffer and one V
buffer, written in place each stage (:class:`KVCache`; K's per-head L2 norm
and both writes one launch of ``ops/cuda/kv_write.py``); layer ``i`` attends
over rows ``[0, cum + l)`` by pointer and stride. The JAX package's three
cache representations (``"chunked"`` per-stage stacks, ``"prealloc"``
in-place buffers, ``"concat"`` grow-by-concat arrays) differ only in how
immutable arrays grow, so this one buffer serves all three; the
representation picks the kernel, as it does in the JAX package: chunked
attends through ``flash_decode`` (row 2, q L2 norm in the kernel),
prealloc and concat through ``flash_decode_paired`` (row 4, the scale
folded into q, ``var.py:402``; its q norm runs in the kernel's launch
too).

Teacher-forced training (``var_forward``): one pass over all L tokens with
the block-causal mask through the attention impl the caller picks (the
paired training kernel by default, the streaming flash-attention kernel,
hybrid or dense, dispatched as in the JAX package), the plain
LayerNorm (the LN kernel has no backward), cond-drop and drop-path from an
explicit ``torch.Generator``, ``prog_si`` truncation and remat 0/1/2.
Parameters stay float32 and are cast to the compute dtype at each use, as
in the JAX package; no autocast.

Under a mesh (``parallel/mesh.py``) every function takes ``mesh``: the batch
is this data rank's rows, and with a model axis the module holds this
model rank's Megatron shards (``mesh.shard_var_params``): qkv, fc1 and the
head split by output rows behind ``copy_to_model``, proj and fc2 by input
columns before ``reduce_from_model`` (their biases added once, after it),
the head's logits gathered along V. The attention kernels run unchanged on
``H // mp`` heads and the KV cache holds C/mp channels. The activations
between the blocks stay whole (C) on every rank, so the fused LayerNorm
(row 1) keeps running under a mesh, where the JAX package moves it to XLA
(``var.py:497-503``).
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
from var_tpu_torch.ops.attention import attention, recompute_grad
from var_tpu_torch.ops.cuda.flash_attention import (flash_attention_paired_train, flash_decode,
                                                    flash_decode_paired)
from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm
from var_tpu_torch.ops.cuda.kv_write import kv_write
from var_tpu_torch.parallel import shard_attn as sa
from var_tpu_torch.parallel.mesh import Mesh, data_rows
from var_tpu_torch.utils.profiling import span


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
    ``[0, cum)`` hold the finished stages the next stage attends to (every
    one, or a ``kv_window``'s). ``paired``: attend through
    ``flash_decode_paired`` (the prealloc/concat representations) instead
    of ``flash_decode`` (chunked)."""

    k: torch.Tensor
    v: torch.Tensor
    cum: int = 0
    paired: bool = False


def init_prealloc_caches(cfg: VARConfig, batch: int, dtype: torch.dtype, device,
                         lmax: Optional[int] = None, paired: bool = False,
                         mesh: Optional[Mesh] = None) -> KVCache:
    """Empty (depth, batch, lmax, C / mp) K and V buffers (this model
    rank's heads); ``lmax`` defaults to the whole pyramid, ``cfg.seq_len``."""
    width = sa.local_heads(cfg.num_heads, mesh) * cfg.head_dim
    shape = (cfg.depth, batch, cfg.seq_len if lmax is None else lmax, width)
    return KVCache(torch.empty(shape, dtype=dtype, device=device),
                   torch.empty(shape, dtype=dtype, device=device), paired=paired)


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


def _row_linear(lin: nn.Linear, x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``lin`` whose input columns are split over ``model`` (proj, fc2): the
    partial products summed over the model group, then the whole bias, added
    once."""
    if sa.axis_sizes(mesh)[1] == 1:
        return _linear(lin, x)
    out = sa.reduce_from_model(F.linear(x, lin.weight.to(x.dtype)), mesh)
    return out + lin.bias.to(x.dtype)


def check_sharded(var: "VAR", mesh: Optional[Mesh]) -> None:
    """Raise unless ``var`` holds the shards of ``mesh``'s model axis."""
    c = var.cfg.embed_dim
    want = 3 * c // sa.axis_sizes(mesh)[1]
    got = var.blocks[0].attn.mat_qkv.weight.shape[0] if len(var.blocks) else want
    if got != want:
        raise ValueError(f"the VAR holds {got} qkv rows, the mesh wants {want}: shard it with "
                         f"parallel.mesh.shard_var_params")


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


def cond_context(var: VAR, cond_bd: torch.Tensor, dtype: torch.dtype,
                 mesh: Optional[Mesh] = None) -> List[BlockContext]:
    """Each block's :class:`BlockContext` for the (B, C) class embeddings
    ``cond_bd`` and the compute dtype; under a model axis the qkv bias and
    ``scale_mul`` are this rank's heads'."""
    cfg = var.cfg
    check_sharded(var, mesh)
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
            sm = sm.reshape(-1)
        bias = torch.cat([attn.q_bias, torch.zeros_like(attn.q_bias), attn.v_bias])
        out.append(BlockContext(p6, p6[:, :2].transpose(0, 1)[:, :, None].to(dtype),
                                bias.to(dtype), sm))
    return out


def lvl_pos_embed(var: VAR) -> torch.Tensor:
    """(1, L, C) = scale embedding + absolute positions (``var.py:153``).
    The scale id of each position is filled on the device, not copied from
    the host, so that a CUDA graph can capture the decode."""
    dev = var.pos_1LC.device
    lvl = torch.cat([torch.full((pn * pn,), i, dtype=torch.int64, device=dev)
                     for i, pn in enumerate(var.cfg.patch_nums)])
    return var.lvl_embed.weight[lvl][None] + var.pos_1LC


def _l2_heads(t: torch.Tensor, num_heads: int,
              scale_mul: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-head L2 norm of merged (B, L, C) ``t`` in float32, times the
    per-head ``scale_mul`` (H,) when given: (B, L, H, D) float32."""
    b, l, c = t.shape
    tf = t.float().reshape(b, l, num_heads, c // num_heads)
    inv = torch.rsqrt((tf * tf).sum(-1, keepdim=True) + 1e-24)
    if scale_mul is not None:
        inv = inv * scale_mul.reshape(num_heads, 1)
    return tf * inv


def attn_apply(attn: SelfAttention, cfg: VARConfig, x: torch.Tensor, ctx: BlockContext,
               cache: KVCache, layer: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Fused QKV with a zero k bias, per-head k L2 norm at cache-write time
    (``kv_write``: one launch writes this stage's K and V into the cache; the
    CPU takes its plain version), then attention of this stage's queries over
    cache rows [0, cum + l) (``basic_var.py:90-119``): chunked through
    ``flash_decode``, paired through ``flash_decode_paired`` (the scale folded
    into q, ``var.py:402-454``), both reading q from the fused qkv, with the q
    norm (where ``cfg.attn_l2_norm``) in the kernel's launch. Under a model
    axis both run on this rank's ``H // mp`` heads (JAX's ``decode_paired``
    and ``decode_paired_chunks`` bridges), an odd count too: the kernels take
    one head a block, where JAX's paired kernels want head pairs and leave
    such a mesh to XLA (``var.py:374``, ``:441``). The span ``attention``
    (``utils/profiling.py``, on stamps of its own) bounds the kernel's launch
    alone."""
    l = x.shape[1]
    h, d = sa.local_heads(cfg.num_heads, mesh), cfg.head_dim
    c = h * d
    dtype = x.dtype
    qkv = F.linear(sa.copy_to_model(x, mesh), attn.mat_qkv.weight.to(dtype),
                   ctx.qkv_bias)  # (B, l, 3C / mp)
    cum = cache.cum
    kv_write(qkv[..., c:2 * c], qkv[..., 2 * c:], cache.k[layer, :, cum:cum + l],
             cache.v[layer, :, cum:cum + l], h, cfg.attn_l2_norm)
    scale = 1.0 if cfg.attn_l2_norm else 0.25 / math.sqrt(d)
    k_l, v_l = cache.k[layer], cache.v[layer]
    with span("attention", own=True):
        if cache.paired:
            out = flash_decode_paired(qkv, k_l, v_l, h, scale, lk=cum + l,
                                      q_l2_scale_mul=ctx.scale_mul)
        else:
            out = flash_decode(qkv, k_l, v_l, cum + l, h, scale, q_l2_scale_mul=ctx.scale_mul)
    return _row_linear(attn.proj, out, mesh)


def ffn_apply(ffn: FFN, x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Linear-GELU(tanh)-Linear (``basic_var.py:33-52``); under a model
    axis fc1's rows and fc2's columns are this rank's."""
    hidden = F.gelu(_linear(ffn.fc1, sa.copy_to_model(x, mesh)), approximate="tanh")
    return _row_linear(ffn.fc2, hidden, mesh)


def block_apply(blk: AdaLNSelfAttn, cfg: VARConfig, x: torch.Tensor, ctx: BlockContext,
                cache: KVCache, layer: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Pre-norm AdaLN block (``basic_var.py:152-158``):
    x += attn(ln(x)*(s1+1)+sh1) * g1; x += ffn(ln(x)*(s2+1)+sh2) * g2,
    each LN + modulation one launch of the fused kernel."""
    p6 = ctx.p6
    a_in = modulated_layernorm(x, p6[:, 2], p6[:, 4], eps=cfg.norm_eps)
    x = x + attn_apply(blk.attn, cfg, a_in, ctx, cache, layer, mesh) * ctx.gammas[0]
    f_in = modulated_layernorm(x, p6[:, 3], p6[:, 5], eps=cfg.norm_eps)
    return x + ffn_apply(blk.ffn, f_in, mesh) * ctx.gammas[1]


def _head_nm(var: VAR, h: torch.Tensor, cond_bd: torch.Tensor) -> torch.Tensor:
    ada = _linear(var.head_nm.ada_lin[1], F.silu(cond_bd.float()))
    ada = ada.reshape(-1, 1, 2, var.cfg.embed_dim)
    scale, shift = ada[:, :, 0], ada[:, :, 1]
    return _ln(h.float(), var.cfg.norm_eps) * (scale + 1.0) + shift


def get_logits_cfg(var: VAR, h_2b: torch.Tensor, cond_bd_2b: torch.Tensor,
                   t: float, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """CFG-mixed float32 logits for a (cond | uncond) doubled batch, mixed
    before the head (``(1+t) - t = 1`` keeps its bias), so the C x V matmul
    runs on B rows instead of 2B. TF32 is off here: greedy tokens would flip.
    Under a model axis the V/mp columns of each rank are gathered, so every
    rank holds the whole logits."""
    b = h_2b.shape[0] // 2
    with fp32_exact():
        nm = _head_nm(var, h_2b, cond_bd_2b)
        mixed = (1.0 + t) * nm[:b] - t * nm[b:]
        return sa.gather_from_model(_linear(var.head, sa.copy_to_model(mixed, mesh)), mesh)


def transformer_stage(var: VAR, x: torch.Tensor, ctx: List[BlockContext], cache: KVCache,
                      dtype: torch.dtype = torch.bfloat16,
                      mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, KVCache]:
    """Run every block over one scale's token map (``var.py:166-169``),
    writing this stage's K/V into ``cache`` at row ``cache.cum``, which then
    advances by the stage length. Returns (x, cache)."""
    x = x.to(dtype)
    for i, blk in enumerate(var.blocks):
        x = block_apply(blk, var.cfg, x, ctx[i], cache, i, mesh)
    cache.cum += x.shape[1]
    return x, cache


# ---------------------------------------------------------------------------
# teacher-forced forward (training / likelihood scoring)


def _mod_ln(eps: float, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    return _ln(x, eps) * (scale + 1.0) + shift


def _attn_core(cfg: VARConfig, scale_ends: Sequence[int], impl: str, qkv: torch.Tensor,
               scale_mul: Optional[torch.Tensor]) -> torch.Tensor:
    """Merged qkv -> per-head QK L2 norm (or the 0.25/sqrt(d) scale) ->
    block-causal attention, (B, L, C) (``var.py:293-347``): ``paired``
    through the paired training kernel (row 6) on merged tensors, every
    other impl through :func:`ops.attention.attention` on BLHD views
    (``pallas``: the streaming kernel, row 5; else the dense path). The
    heads are ``qkv``'s: this model rank's under a mesh."""
    b, l, c3 = qkv.shape
    d = cfg.head_dim
    c = c3 // 3
    h = c // d
    dtype = qkv.dtype
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    if cfg.attn_l2_norm:
        scale = 1.0
        sm = torch.exp(scale_mul.float().clamp(max=math.log(100.0)))
        k = _l2_heads(k, h).to(dtype).reshape(b, l, c)
        q = _l2_heads(q, h, sm).to(dtype).reshape(b, l, c)
    else:
        scale = 0.25 / math.sqrt(d)
    if impl == "paired":
        return flash_attention_paired_train(q, k, v, h, scale, scale_ends)
    out = attention(q.reshape(b, l, h, d), k.reshape(b, l, h, d), v.reshape(b, l, h, d), scale,
                    impl=impl, scale_ends=scale_ends)
    return out.reshape(b, l, c)


def train_attn_apply(attn: SelfAttention, cfg: VARConfig, x: torch.Tensor,
                     scale_ends: Sequence[int], remat_core: bool,
                     impl: str = "paired", mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Fused QKV with a zero k bias, then the attention core, then the
    projection (``var.py:402-410``). ``paired`` degrades to ``xla`` unless
    the heads pair into 128 lanes (even count, head_dim 64; ``var.py:262``).
    With ``remat_core`` (remat mode 2) the core is recomputed in backward:
    only the qkv tensor is kept (``var.py:322-359``); ``hybrid`` then runs
    row 5's forward as the primal and takes the dense path's backward.
    Without it, ``hybrid`` is the dense path, as JAX's ``attention`` treats
    every impl but ``pallas`` (``ops/attention.py:98``). Under a mesh the
    kernels run on this rank's heads (JAX's ``paired_train`` and
    ``flash_blhd`` bridges), an odd count too: row 6 takes one head a
    block, where JAX sends a mesh with odd heads a device to XLA
    (``var.py:271-282``)."""
    h = cfg.num_heads
    if impl == "paired" and not (h % 2 == 0 and 2 * cfg.head_dim == 128):
        impl = "xla"
    dtype = x.dtype
    bias = torch.cat([attn.q_bias, torch.zeros_like(attn.q_bias), attn.v_bias]).to(dtype)
    qkv = F.linear(sa.copy_to_model(x, mesh), attn.mat_qkv.weight.to(dtype), bias)
    core = functools.partial(_attn_core, cfg, scale_ends, impl)
    if remat_core and impl == "hybrid":
        core = recompute_grad(functools.partial(_attn_core, cfg, scale_ends, "pallas"),
                              bwd_fn=functools.partial(_attn_core, cfg, scale_ends, "xla"))
    elif remat_core:
        core = recompute_grad(core)
    out = core(qkv, attn.scale_mul_1H11 if cfg.attn_l2_norm else None)
    return _row_linear(attn.proj, out, mesh)


def train_block_apply(blk: AdaLNSelfAttn, cfg: VARConfig, x: torch.Tensor,
                      cond_h: torch.Tensor, shared: Optional[torch.Tensor],
                      scale_ends: Sequence[int], remat: int = 0,
                      drop_path: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      attn_impl: str = "paired", mesh: Optional[Mesh] = None):
    """Pre-norm AdaLN block (``var.py:475-548``) for teacher forcing:
    x += dp(attn(ln(x)*(s1+1)+sh1) * g1); x += dp(ffn(ln(x)*(s2+1)+sh2) * g2),
    with the plain LayerNorm. ``cond_h`` = silu(class embedding) (B, C) fp32;
    ``shared``: the (B, 6, C) ``shared_ada_lin`` output with shared AdaLN.
    ``remat`` 2 recomputes the LN, the attention core and the FFN hidden
    states in backward. ``drop_path``: two (B, 1, 1) fp32 keep/keep-rate
    masks. ``attn_impl``: see :func:`train_attn_apply`."""
    dtype = x.dtype
    p6 = _adaln6(blk, cfg, cond_h, shared)[:, None]  # (B, 1, 6, C) fp32
    g1, g2, s1, s2, sh1, sh2 = (p6[:, :, i].to(dtype) for i in range(6))
    mod_ln = functools.partial(_mod_ln, cfg.norm_eps)
    ffn = ffn_apply
    if remat == 2:
        mod_ln, ffn = recompute_grad(mod_ln), recompute_grad(ffn_apply)
    a_out = train_attn_apply(blk.attn, cfg, mod_ln(x, s1, sh1), scale_ends, remat == 2,
                             attn_impl, mesh) * g1
    if drop_path is not None:
        a_out = a_out * drop_path[0].to(dtype)
    x = x + a_out
    f_out = ffn(blk.ffn, mod_ln(x, s2, sh2), mesh) * g2
    if drop_path is not None:
        f_out = f_out * drop_path[1].to(dtype)
    return x + f_out


def get_logits(var: VAR, h: torch.Tensor, cond_bd: torch.Tensor,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """AdaLN-before-head and the classifier head, all fp32 (``var.py:551``);
    under a model axis the logits are gathered along V."""
    nm = sa.copy_to_model(_head_nm(var, h, cond_bd), mesh)
    return sa.gather_from_model(_linear(var.head, nm), mesh)


def cond_drop(cfg: VARConfig, label_b: torch.Tensor, generator: torch.Generator,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Labels with each replaced by the unconditional class (``num_classes``)
    with probability ``cond_drop_rate`` (``var.py:643-647``). Under a mesh
    the draw is the global batch's and this data rank takes its rows, as JAX
    draws one key over the sharded batch: the masks do not depend on dp."""
    row0, glb = data_rows(mesh, label_b.shape[0])
    drop = torch.rand(glb, generator=generator, device=label_b.device)
    drop = drop[row0:row0 + label_b.shape[0]]
    return torch.where(drop < cfg.cond_drop_rate, torch.full_like(label_b, cfg.num_classes),
                       label_b)


def drop_path_masks(cfg: VARConfig, batch: int, generator: torch.Generator,
                    device, mesh: Optional[Mesh] = None
                    ) -> List[Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Per block, None (rate 0) or the two (B, 1, 1) float32 masks of its
    residual branches: 1 / keep with probability keep = 1 - rate_i, else 0,
    rates linear in depth from 0 to ``drop_path_rate`` (``var.py:686-696``).
    Under a mesh drawn for the global batch, this data rank's rows kept."""
    row0, glb = data_rows(mesh, batch)

    def mask(keep):
        u = torch.rand(glb, 1, 1, generator=generator, device=device)[row0:row0 + batch]
        return (u < keep).float() / keep

    out = []
    for rate in np.linspace(0.0, cfg.drop_path_rate, cfg.depth):
        keep = 1.0 - float(rate)
        out.append(None if rate <= 0 else (mask(keep), mask(keep)))
    return out


def var_forward(var: VAR, label_b: torch.Tensor, x_blcv_wo_first_l: Optional[torch.Tensor],
                *, generator: Optional[torch.Generator] = None, train: bool = False,
                prog_si: int = -1, dtype: torch.dtype = torch.bfloat16,
                remat: int = 0, attn_impl: str = "paired",
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Teacher-forced forward (``var.py:614-723``) -> fp32 logits (B, ed, V).

    ``x_blcv_wo_first_l``: (B, L - first_l, Cvae) quantizer-space inputs from
    ``quantizer.idxBl_to_var_input``; ``prog_si`` >= 0 truncates the
    sequence at the end of scale ``prog_si`` (progressive training). With
    ``train``, cond-drop replaces labels by the unconditional class at
    ``cond_drop_rate`` and drop-path keeps each residual branch of block i
    with probability 1 - rate_i (rates linear in depth up to
    ``drop_path_rate``), both drawn from ``generator``. ``remat``: 0 off;
    1 recomputes each whole block in backward; 2 only the LN, attention core
    and FFN hidden states (``attn_remat``). ``attn_impl``: ``paired`` (the
    default: what ``auto`` resolves to on the GPU), ``pallas``, ``hybrid``
    or ``xla``, dispatched as in the JAX package (:func:`train_attn_apply`).
    ``mesh``: the batch is this data rank's rows and ``var`` this model
    rank's shards; the logits come back whole (V) on every model rank."""
    cfg = var.cfg
    check_sharded(var, mesh)
    b, c = label_b.shape[0], cfg.embed_dim
    ed = cfg.seq_len if prog_si < 0 else cfg.begin_ends[prog_si][1]
    if train and (cfg.cond_drop_rate > 0 or cfg.drop_path_rate > 0) and generator is None:
        raise ValueError("a training forward needs a generator for cond-drop and drop-path")
    if train and cfg.cond_drop_rate > 0:
        label_b = cond_drop(cfg, label_b, generator, mesh)
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
        dps = drop_path_masks(cfg, b, generator, x.device, mesh)
    for blk, dp in zip(var.blocks, dps):
        if remat == 1:
            x = recompute_grad(train_block_apply)(blk, cfg, x, cond_h, shared, scale_ends, 0, dp,
                                                  attn_impl, mesh)
        else:
            x = train_block_apply(blk, cfg, x, cond_h, shared, scale_ends, remat, dp, attn_impl,
                                  mesh)
    return get_logits(var, x, cond_bd, mesh)
