"""VQVAE tokenizer: encoder, quantizer and decoder (counterpart of
``var_tpu/models/vae.py``).

NCHW inside (a bf16 or fp16 decode without gradients on CUDA keeps
channels-last memory throughout: :func:`channels_last_decode`; so does a
float32 encode without gradients on CUDA, its convolutions through
``ops/cuda/conv3xtf32.py``: :func:`channels_last_encode`), with the
reference module names (``models/basic_vae.py``, ``models/vqvae.py``) so a
whole reference state dict loads with ``load_state_dict``: ``encoder.*``,
``quant_conv.*``, ``quantize.*``, ``post_quant_conv.*``, ``decoder.*``.
Convolutions cast their float32
weights to the input dtype at use, as the JAX package does, so the networks
run in the compute dtype. Public tensors are NHWC: ``img_to_idxBl`` takes an
image (B, H, W, 3) in [-1, 1] and returns the token pyramid; ``fhat_to_img``
takes f_hat (B, h, w, Cvae) and returns the image (B, H, W, 3);
``img_to_fhat`` and ``idxBl_to_img`` are the classifier's round trips;
``embed_to_img`` decodes per-scale embeddings and
``img_to_reconstructed_img`` is the tokenize-and-decode round trip;
``make_tokenizer`` compiles ``img_to_idxBl``;
``vae_train_forward`` is the tokenizer-training forward. ``gn_impl`` picks
the GroupNorm formulation of every function that runs the networks
(:func:`group_norm`): "dot" by default, "pallas" through row 7's kernel.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from var_tpu_torch.config import VAEConfig
from var_tpu_torch.device import fp32_exact
from var_tpu_torch.engine.compiled import Compiled
from var_tpu_torch.models import quantizer as q
from var_tpu_torch.models.quantizer import VectorQuantizer2
from var_tpu_torch.ops.cuda.conv3xtf32 import conv3xtf32, takes
from var_tpu_torch.ops.cuda.gn_silu import gn_silu
from var_tpu_torch.ops.cuda.gn_stats import gn_channel_stats


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weights are cast to the input dtype at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))

    def channels_last(self, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
        """The same convolution with the weights cast to channels-last
        memory too, so that cuDNN takes channels-last ``x`` as it is.
        ``bias=False`` leaves the bias to the caller: PyTorch adds it in a
        broadcasting pass of its own, which a norm's kernel can take in."""
        w = self.weight.to(x.dtype, memory_format=torch.channels_last)
        return self._conv_forward(x, w, self.bias.to(x.dtype) if bias else None)


GN_IMPLS = ("dot", "xla", "pallas")


def group_norm(norm: nn.GroupNorm, x: torch.Tensor, impl: str = "dot") -> torch.Tensor:
    """``torch.nn.GroupNorm`` semantics (``basic_vae.py:18-19``; statistics
    accumulate in float32 for every input dtype), on NCHW ``x``.

    ``impl`` as in the JAX package's ``group_norm``: "dot" and "xla" (two
    XLA formulations of the same float32 statistics there, no kernel in
    either) are ``F.group_norm``; "pallas" takes the per-channel sums from
    row 7's kernel (``ops/cuda/gn_stats.py``, which needs dense NCHW ``x``
    on the GPU) and follows JAX's lines: group sums, ``var = E[x^2] -
    mean^2`` unclamped, the affine folded into one per-(batch, channel)
    scale and shift in float32, cast to x's dtype, applied as
    ``x * scale + shift``."""
    if impl in ("dot", "xla"):
        return F.group_norm(x, norm.num_groups, norm.weight.to(x.dtype), norm.bias.to(x.dtype),
                            norm.eps)
    if impl != "pallas":
        raise ValueError(f"group_norm impl {impl!r}: want one of {GN_IMPLS}")
    b, c, h, w = x.shape
    g = norm.num_groups
    n = h * w * (c // g)  # elements per (batch, group)
    s, ss = gn_channel_stats(x)  # (b, c) float32 each
    mean = s.reshape(b, g, -1).sum(-1, keepdim=True) / n  # (b, g, 1)
    var = ss.reshape(b, g, -1).sum(-1, keepdim=True) / n - mean * mean
    g_scale = norm.weight.float().reshape(1, g, -1) * torch.rsqrt(var + norm.eps)  # (b, g, c/g)
    g_shift = norm.bias.float().reshape(1, g, -1) - mean * g_scale
    return (x * g_scale.reshape(b, c, 1, 1).to(x.dtype)
            + g_shift.reshape(b, c, 1, 1).to(x.dtype))


_NHWC_DEVICES = ("cuda",)  # where gn_silu and conv3xtf32 have kernels


def channels_last_decode(vae: VQVAE, f_hat: torch.Tensor, gn_impl: str) -> bool:
    """Whether :func:`fhat_to_img` of ``f_hat`` runs channels-last: its
    GroupNorms through ``ops/cuda/gn_silu.py`` (norm and SiLU in three
    kernels: statistics, finalize, apply), its convolutions with
    channels-last weights, its upsamples, adds and attention over NHWC
    memory. Taken from the input
    alone: ``f_hat`` on CUDA, bfloat16 or float16, no gradient wanted
    (autograd off, or neither ``f_hat`` nor a parameter of
    ``post_quant_conv`` or the decoder requiring one) and ``gn_impl`` "dot"
    or "xla". Every other decode (float32, under autograd,
    ``gn_impl="pallas"``, the CPU) and the training forward run
    :func:`group_norm` over NCHW as before; the encoder has its own test
    (:func:`channels_last_encode`)."""
    trainable = (p.requires_grad for m in (vae.post_quant_conv, vae.decoder)
                 for p in m.parameters())
    return (f_hat.device.type in _NHWC_DEVICES
            and f_hat.dtype in (torch.bfloat16, torch.float16) and gn_impl in ("dot", "xla")
            and not (torch.is_grad_enabled() and (f_hat.requires_grad or any(trainable))))


def channels_last_encode(vae: VQVAE, img: torch.Tensor, gn_impl: str) -> bool:
    """Whether :func:`img_to_f` of ``img`` runs the encoder and
    ``quant_conv`` channels-last (:func:`encoder_apply`'s ``nhwc``): every
    convolution one launch of ``ops/cuda/conv3xtf32.py``'s kernel (float32
    accuracy from three TF32 products a term), every GroupNorm through
    ``ops/cuda/gn_silu.py``'s float32 kernels. Taken from the input alone:
    ``img`` on CUDA, float32, no gradient wanted (autograd off, or neither
    ``img`` nor a parameter of the encoder or ``quant_conv`` requiring one)
    and ``gn_impl`` "dot" or "xla"; and widths the kernel takes in every one
    of those convolutions (``conv3xtf32.takes``: the published tokenizer's
    do; a test's 8-channel latent does not). A bf16 encode (``vae_bf16``),
    tokenizer training, ``gn_impl="pallas"`` and the CPU run the NCHW
    encoder; no decoder and no quantizer convolution takes the kernel."""
    trainable = (p.requires_grad for m in (vae.encoder, vae.quant_conv) for p in m.parameters())
    convs = [m for m in (*vae.encoder.modules(), vae.quant_conv) if isinstance(m, nn.Conv2d)]
    return (img.device.type in _NHWC_DEVICES and img.dtype == torch.float32
            and gn_impl in ("dot", "xla")
            and not (torch.is_grad_enabled() and (img.requires_grad or any(trainable)))
            and all(takes(c.in_channels, c.out_channels, *c.kernel_size) for c in convs))


def gn_nhwc(norm: nn.GroupNorm, x: torch.Tensor, silu: bool = True,
            bias_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``swish(group_norm(x + bias_in))`` (``silu=False``: the norm alone)
    over channels-last ``x`` through the kernels of
    ``ops/cuda/gn_silu.py``; ``bias_in``: the bias of the convolution that
    made ``x``, left out of it (``Conv2d.channels_last(bias=False)``)."""
    return gn_silu(x, norm.weight.float(), norm.bias.float(), norm.num_groups, norm.eps, silu,
                   None if bias_in is None else bias_in.float())


def _conv(conv: Conv2d, x: torch.Tensor, nhwc: bool, residual: Optional[torch.Tensor] = None,
          pad: Optional[tuple] = None, bias: bool = True) -> torch.Tensor:
    """``residual + conv(x)`` (``residual`` None: the convolution alone);
    ``pad`` (left, right, top, bottom, as ``F.pad``) in place of the conv's
    own padding. ``nhwc``: over channels-last memory, a float32 ``x``
    through one conv3xtf32 launch (:func:`channels_last_encode`; its bias
    and the residual added in the launch), any other dtype through
    :meth:`Conv2d.channels_last` (``bias=False``: the bias left to the
    caller)."""
    if nhwc and x.dtype == torch.float32:
        p = conv.padding[0]
        return conv3xtf32(x, conv.weight.float(), conv.bias.float(), conv.stride[0],
                          pad or (p, p, p, p), residual)
    if pad is not None:
        x = F.pad(x, pad)
    y = conv.channels_last(x, bias) if nhwc else conv(x)
    return y if residual is None else residual + y


def _norm(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _norm(cin)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _norm(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = Conv2d(cin, cout, 1) if cin != cout else None


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = _norm(c)
        self.qkv = Conv2d(c, 3 * c, 1)
        self.proj_out = Conv2d(c, c, 1)


class Upsample2x(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)


class Downsample2x(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2, padding=0)


class _DownLevel(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()
        self.downsample: Optional[Downsample2x] = None


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()
        self.upsample: Optional[Upsample2x] = None


class _Mid(nn.Module):
    def __init__(self, c: int, using_mid_sa: bool):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c) if using_mid_sa else None
        self.block_2 = ResnetBlock(c, c)


class Encoder(nn.Module):
    """Mirrors ``basic_vae.py:95-160``: down[i] is resolution level i."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, mult, nblk = cfg.ch, cfg.ch_mult, cfg.num_res_blocks
        nres = len(mult)
        in_mult = (1,) + tuple(mult)
        self.conv_in = Conv2d(3, ch, 3, padding=1)
        levels = []
        for i in range(nres):
            level = _DownLevel()
            block_in, cout = ch * in_mult[i], ch * mult[i]
            for _ in range(nblk):
                level.block.append(ResnetBlock(block_in, cout))
                block_in = cout
                if i == nres - 1 and cfg.using_sa:
                    level.attn.append(AttnBlock(cout))
            if i != nres - 1:
                level.downsample = Downsample2x(cout)
            levels.append(level)
        self.down = nn.ModuleList(levels)
        cmid = ch * mult[-1]
        self.mid = _Mid(cmid, cfg.using_mid_sa)
        self.norm_out = _norm(cmid)
        self.conv_out = Conv2d(cmid, cfg.z_channels, 3, padding=1)


class Decoder(nn.Module):
    """Mirrors ``basic_vae.py:163-226``: up[i] is resolution level i."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch, mult, nblk = cfg.ch, cfg.ch_mult, cfg.num_res_blocks
        nres = len(mult)
        block_in = ch * mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in, cfg.using_mid_sa)
        levels = [None] * nres
        for i in reversed(range(nres)):
            level = _Level()
            cout = ch * mult[i]
            for _ in range(nblk + 1):
                level.block.append(ResnetBlock(block_in, cout))
                block_in = cout
                if i == nres - 1 and cfg.using_sa:
                    level.attn.append(AttnBlock(cout))
            if i != 0:
                level.upsample = Upsample2x(cout)
            levels[i] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = _norm(block_in)
        self.conv_out = Conv2d(block_in, 3, 3, padding=1)


class VQVAE(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.quantize = VectorQuantizer2(cfg)
        ks = cfg.quant_conv_ks
        self.quant_conv = Conv2d(cfg.z_channels, cfg.z_channels, ks, padding=ks // 2)
        self.post_quant_conv = Conv2d(cfg.z_channels, cfg.z_channels, ks, padding=ks // 2)
        self.decoder = Decoder(cfg)


@torch.no_grad()
def init_vae_params(vae: VQVAE, generator: torch.Generator) -> VQVAE:
    """Seeded random init in place, in the ``nn.Conv2d``/``nn.GroupNorm``
    default families (uniform +-1/sqrt(fan_in), unit norms), codebook
    uniform +-1/V. Does not reproduce JAX's random stream."""
    for m in vae.modules():
        if isinstance(m, nn.Conv2d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            v = m.weight.shape[0]
            m.weight.uniform_(-1.0 / v, 1.0 / v, generator=generator)
    return vae


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def resnet_block(blk: ResnetBlock, x: torch.Tensor, gn_impl: str = "dot",
                 nhwc: bool = False) -> torch.Tensor:
    """norm-swish-conv x2 with a (1x1-projected) residual (``basic_vae.py:40-60``).
    ``nhwc`` (:func:`channels_last_decode`, :func:`channels_last_encode`):
    channels-last; conv1's bias added inside norm2's kernel, and in float32
    inside conv1's launch and the residual inside conv2's (:func:`_conv`)."""
    if nhwc:
        fold = x.dtype != torch.float32
        h = _conv(blk.conv1, gn_nhwc(blk.norm1, x), nhwc, bias=not fold)
        h = gn_nhwc(blk.norm2, h, bias_in=blk.conv1.bias if fold else None)
    else:
        h = blk.conv1(swish(group_norm(blk.norm1, x, gn_impl)))
        h = swish(group_norm(blk.norm2, h, gn_impl))
    if blk.nin_shortcut is not None:
        x = _conv(blk.nin_shortcut, x, nhwc)
    return _conv(blk.conv2, h, nhwc, residual=x)


def attn_block(blk: AttnBlock, x: torch.Tensor, gn_impl: str = "dot",
               nhwc: bool = False) -> torch.Tensor:
    """Single-head self-attention over the spatial grid, in float32
    (``basic_vae.py:63-92``); qkv channel blocks are q | k | v. ``nhwc``:
    the same products over channels-last memory, (B, HW, C) a row a pixel."""
    b, c, h, w = x.shape
    if nhwc:
        qkv = _conv(blk.qkv, gn_nhwc(blk.norm, x, silu=False), nhwc)
        q, k, v = qkv.permute(0, 2, 3, 1).reshape(b, h * w, 3, c).float().unbind(2)
        attn = torch.softmax(torch.bmm(q, k.transpose(1, 2)) * (c ** -0.5), dim=-1)
        out = torch.bmm(attn, v).to(x.dtype).reshape(b, h, w, c).permute(0, 3, 1, 2)
    else:
        qkv = blk.qkv(group_norm(blk.norm, x, gn_impl)).reshape(b, 3, c, h * w).float()
        q, k, v = qkv.unbind(1)  # (B, C, HW) each
        attn = torch.softmax(torch.bmm(q.transpose(1, 2), k) * (c ** -0.5), dim=-1)
        out = torch.bmm(v, attn.transpose(1, 2)).reshape(b, c, h, w).to(x.dtype)
    return _conv(blk.proj_out, out, nhwc, residual=x)


def downsample2x(ds: Downsample2x, x: torch.Tensor, nhwc: bool = False) -> torch.Tensor:
    """Asymmetric pad (0, 1, 0, 1) then a stride-2 3x3 conv (``basic_vae.py:31-37``)."""
    return _conv(ds.conv, x, nhwc, pad=(0, 1, 0, 1))


def upsample2x(up: Upsample2x, x: torch.Tensor, nhwc: bool = False) -> torch.Tensor:
    """Nearest 2x then a 3x3 conv (``basic_vae.py:22-28``)."""
    return _conv(up.conv, F.interpolate(x, scale_factor=2.0, mode="nearest"), nhwc)


def encoder_apply(enc: Encoder, x: torch.Tensor, gn_impl: str = "dot",
                  nhwc: bool = False) -> torch.Tensor:
    """(B, 3, H, W) in [-1, 1] -> (B, Cvae, H/16, W/16), NCHW (``basic_vae.py:144-160``).
    ``nhwc`` (:func:`channels_last_encode`): channels-last float32 ``x`` in,
    each convolution one conv3xtf32 launch, each GroupNorm (and SiLU)
    gn_silu's kernels, the result channels-last."""
    h = _conv(enc.conv_in, x, nhwc)
    for level in enc.down:
        for j, blk in enumerate(level.block):
            h = resnet_block(blk, h, gn_impl, nhwc)
            if len(level.attn):
                h = attn_block(level.attn[j], h, gn_impl, nhwc)
        if level.downsample is not None:
            h = downsample2x(level.downsample, h, nhwc)
    h = resnet_block(enc.mid.block_1, h, gn_impl, nhwc)
    if enc.mid.attn_1 is not None:
        h = attn_block(enc.mid.attn_1, h, gn_impl, nhwc)
    h = resnet_block(enc.mid.block_2, h, gn_impl, nhwc)
    h = gn_nhwc(enc.norm_out, h) if nhwc else swish(group_norm(enc.norm_out, h, gn_impl))
    return _conv(enc.conv_out, h, nhwc)


def decoder_apply(dec: Decoder, z: torch.Tensor, gn_impl: str = "dot",
                  nhwc: bool = False) -> torch.Tensor:
    """(B, Cvae, h, w) -> (B, 3, 16h, 16w), NCHW (``basic_vae.py:210-226``);
    ``nhwc`` (:func:`channels_last_decode`): channels-last ``z`` in, the
    whole decoder over channels-last memory."""
    h = _conv(dec.conv_in, z, nhwc)
    h = resnet_block(dec.mid.block_1, h, gn_impl, nhwc)
    if dec.mid.attn_1 is not None:
        h = attn_block(dec.mid.attn_1, h, gn_impl, nhwc)
    h = resnet_block(dec.mid.block_2, h, gn_impl, nhwc)
    for i in reversed(range(len(dec.up))):
        level = dec.up[i]
        for j, blk in enumerate(level.block):
            h = resnet_block(blk, h, gn_impl, nhwc)
            if len(level.attn):
                h = attn_block(level.attn[j], h, gn_impl, nhwc)
        if level.upsample is not None:
            h = upsample2x(level.upsample, h, nhwc)
    h = gn_nhwc(dec.norm_out, h) if nhwc else swish(group_norm(dec.norm_out, h, gn_impl))
    return _conv(dec.conv_out, h, nhwc)


def _nchw(t: torch.Tensor, gn_impl: str) -> torch.Tensor:
    """NHWC -> NCHW at the networks' boundary. The view keeps NHWC memory
    (channels-last), which a convolution carries to its output. Row 7 reads
    dense NCHW rows, so ``gn_impl="pallas"`` takes a dense copy here, and
    every activation after it is dense NCHW (as the JAX package's "pallas"
    impl first copies to a dense layout)."""
    t = t.permute(0, 3, 1, 2)
    return t.contiguous() if gn_impl == "pallas" else t


def fhat_to_img(vae: VQVAE, f_hat: torch.Tensor, gn_impl: str = "dot") -> torch.Tensor:
    """post_quant_conv + decoder, clamped to [-1, 1] (``vqvae.py:62-63``).
    f_hat: (B, h, w, Cvae) -> image (B, 16h, 16w, 3), in f_hat's dtype."""
    nhwc = channels_last_decode(vae, f_hat, gn_impl)
    z = _conv(vae.post_quant_conv, _nchw(f_hat, gn_impl), nhwc)
    if nhwc:
        z = z.contiguous(memory_format=torch.channels_last)
    img = decoder_apply(vae.decoder, z, gn_impl, nhwc).clamp(-1.0, 1.0)
    return img.permute(0, 2, 3, 1)


def img_to_f(vae: VQVAE, img: torch.Tensor, gn_impl: str = "dot") -> torch.Tensor:
    """Encoder + quant_conv (``vqvae.py:66``): image (B, H, W, 3) -> features
    (B, H/16, W/16, Cvae), in the image's dtype; channels-last through
    conv3xtf32 where :func:`channels_last_encode` says so."""
    nhwc = channels_last_encode(vae, img, gn_impl)
    x = _nchw(img, gn_impl)
    if nhwc:
        x = x.contiguous(memory_format=torch.channels_last)
    f = _conv(vae.quant_conv, encoder_apply(vae.encoder, x, gn_impl, nhwc), nhwc)
    return f.permute(0, 2, 3, 1)


def img_to_idxBl(vae: VQVAE, img: torch.Tensor,
                 v_patch_nums: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """Tokenize (``vqvae.py:65-67``): image (B, H, W, 3) in [-1, 1] -> one
    (B, pn * pn) int64 id tensor per scale. TF32 is off throughout: cuDNN's
    TF32 convolutions would move the features enough to flip nearest-code
    choices against the JAX package's."""
    with fp32_exact():
        idx_bl, _ = q.f_to_idxBl(vae.quantize, vae.cfg, img_to_f(vae, img), v_patch_nums)
    return idx_bl


def make_tokenizer(device="cuda"):
    """Compiled :func:`img_to_idxBl` ``(vae, img) -> [ids per scale]`` on
    ``device``, as the JAX apps jit their tokenizers
    (``var_tpu/apps/inpaint.py:87``, ``smooth.py:60``, ``classify.py:89``):
    on CUDA one CUDA graph an image shape replays the encoder and the
    quantizer's encode loop (``engine/compiled.py``); on the CPU the same
    body runs eagerly."""
    return Compiled(img_to_idxBl, 1, device)


def img_to_fhat(vae: VQVAE, img: torch.Tensor,
                v_patch_nums: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """The accumulated f_hat (B, h, w, Cvae) after each scale of the
    tokenization of ``img`` (``vqvae.py:69-71``), TF32 off as in
    :func:`img_to_idxBl`."""
    with fp32_exact():
        fhats, _ = q.f_to_idxBl(vae.quantize, vae.cfg, img_to_f(vae, img), v_patch_nums,
                                to_fhat=True)
    return fhats


def idxBl_to_img(vae: VQVAE, ms_idx_bl: List[torch.Tensor], same_shape: bool = True,
                 last_one: bool = True):
    """Token pyramid -> image(s) in [-1, 1] (``vqvae.py:77-90``): the last
    f_hat's image, or one per scale."""
    b, c = ms_idx_bl[0].shape[0], vae.cfg.z_channels
    ms_h = []
    for idx in ms_idx_bl:
        pn = int(round(idx.shape[1] ** 0.5))
        ms_h.append(q.embed(vae.quantize, idx).reshape(b, pn, pn, c))
    with fp32_exact():
        fh = q.embed_to_fhat(vae.quantize, vae.cfg, ms_h, all_to_max_scale=same_shape,
                             last_one=last_one)
    if last_one:
        return fhat_to_img(vae, fh)
    return [fhat_to_img(vae, f) for f in fh]


def embed_to_img(vae: VQVAE, ms_h_bhwc: List[torch.Tensor], all_to_max_scale: bool = True,
                 last_one: bool = True):
    """Per-scale (B, pn, pn, Cvae) embeddings -> image(s) in [-1, 1]
    (``vqvae.py:86-90``): the last f_hat's image, or one per scale."""
    with fp32_exact():
        fh = q.embed_to_fhat(vae.quantize, vae.cfg, ms_h_bhwc,
                             all_to_max_scale=all_to_max_scale, last_one=last_one)
    if last_one:
        return fhat_to_img(vae, fh)
    return [fhat_to_img(vae, f) for f in fh]


def img_to_reconstructed_img(vae: VQVAE, img: torch.Tensor,
                             v_patch_nums: Optional[Sequence[int]] = None,
                             last_one: bool = True):
    """Tokenize-and-decode round trip (``vqvae.py:92-98``): image (B, H, W, 3)
    -> the reconstruction from the last f_hat, or one per scale."""
    fhats = img_to_fhat(vae, img, v_patch_nums)
    if last_one:
        return fhat_to_img(vae, fhats[-1])
    return [fhat_to_img(vae, f) for f in fhats]


class VAETrainOutput(NamedTuple):
    recon: torch.Tensor  # (B, H, W, 3), not clamped
    vq_loss: torch.Tensor  # scalar
    hits: torch.Tensor  # (S, V) per-scale codebook hit counts of this batch
    idx_bl: list


def vae_train_forward(vae: VQVAE, img: torch.Tensor, gn_impl: str = "dot") -> VAETrainOutput:
    """Tokenizer-training forward (``vqvae.py:56-59``): encode, quantize with
    the straight-through estimator and the commitment loss, decode. ``img``
    (B, H, W, 3) in [-1, 1]; the reconstruction is NHWC too."""
    f = img_to_f(vae, img, gn_impl)
    res = q.quantizer_forward(vae.quantize, vae.cfg, f)
    z = vae.post_quant_conv(_nchw(res.f_hat, gn_impl))
    recon = decoder_apply(vae.decoder, z, gn_impl).permute(0, 2, 3, 1)
    return VAETrainOutput(recon, res.vq_loss, res.hits, res.idx_bl)
