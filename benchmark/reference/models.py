"""The plain reference of VAR: the VQVAE tokenizer (encoder, multi-scale
residual quantizer, decoder) and the AdaLN transformer, in plain PyTorch.

Written from the published description (arXiv:2404.02905) and the
reference repository's modules (``models/basic_vae.py``, ``vqvae.py``,
``quant.py``, ``basic_var.py``, ``var.py``), under its state-dict names so
that one dict of weights loads here and into the program. It imports
nothing of the program: every derived quantity (f_hat, the next-scale
inputs, the AdaLN parameters, the token pyramid) is worked out here again.

Everything runs in float32 with TF32 off (:func:`exact`). A ``Prec`` turns
the inputs of every matrix product and convolution into another precision
and back (the control of the benchmark's check); ``FP32`` leaves them be.
Departures from the reference repository: none in the mathematics; the
transformer attends through one dense block-causal softmax, which is the
cached decode's attention written over the whole sequence.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@contextlib.contextmanager
def exact():
    """Full float32 matrix products and convolutions (no TF32) inside."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


class Prec:
    """Float32 throughout: operands pass unchanged."""

    name = "float32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x


class FakeFP8(Prec):
    """Operands of products rounded to float8 e4m3 with one scale a tensor
    (amax / 448), then computed in float32: the nearest precision below
    bfloat16 that a later change could be tempted by. The rounding is
    straight-through under autograd, so a backward stays float32."""

    name = "float8_e4m3"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
            r = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return x + (r - x).detach() if x.requires_grad else r


FP32 = Prec()
PRECISIONS = {"float32": FP32, "float8_e4m3": FakeFP8()}


# ---------------------------------------------------------------------------
# configuration


@dataclass(frozen=True)
class Sizes:
    """The sizes of one configuration file (``benchmark/configs/*.json``)."""

    depth: int
    embed_dim: int
    num_heads: int
    mlp_ratio: float
    num_classes: int
    vocab_size: int
    z_channels: int
    patch_nums: Tuple[int, ...]
    attn_l2_norm: bool
    shared_aln: bool
    norm_eps: float
    cond_drop_rate: float
    drop_path_rate: float
    ch: int
    ch_mult: Tuple[int, ...]
    num_res_blocks: int
    share_quant_resi: int
    quant_resi: float
    using_sa: bool
    using_mid_sa: bool

    @classmethod
    def from_config(cls, cfg: dict) -> "Sizes":
        vae = cfg["vae"]
        return cls(depth=cfg["depth"], embed_dim=cfg["embed_dim"], num_heads=cfg["num_heads"],
                   mlp_ratio=cfg["mlp_ratio"], num_classes=cfg["num_classes"],
                   vocab_size=cfg["vocab_size"], z_channels=cfg["z_channels"],
                   patch_nums=tuple(cfg["patch_nums"]), attn_l2_norm=cfg["attn_l2_norm"],
                   shared_aln=cfg["shared_aln"], norm_eps=cfg["norm_eps"],
                   cond_drop_rate=cfg["cond_drop_rate"], drop_path_rate=cfg["drop_path_rate"],
                   ch=vae["ch"], ch_mult=tuple(vae["ch_mult"]),
                   num_res_blocks=vae["num_res_blocks"],
                   share_quant_resi=vae["share_quant_resi"], quant_resi=vae["quant_resi"],
                   using_sa=vae["using_sa"], using_mid_sa=vae["using_mid_sa"])

    @property
    def seq_len(self) -> int:
        return sum(p * p for p in self.patch_nums)

    @property
    def ends(self) -> Tuple[int, ...]:
        out, cur = [], 0
        for p in self.patch_nums:
            cur += p * p
            out.append(cur)
        return tuple(out)

    @property
    def reso(self) -> int:
        return self.patch_nums[-1] * 2 ** (len(self.ch_mult) - 1)


# ---------------------------------------------------------------------------
# modules under the reference names


def _gn(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1, self.conv1 = _gn(cin), nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2, self.conv2 = _gn(cout), nn.Conv2d(cout, cout, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm, self.qkv, self.proj_out = _gn(c), nn.Conv2d(c, 3 * c, 1), nn.Conv2d(c, c, 1)


class _Conv(nn.Module):
    def __init__(self, c: int, stride: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=stride, padding=1 if stride == 1 else 0)


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block, self.attn = nn.ModuleList(), nn.ModuleList()


class _Mid(nn.Module):
    def __init__(self, c: int, sa: bool):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c) if sa else None
        self.block_2 = ResnetBlock(c, c)


class Encoder(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        n = len(s.ch_mult)
        in_mult = (1,) + s.ch_mult
        self.conv_in = nn.Conv2d(3, s.ch, 3, padding=1)
        self.down = nn.ModuleList()
        for i in range(n):
            lv = _Level()
            cin, cout = s.ch * in_mult[i], s.ch * s.ch_mult[i]
            for _ in range(s.num_res_blocks):
                lv.block.append(ResnetBlock(cin, cout))
                cin = cout
                if i == n - 1 and s.using_sa:
                    lv.attn.append(AttnBlock(cout))
            lv.downsample = _Conv(cout, 2) if i != n - 1 else None
            self.down.append(lv)
        cm = s.ch * s.ch_mult[-1]
        self.mid = _Mid(cm, s.using_mid_sa)
        self.norm_out = _gn(cm)
        self.conv_out = nn.Conv2d(cm, s.z_channels, 3, padding=1)


class Decoder(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        n = len(s.ch_mult)
        cin = s.ch * s.ch_mult[-1]
        self.conv_in = nn.Conv2d(s.z_channels, cin, 3, padding=1)
        self.mid = _Mid(cin, s.using_mid_sa)
        levels = [None] * n
        for i in reversed(range(n)):
            lv = _Level()
            cout = s.ch * s.ch_mult[i]
            for _ in range(s.num_res_blocks + 1):
                lv.block.append(ResnetBlock(cin, cout))
                cin = cout
                if i == n - 1 and s.using_sa:
                    lv.attn.append(AttnBlock(cout))
            lv.upsample = _Conv(cout, 1) if i != 0 else None
            levels[i] = lv
        self.up = nn.ModuleList(levels)
        self.norm_out = _gn(cin)
        self.conv_out = nn.Conv2d(cin, 3, 3, padding=1)


class QuantResi(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        k = len(s.patch_nums) if s.share_quant_resi == 0 else max(s.share_quant_resi, 1)
        convs = [nn.Conv2d(s.z_channels, s.z_channels, 3, padding=1) for _ in range(k)]
        if s.share_quant_resi == 0:
            for i, c in enumerate(convs):
                self.add_module(str(i), c)
        elif s.share_quant_resi == 1:
            self.qresi = convs[0]
        else:
            self.qresi_ls = nn.ModuleList(convs)
        self.convs = convs


class Quantizer(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        self.embedding = nn.Embedding(s.vocab_size, s.z_channels)
        self.quant_resi = QuantResi(s)


class VQVAE(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        self.sizes = s
        self.encoder = Encoder(s)
        self.quantize = Quantizer(s)
        self.quant_conv = nn.Conv2d(s.z_channels, s.z_channels, 3, padding=1)
        self.post_quant_conv = nn.Conv2d(s.z_channels, s.z_channels, 3, padding=1)
        self.decoder = Decoder(s)


class Block(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        c, h = s.embed_dim, s.num_heads
        self.attn = nn.Module()
        self.attn.mat_qkv = nn.Linear(c, 3 * c, bias=False)
        self.attn.q_bias = nn.Parameter(torch.zeros(c))
        self.attn.v_bias = nn.Parameter(torch.zeros(c))
        if s.attn_l2_norm:
            self.attn.scale_mul_1H11 = nn.Parameter(torch.zeros(1, h, 1, 1))
        self.attn.proj = nn.Linear(c, c)
        hidden = round(c * s.mlp_ratio)
        self.ffn = nn.Module()
        self.ffn.fc1, self.ffn.fc2 = nn.Linear(c, hidden), nn.Linear(hidden, c)
        if s.shared_aln:
            self.ada_gss = nn.Parameter(torch.zeros(1, 1, 6, c))
        else:
            self.ada_lin = nn.Sequential(nn.SiLU(), nn.Linear(c, 6 * c))


class VAR(nn.Module):
    def __init__(self, s: Sizes):
        super().__init__()
        self.sizes = s
        c = s.embed_dim
        self.word_embed = nn.Linear(s.z_channels, c)
        self.class_emb = nn.Embedding(s.num_classes + 1, c)
        self.pos_start = nn.Parameter(torch.zeros(1, s.patch_nums[0] ** 2, c))
        self.pos_1LC = nn.Parameter(torch.zeros(1, s.seq_len, c))
        self.lvl_embed = nn.Embedding(len(s.patch_nums), c)
        if s.shared_aln:
            self.shared_ada_lin = nn.Sequential(nn.SiLU(), nn.Linear(c, 6 * c))
        self.blocks = nn.ModuleList([Block(s) for _ in range(s.depth)])
        self.head_nm = nn.Module()
        self.head_nm.ada_lin = nn.Sequential(nn.SiLU(), nn.Linear(c, 2 * c))
        self.head = nn.Linear(c, s.vocab_size)


def build(sizes: Sizes, state_dict, device) -> Tuple[VQVAE, VAR]:
    """The two reference networks on ``device``, holding float32 copies of
    ``state_dict`` (names: the VQVAE's under ``vae_local.``)."""
    with torch.device("meta"):
        vae, var = VQVAE(sizes), VAR(sizes)
    vae, var = vae.to_empty(device=device), var.to_empty(device=device)
    pre = "vae_local."
    vae.load_state_dict({k[len(pre):]: v.float() for k, v in state_dict.items()
                         if k.startswith(pre)})
    var.load_state_dict({k: v.float() for k, v in state_dict.items() if not k.startswith(pre)})
    return vae, var


# ---------------------------------------------------------------------------
# the VQVAE


def _conv(m: nn.Conv2d, x: torch.Tensor, p: Prec) -> torch.Tensor:
    return F.conv2d(p.q(x), p.q(m.weight), m.bias, m.stride, m.padding)


def _resnet(b: ResnetBlock, x, p: Prec):
    h = _conv(b.conv1, F.silu(F.group_norm(x, 32, b.norm1.weight, b.norm1.bias, 1e-6)), p)
    h = _conv(b.conv2, F.silu(F.group_norm(h, 32, b.norm2.weight, b.norm2.bias, 1e-6)), p)
    return (x if b.nin_shortcut is None else _conv(b.nin_shortcut, x, p)) + h


def _attn(b: AttnBlock, x, p: Prec):
    n, c, h, w = x.shape
    qkv = _conv(b.qkv, F.group_norm(x, 32, b.norm.weight, b.norm.bias, 1e-6), p)
    q, k, v = qkv.reshape(n, 3, c, h * w).unbind(1)
    a = torch.softmax(torch.bmm(p.q(q).transpose(1, 2), p.q(k)) * c ** -0.5, dim=-1)
    return x + _conv(b.proj_out, torch.bmm(p.q(v), p.q(a).transpose(1, 2)).reshape(n, c, h, w), p)


def encode(vae: VQVAE, img_nhwc: torch.Tensor, p: Prec = FP32) -> torch.Tensor:
    """Image (B, H, W, 3) in [-1, 1] -> features (B, h, w, Cvae)."""
    e = vae.encoder
    h = _conv(e.conv_in, img_nhwc.permute(0, 3, 1, 2).float(), p)
    for lv in e.down:
        for j, blk in enumerate(lv.block):
            h = _resnet(blk, h, p)
            if len(lv.attn):
                h = _attn(lv.attn[j], h, p)
        if lv.downsample is not None:
            h = _conv(lv.downsample.conv, F.pad(h, (0, 1, 0, 1)), p)
    h = _resnet(e.mid.block_1, h, p)
    if e.mid.attn_1 is not None:
        h = _attn(e.mid.attn_1, h, p)
    h = _resnet(e.mid.block_2, h, p)
    h = _conv(e.conv_out, F.silu(F.group_norm(h, 32, e.norm_out.weight, e.norm_out.bias, 1e-6)), p)
    return _conv(vae.quant_conv, h, p).permute(0, 2, 3, 1)


def decode(vae: VQVAE, f_hat: torch.Tensor, p: Prec = FP32) -> torch.Tensor:
    """f_hat (B, h, w, Cvae) -> image (B, H, W, 3) in [0, 1]."""
    d = vae.decoder
    h = _conv(d.conv_in, _conv(vae.post_quant_conv, f_hat.permute(0, 3, 1, 2).float(), p), p)
    h = _resnet(d.mid.block_1, h, p)
    if d.mid.attn_1 is not None:
        h = _attn(d.mid.attn_1, h, p)
    h = _resnet(d.mid.block_2, h, p)
    for i in reversed(range(len(d.up))):
        lv = d.up[i]
        for j, blk in enumerate(lv.block):
            h = _resnet(blk, h, p)
            if len(lv.attn):
                h = _attn(lv.attn[j], h, p)
        if lv.upsample is not None:
            h = _conv(lv.upsample.conv, F.interpolate(h, scale_factor=2.0, mode="nearest"), p)
    h = _conv(d.conv_out, F.silu(F.group_norm(h, 32, d.norm_out.weight, d.norm_out.bias, 1e-6)), p)
    return h.clamp(-1.0, 1.0).permute(0, 2, 3, 1) * 0.5 + 0.5


def to_uint8(img01: torch.Tensor) -> torch.Tensor:
    """Images in [0, 1] -> uint8 levels, truncated as the FID protocol's
    ``np.clip(x * 255, 0, 255).astype(np.uint8)`` truncates."""
    return (img01 * 255).clamp(0, 255).to(torch.uint8)


def _resize(x_nhwc: torch.Tensor, hw: int, mode: str) -> torch.Tensor:
    if x_nhwc.shape[1] == hw:
        return x_nhwc
    kw = {"align_corners": False} if mode == "bicubic" else {}
    y = F.interpolate(x_nhwc.permute(0, 3, 1, 2), size=(hw, hw), mode=mode, **kw)
    return y.permute(0, 2, 3, 1)


def _phi_index(s: Sizes, si: int) -> int:
    k = len(s.patch_nums) if s.share_quant_resi == 0 else max(s.share_quant_resi, 1)
    if k == 1:
        return 0
    half = 1.0 / 3.0 / k if k == 4 else 1.0 / 2.0 / k
    return int(np.argmin(np.abs(np.linspace(half, 1.0 - half, k) - si / (len(s.patch_nums) - 1))))


def _phi(vae: VQVAE, si: int, h: torch.Tensor, p: Prec) -> torch.Tensor:
    """(1 - r) h + r conv3x3(h), the conv the scale's tick picks."""
    r = abs(vae.sizes.quant_resi)
    conv = vae.quantize.quant_resi.convs[_phi_index(vae.sizes, si)]
    y = _conv(conv, h.permute(0, 3, 1, 2), p).permute(0, 2, 3, 1)
    return h * (1.0 - r) + y * r


def tokenize(vae: VQVAE, f: torch.Tensor, p: Prec = FP32) -> List[torch.Tensor]:
    """Features (B, h, w, Cvae) -> the token pyramid: per scale, the nearest
    code of the area-downsampled residual; the residual then loses that
    code's bicubic upsample through phi."""
    s = vae.sizes
    b, hw = f.shape[0], f.shape[1]
    emb = vae.quantize.embedding.weight
    rest, out = f.float(), []
    for si, pn in enumerate(s.patch_nums):
        z = _resize(rest, pn, "area").reshape(-1, s.z_channels)
        d = (z * z).sum(1, keepdim=True) + (emb * emb).sum(1) - 2.0 * (p.q(z) @ p.q(emb).T)
        idx = d.argmin(1)
        h = _phi(vae, si, _resize(emb[idx].reshape(b, pn, pn, -1), hw, "bicubic"), p)
        rest = rest - h
        out.append(idx.reshape(b, pn * pn))
    return out


def pyramid(vae: VQVAE, tokens_bl: torch.Tensor, p: Prec = FP32):
    """Token ids (B, L) -> (f_hat (B, h, w, Cvae), the next-scale inputs
    (B, L - first_l, Cvae)): f_hat gathers every scale's code through phi at
    the last scale's size; scale k + 1 reads f_hat of scales <= k,
    area-downsampled to its size."""
    s = vae.sizes
    b, hw = tokens_bl.shape[0], s.patch_nums[-1]
    emb = vae.quantize.embedding.weight
    f_hat = torch.zeros(b, hw, hw, s.z_channels, device=tokens_bl.device)
    nxt, cur = [], 0
    for si, pn in enumerate(s.patch_nums):
        h = emb[tokens_bl[:, cur:cur + pn * pn]].reshape(b, pn, pn, -1)
        cur += pn * pn
        f_hat = f_hat + _phi(vae, si, _resize(h, hw, "bicubic"), p)
        if si + 1 < len(s.patch_nums):
            q = s.patch_nums[si + 1]
            nxt.append(_resize(f_hat, q, "area").reshape(b, q * q, -1))
    return f_hat, torch.cat(nxt, 1)


# ---------------------------------------------------------------------------
# the transformer


def _lin(m: nn.Linear, x: torch.Tensor, p: Prec, bias=True) -> torch.Tensor:
    return F.linear(p.q(x), p.q(m.weight), m.bias if bias else None)


def _ln(x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def block_mask(s: Sizes, device) -> torch.Tensor:
    """(L, L) bool: position i sees j when j's scale is not after i's."""
    lvl = torch.cat([torch.full((pn * pn,), i, device=device)
                     for i, pn in enumerate(s.patch_nums)])
    return lvl[None, :] <= lvl[:, None]


def forward(var: VAR, labels: torch.Tensor, x_in: torch.Tensor, p: Prec = FP32,
            drop_path: Sequence = ()) -> torch.Tensor:
    """Teacher-forced logits (B, L, V) for class ``labels`` (B,) and the
    next-scale inputs ``x_in`` (B, L - first_l, Cvae). ``drop_path``: per
    block None or two (B, 1, 1) keep masks of its residual branches."""
    s = var.sizes
    b, c, h = labels.shape[0], s.embed_dim, s.num_heads
    d, L = c // h, s.seq_len
    cond = var.class_emb.weight[labels]
    lvl = torch.cat([torch.full((pn * pn,), i, dtype=torch.long, device=labels.device)
                     for i, pn in enumerate(s.patch_nums)])
    x = torch.cat([(cond[:, None] + var.pos_start).expand(b, -1, c),
                   _lin(var.word_embed, x_in.float(), p)], 1)
    x = x + var.lvl_embed.weight[lvl][None] + var.pos_1LC
    mask = block_mask(s, labels.device)
    cs = F.silu(cond)
    shared = _lin(var.shared_ada_lin[1], cs, p).reshape(b, 1, 6, c) if s.shared_aln else None
    for i, blk in enumerate(var.blocks):
        ada = (blk.ada_gss + shared) if s.shared_aln else \
            _lin(blk.ada_lin[1], cs, p).reshape(b, 1, 6, c)
        g1, g2, s1, s2, sh1, sh2 = ada.unbind(2)
        a = blk.attn
        y = _ln(x, s.norm_eps) * (s1 + 1) + sh1
        qkv = _lin(a.mat_qkv, y, p, bias=False) + torch.cat(
            [a.q_bias, torch.zeros_like(a.q_bias), a.v_bias])
        q, k, v = qkv.reshape(b, L, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, L, d)
        if s.attn_l2_norm:
            sm = torch.exp(a.scale_mul_1H11.clamp(max=math.log(100.0)))
            q, k, scale = F.normalize(q, dim=-1) * sm, F.normalize(k, dim=-1), 1.0
        else:
            scale = 0.25 / math.sqrt(d)
        att = (p.q(q) @ p.q(k).transpose(-1, -2)) * scale
        att = torch.softmax(att.masked_fill(~mask, float("-inf")), -1)
        o = (p.q(att) @ p.q(v)).transpose(1, 2).reshape(b, L, c)
        o = _lin(a.proj, o, p) * g1
        if i < len(drop_path) and drop_path[i] is not None:
            o = o * drop_path[i][0]
        x = x + o
        y = _ln(x, s.norm_eps) * (s2 + 1) + sh2
        o = _lin(blk.ffn.fc2, F.gelu(_lin(blk.ffn.fc1, y, p), approximate="tanh"), p) * g2
        if i < len(drop_path) and drop_path[i] is not None:
            o = o * drop_path[i][1]
        x = x + o
    sc, sh = _lin(var.head_nm.ada_lin[1], cs, p).reshape(b, 1, 2, c).unbind(2)
    return _lin(var.head, _ln(x, s.norm_eps) * (sc + 1) + sh, p)


def cfg_logits(var: VAR, vae: VQVAE, labels: torch.Tensor, tokens_bl: torch.Tensor,
               cfg: float, p: Prec = FP32) -> torch.Tensor:
    """Classifier-free-guided logits (B, L, V) at every position of the
    served tokens: the conditional and the unconditional (class
    ``num_classes``) pass over the same inputs, mixed at scale k by
    t = cfg * k / (S - 1) as (1 + t) cond - t uncond."""
    s = var.sizes
    _, x_in = pyramid(vae, tokens_bl, p)
    both = forward(var, torch.cat([labels, torch.full_like(labels, s.num_classes)]),
                   torch.cat([x_in, x_in]), p)
    b = labels.shape[0]
    t = torch.cat([torch.full((pn * pn,), cfg * i / (len(s.patch_nums) - 1),
                              device=labels.device) for i, pn in enumerate(s.patch_nums)])
    t = t[None, :, None]
    return (1 + t) * both[:b] - t * both[b:]
