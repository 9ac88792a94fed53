"""Multi-scale residual vector quantizer (counterpart of
``var_tpu/models/quantizer.py``).

Holds the codebook and the partially shared phi convs under the reference
``VectorQuantizer2`` key names (``quantize.embedding.weight``,
``quantize.quant_resi.qresi_ls.{k}.*``), and the functions of the decode
loop (the phi tick rule, ``apply_phi``, ``embed``,
``get_next_autoregressive_input``) and of tokenization and teacher forcing
(``nearest_code``, ``f_to_idxBl``, ``idxBl_to_var_input``,
``embed_to_fhat``), and of tokenizer training (``quantizer_forward`` with
the straight-through estimator and the commitment loss, ``update_ema_hits``,
``vocab_usage``, the codebook re-init ``eini``). Everything runs in float32,
and the codebook lookups with TF32 off: token choices are discrete. Public
tensors are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from var_tpu_torch.config import VAEConfig
from var_tpu_torch.device import fp32_exact
from var_tpu_torch.ops.resize import resize_area, resize_bicubic


def num_phi(cfg: VAEConfig) -> int:
    if cfg.share_quant_resi == 0:  # non-shared: one phi per scale
        return len(cfg.v_patch_nums)
    return max(cfg.share_quant_resi, 1)


def phi_index(cfg: VAEConfig, si: int, num_scales: Optional[int] = None) -> int:
    """Which phi conv scale ``si`` uses (reference tick rule, quant.py:223-226)."""
    sn = num_scales or len(cfg.v_patch_nums)
    k = num_phi(cfg)
    if k == 1:
        return 0
    half = 1.0 / 3.0 / k if k == 4 else 1.0 / 2.0 / k
    ticks = np.linspace(half, 1.0 - half, k)
    at = si / (sn - 1)
    return int(np.argmin(np.abs(ticks - at)))


class PhiBank(nn.Module):
    """The phi convs under the reference's three key layouts:
    ``quant_resi.{k}`` (not shared), ``quant_resi.qresi`` (one shared) and
    ``quant_resi.qresi_ls.{k}`` (partially shared, the default)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        c = cfg.z_channels
        convs = [nn.Conv2d(c, c, 3, padding=1) for _ in range(num_phi(cfg))]
        if cfg.share_quant_resi == 0:
            for i, conv in enumerate(convs):
                self.add_module(str(i), conv)
        elif cfg.share_quant_resi == 1:
            self.qresi = convs[0]
        else:
            self.qresi_ls = nn.ModuleList(convs)
        self.convs = convs  # plain list: the modules are registered above


class VectorQuantizer2(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.z_channels)
        self.quant_resi = PhiBank(cfg)


def apply_phi(quant: VectorQuantizer2, cfg: VAEConfig, si: int, h: torch.Tensor,
              num_scales: Optional[int] = None) -> torch.Tensor:
    """phi(h) = (1-r)*h + r*conv3x3(h) on NHWC ``h`` (reference ``Phi.forward``)."""
    r = abs(cfg.quant_resi)
    if r <= 1e-6:
        return h
    conv = quant.quant_resi.convs[phi_index(cfg, si, num_scales)]
    with fp32_exact():
        y = F.conv2d(h.permute(0, 3, 1, 2).float(), conv.weight.float(), conv.bias.float(),
                     padding=1)
    return h * (1.0 - r) + y.permute(0, 2, 3, 1) * r


def embed(quant: VectorQuantizer2, idx: torch.Tensor) -> torch.Tensor:
    """Codebook gather: (...,) int -> (..., Cvae)."""
    return F.embedding(idx, quant.embedding.weight)


def get_next_autoregressive_input(
    quant: VectorQuantizer2, cfg: VAEConfig, si: int, f_hat: torch.Tensor,
    h_bhwc: torch.Tensor, v_patch_nums: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode-loop step (``quant.py:187-196``): ``h_bhwc`` is the
    (B, pn, pn, C) embedding of this scale's tokens. Returns (new f_hat,
    next scale's quantizer-space input), both NHWC float32."""
    pns = tuple(v_patch_nums or cfg.v_patch_nums)
    sn = len(pns)
    hw = pns[-1]
    if si != sn - 1:
        h = apply_phi(quant, cfg, si, resize_bicubic(h_bhwc, (hw, hw)), sn)
        f_hat = f_hat + h
        nxt = pns[si + 1]
        return f_hat, resize_area(f_hat, (nxt, nxt))
    f_hat = f_hat + apply_phi(quant, cfg, si, h_bhwc, sn)
    return f_hat, f_hat


def nearest_code(quant: VectorQuantizer2, z_nc: torch.Tensor, using_znorm: bool) -> torch.Tensor:
    """Nearest codebook index of each row of ``z_nc`` (N, C) -> (N,) int64:
    argmin of |z|^2 + |e|^2 - 2 z e^T in float32 (``quant.py:155-157``), or
    the cosine argmax with ``using_znorm`` (``quant.py:151-153``)."""
    emb = quant.embedding.weight.float()
    z = z_nc.float()
    with fp32_exact():
        if using_znorm:
            zn = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-12)
            en = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-12)
            return torch.argmax(zn @ en.T, dim=1)
        d = (z * z).sum(1, keepdim=True) + (emb * emb).sum(1)
        return torch.argmin(torch.addmm(d, z, emb.T, beta=1.0, alpha=-2.0), dim=1)


def f_to_idxBl(quant: VectorQuantizer2, cfg: VAEConfig, f_bhwc: torch.Tensor,
               v_patch_nums: Optional[Sequence[int]] = None, to_fhat: bool = False):
    """Encode a feature map into the token pyramid (``quant.py:135-166``).
    Returns (list per scale, final f_hat): (B, pn * pn) token ids, or the
    (B, H, W, C) accumulated f_hat after each scale with ``to_fhat``."""
    pns = tuple(v_patch_nums or cfg.v_patch_nums)
    b, h, w, c = f_bhwc.shape
    if not pns[-1] == h == w:
        raise ValueError(f"last patch_num {pns[-1]} != feature size {h}x{w}")
    f_rest = f_bhwc.float()
    f_hat = torch.zeros_like(f_rest)
    out = []
    for si, pn in enumerate(pns):
        z = resize_area(f_rest, (pn, pn))
        idx = nearest_code(quant, z.reshape(-1, c), cfg.using_znorm)
        h_bhwc = resize_bicubic(embed(quant, idx).reshape(b, pn, pn, c), (h, w))
        h_bhwc = apply_phi(quant, cfg, si, h_bhwc, len(pns))
        f_hat = f_hat + h_bhwc
        f_rest = f_rest - h_bhwc
        out.append(f_hat if to_fhat else idx.reshape(b, pn * pn))
    return out, f_hat


def idxBl_to_var_input(quant: VectorQuantizer2, cfg: VAEConfig,
                       gt_idx_bl: List[torch.Tensor]) -> torch.Tensor:
    """Teacher-forcing input of VAR training (``quant.py:169-184``): the
    input at scale k + 1 is the accumulated f_hat of scales <= k,
    area-resized to pn_{k+1}. Returns (B, L - first_l, Cvae) float32."""
    pns = cfg.v_patch_nums
    b, c, hw, sn = gt_idx_bl[0].shape[0], cfg.z_channels, pns[-1], len(pns)
    f_hat = torch.zeros(b, hw, hw, c, device=gt_idx_bl[0].device)
    segs = []
    for si in range(sn - 1):
        pn, nxt = pns[si], pns[si + 1]
        h = resize_bicubic(embed(quant, gt_idx_bl[si]).reshape(b, pn, pn, c), (hw, hw))
        f_hat = f_hat + apply_phi(quant, cfg, si, h, sn)
        segs.append(resize_area(f_hat, (nxt, nxt)).reshape(b, nxt * nxt, c))
    return torch.cat(segs, dim=1)


def embed_to_fhat(quant: VectorQuantizer2, cfg: VAEConfig, ms_h_bhwc: List[torch.Tensor],
                  all_to_max_scale: bool = True, last_one: bool = False):
    """Sum per-scale (B, pn, pn, C) embeddings into f_hat (``quant.py:107-133``):
    each upsampled to the last scale and passed through its phi, or with
    ``all_to_max_scale=False`` the experimental progressive form that grows
    f_hat scale by scale. Returns the f_hat after every scale, or the last."""
    pns = cfg.v_patch_nums
    sn, hw = len(pns), pns[-1]
    b = ms_h_bhwc[0].shape[0]
    dev = ms_h_bhwc[0].device
    outs = []
    if all_to_max_scale:
        f_hat = torch.zeros(b, hw, hw, cfg.z_channels, device=dev)
        for si in range(sn):
            h = ms_h_bhwc[si]
            if si < sn - 1:
                h = resize_bicubic(h, (hw, hw))
            f_hat = f_hat + apply_phi(quant, cfg, si, h, sn)
            outs.append(f_hat)
    else:
        f_hat = torch.zeros(b, pns[0], pns[0], cfg.z_channels, device=dev)
        for si, pn in enumerate(pns):
            f_hat = resize_bicubic(f_hat, (pn, pn))
            f_hat = f_hat + apply_phi(quant, cfg, si, ms_h_bhwc[si], sn)
            outs.append(f_hat)
    return outs[-1] if last_one else outs


# ---------------------------------------------------------------------------
# tokenizer training (straight-through estimator + commitment loss)


class QuantResult(NamedTuple):
    f_hat: torch.Tensor  # (B, H, W, C), straight-through gradient to f
    vq_loss: torch.Tensor  # scalar
    hits: torch.Tensor  # (S, V) per-scale codebook hit counts of this batch
    idx_bl: List[torch.Tensor]


def quantizer_forward(quant: VectorQuantizer2, cfg: VAEConfig, f_bhwc: torch.Tensor) -> QuantResult:
    """Training forward (``quant.py:52-104``): f_hat with the straight-through
    estimator ``sg(f_hat) - sg(f) + f`` and the commitment loss
    ``mean_si [beta * mse(sg(f_hat), f) + mse(f_hat, sg(f))]``; the residual
    is updated with the detached code. Returns raw per-scale hit counts:
    the EMA of usage is the trainer's state (``engine/vae_trainer.py``).
    Hits are counted with ``index_add_`` of ones, exact in float32, since
    ``torch.bincount`` reads its input's range back to the host on a GPU."""
    f = f_bhwc.float()
    b, h, w, c = f.shape
    f_ng = f.detach()
    f_rest = f_ng
    f_hat = torch.zeros_like(f_ng)
    pns = cfg.v_patch_nums
    sn = len(pns)
    vq_loss = 0.0
    hits, idx_bl = [], []
    for si, pn in enumerate(pns):
        z = resize_area(f_rest, (pn, pn))
        idx = nearest_code(quant, z.reshape(-1, c), cfg.using_znorm)
        idx_bl.append(idx.reshape(b, pn * pn))
        hits.append(torch.zeros(cfg.vocab_size, device=f.device).index_add_(
            0, idx, torch.ones(idx.shape, device=f.device)))
        h_b = resize_bicubic(embed(quant, idx).reshape(b, pn, pn, c), (h, w))
        h_b = apply_phi(quant, cfg, si, h_b, sn)
        f_hat = f_hat + h_b
        f_rest = f_rest - h_b.detach()
        # beta * |sg(f_hat) - f|^2 pulls the encoder toward the codes;
        # |f_hat - sg(f)|^2 trains the codebook and phi (quant.py:95)
        vq_loss = vq_loss + cfg.beta * F.mse_loss(f_hat.detach(), f) + F.mse_loss(f_hat, f_ng)
    f_hat_ste = f_hat.detach() - f_ng + f  # quant.py:98
    return QuantResult(f_hat_ste, vq_loss / sn, torch.stack(hits), idx_bl)


def update_ema_hits(ema_sv: torch.Tensor, hits_sv: torch.Tensor, record_hit: int) -> torch.Tensor:
    """EMA codebook-usage update (``quant.py:88-93``): the first recorded
    step replaces outright, then decay 0.9 until 100 recorded steps and 0.99
    after. ``record_hit`` is a Python int, so the update reads nothing back
    from the device. ``1 - decay`` is taken in float32, as JAX takes it."""
    decay = np.float32(0.0 if record_hit == 0 else (0.9 if record_hit < 100 else 0.99))
    return ema_sv * float(decay) + hits_sv * float(np.float32(1.0) - decay)


def vocab_usage(ema_sv: torch.Tensor, cfg: VAEConfig, world_size: int, tokens_per_img: int,
                batch: int) -> torch.Tensor:
    """(S,) percent of the codebook in live use per scale (``quant.py:100-102``)."""
    margin = world_size * (batch * tokens_per_img) / cfg.vocab_size * 0.08
    return (ema_sv >= margin).float().mean(1) * 100.0


@torch.no_grad()
def eini(quant: VectorQuantizer2, generator: torch.Generator, value: float) -> VectorQuantizer2:
    """Codebook re-init in place (``quant.py:44-46``): value > 0 draws a
    normal of std ``value`` truncated to [-2, 2] (torch's ``trunc_normal_``
    bounds, which the JAX package reproduces as a standard normal truncated
    at +-2 / value, times value); value < 0 a uniform on +-|value| / V;
    0 leaves it. Draws from ``generator``: not JAX's stream."""
    emb = quant.embedding.weight
    if value > 0:
        torch.nn.init.trunc_normal_(emb, std=value, a=-2.0, b=2.0, generator=generator)
    elif value < 0:
        v = emb.shape[0]
        emb.uniform_(-abs(value) / v, abs(value) / v, generator=generator)
    return quant
