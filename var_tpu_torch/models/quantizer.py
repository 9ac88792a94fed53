"""Multi-scale residual vector quantizer (counterpart of
``var_tpu/models/quantizer.py``).

Holds the codebook and the partially shared phi convs under the reference
``VectorQuantizer2`` key names (``quantize.embedding.weight``,
``quantize.quant_resi.qresi_ls.{k}.*``), and the functions of the decode
loop (the phi tick rule, ``apply_phi``, ``embed``,
``get_next_autoregressive_input``) and of tokenization and teacher forcing
(``nearest_code``, ``f_to_idxBl``, ``idxBl_to_var_input``). Everything runs
in float32 with TF32 off: token choices are discrete. Public tensors are
NHWC, as in the JAX package. ``quantizer_forward`` (tokenizer training) is
not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
