"""Scale-by-scale CFG decoding (counterpart of ``var_tpu/engine/sampler.py``).

Reproduces ``VAR.autoregressive_infer_cfg`` (reference
``models/var.py:126-190``), class-conditional branch:

* the batch is doubled (cond | uncond, the unconditional class being
  ``num_classes``); the guidance weight ramps with scale,
  t = cfg * si / (S - 1), mixed before the fp32 head;
* per scale: the transformer stage over the current token map with the
  in-place KV cache, logits, top-k/top-p sampling through the bound kernel
  (or gumbel-softmax codebook mixing with ``more_smooth``), the quantizer's
  residual update, and the next scale's input through ``word_embed`` in
  float32, tiled x2;
* finally the VQVAE decoder renders f_hat.

Public outputs keep the JAX layouts: image (B, H, W, 3) in [0, 1], tokens
(B, L), f_hat (B, h, w, Cvae). Inpainting, editing and ``kv_window``
pruning belong to a later slice of the port and raise here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from var_tpu_torch.device import resolve_device
from var_tpu_torch.models import quantizer as q
from var_tpu_torch.models import vae as vae_mod
from var_tpu_torch.models import var as var_mod
from var_tpu_torch.ops.sampling import gumbel_softmax, sample_with_top_k_top_p


class DecodeResult(NamedTuple):
    image: torch.Tensor  # (B, H, W, 3) in [0, 1], float32
    tokens: torch.Tensor  # (B, L) int64
    f_hat: torch.Tensor  # (B, h, w, Cvae) float32


def _unported(gt_tokens, keep_mask, edit_mask, kv_window) -> None:
    if any(a is not None for a in (gt_tokens, keep_mask, edit_mask, kv_window)):
        raise NotImplementedError(
            "inpainting/editing (gt_tokens, keep_mask, edit_mask) and kv_window "
            "are not ported yet")


def decode_tokens_cfg(
    var: var_mod.VAR,
    vae: vae_mod.VQVAE,
    label_b: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    cfg_scale: float = 1.5,
    top_k: int = 0,
    top_p: float = 0.0,
    more_smooth: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    gt_tokens=None,
    keep_mask=None,
    edit_mask=None,
    kv_window=None,
):
    """Transformer half of :func:`decode_cfg` -> (tokens (B, L), f_hat)."""
    _unported(gt_tokens, keep_mask, edit_mask, kv_window)
    var_cfg, vae_cfg = var.cfg, vae.cfg
    b = label_b.shape[0]
    pns = var_cfg.patch_nums
    sn = len(pns)
    quant = vae.quantize
    device = var.pos_1LC.device

    labels2 = torch.cat([label_b, torch.full_like(label_b, var_cfg.num_classes)])
    cond_bd = var.class_emb.weight[labels2]  # (2B, C) float32
    ctx = var_mod.cond_context(var, cond_bd, dtype)
    lvl_pos = var_mod.lvl_pos_embed(var)  # (1, L, C)
    sos = cond_bd[:, None, :] + var.pos_start
    ntm = sos + lvl_pos[:, :var_cfg.first_l]  # (2B, first_l, C)

    f_hat = torch.zeros(b, pns[-1], pns[-1], vae_cfg.z_channels, device=device)
    cache = var_mod.init_prealloc_caches(var_cfg, 2 * b, dtype, device)
    cur = 0
    token_segs = []
    for si, pn in enumerate(pns):
        ratio = si / var_cfg.num_stages_minus_1
        x, cache = var_mod.transformer_stage(var, ntm, ctx, cache, dtype)
        lg = var_mod.get_logits_cfg(var, x, cond_bd, cfg_scale * ratio)
        idx = sample_with_top_k_top_p(lg, top_k=top_k, top_p=top_p, generator=generator)
        token_segs.append(idx)
        if more_smooth:  # gumbel-softmax codebook mixing (var.py:178-180)
            gum_t = max(0.27 * (1 - ratio * 0.95), 0.005)
            soft = gumbel_softmax(lg * (1.0 + ratio), tau=gum_t, generator=generator)
            h = soft @ quant.embedding.weight.float()
        else:
            h = q.embed(quant, idx)
        h = h.reshape(b, pn, pn, vae_cfg.z_channels)
        f_hat, nxt = q.get_next_autoregressive_input(quant, vae_cfg, si, f_hat, h, pns)
        cur += pn * pn
        if si != sn - 1:
            nseg = pns[si + 1] ** 2
            ntm = var_mod._linear(var.word_embed, nxt.reshape(b, nseg, -1).float())
            ntm = ntm + lvl_pos[:, cur:cur + nseg]
            ntm = ntm.repeat(2, 1, 1)  # CFG batch doubling (var.py:187)
    return torch.cat(token_segs, dim=1), f_hat


def render_fhat(vae: vae_mod.VQVAE, f_hat: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """VQVAE render half: f_hat -> images in [0, 1]; the decoder runs in the
    compute dtype (the reference decodes under fp16 autocast)."""
    img = vae_mod.fhat_to_img(vae, f_hat.to(dtype)).float()
    return img * 0.5 + 0.5


def decode_cfg(
    var: var_mod.VAR,
    vae: vae_mod.VQVAE,
    label_b: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    cfg_scale: float = 1.5,
    top_k: int = 0,
    top_p: float = 0.0,
    more_smooth: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    gt_tokens=None,
    keep_mask=None,
    edit_mask=None,
    kv_window=None,
) -> DecodeResult:
    """Class-conditional CFG decode of ``label_b`` (B,) int -> DecodeResult."""
    tokens, f_hat = decode_tokens_cfg(
        var, vae, label_b, generator, cfg_scale=cfg_scale, top_k=top_k, top_p=top_p,
        more_smooth=more_smooth, dtype=dtype, gt_tokens=gt_tokens, keep_mask=keep_mask,
        edit_mask=edit_mask, kv_window=kv_window)
    return DecodeResult(render_fhat(vae, f_hat, dtype), tokens, f_hat)


def _on(module: torch.nn.Module, dev: torch.device) -> bool:
    p = next(module.parameters())
    return p.device.type == dev.type and (dev.index is None or p.device.index == dev.index)


def make_sampler(
    var_cfg,
    vae_cfg,
    cfg_scale: float = 1.5,
    top_k: int = 0,
    top_p: float = 0.0,
    more_smooth: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
):
    """Sampler ``(var, vae, generator, label_b) -> DecodeResult`` on
    ``device`` (``"cuda"`` unless the caller passes ``"cpu"``; raises when
    CUDA is asked for and absent). Sampling hyper-parameters are fixed here,
    as the JAX sampler fixes them at compile time."""
    dev = resolve_device(device)

    def sampler(var, vae, generator, label_b) -> DecodeResult:
        if var.cfg != var_cfg or vae.cfg != vae_cfg:
            raise ValueError("sampler: the modules' configs differ from the sampler's")
        if not (_on(var, dev) and _on(vae, dev)):
            raise ValueError(f"sampler: the modules must be on {dev}")
        labels = torch.as_tensor(label_b, dtype=torch.int64, device=dev)
        with torch.inference_mode():
            return decode_cfg(var, vae, labels, generator, cfg_scale=cfg_scale, top_k=top_k,
                              top_p=top_p, more_smooth=more_smooth, dtype=dtype)

    return sampler
