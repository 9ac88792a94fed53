"""VQVAE tokenizer training step (counterpart of ``var_tpu/engine/vae_trainer.py``).

The reference ships the tokenizer's training forward (``vqvae.py:56-59``,
``quant.py:52-104``) but no loop; the JAX package adds a minimal step and
this is its port: L2 reconstruction plus the commitment loss, global-norm
clip at ``tclip`` (optax's rule) then Adam(0.9, 0.95, 1e-8) at a constant
lr with no weight decay (``trainer.py::ClippedAdamW``; with wd 0 its decay
mask does not matter), and the EMA codebook-usage bookkeeping. Parameters,
optimizer state and compute are float32, as in the JAX trainer, which has no
compute dtype. ``gn_impl`` picks the GroupNorm formulation
(``models/vae.py::group_norm``): "pallas" runs row 7's kernel in all 67
GroupNorms of the ch160 tokenizer. The step reads nothing back from the
device: its metrics are tensors. Single device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from var_tpu_torch.config import VAEConfig
from var_tpu_torch.engine.trainer import ClippedAdamW
from var_tpu_torch.models import quantizer as q
from var_tpu_torch.models import vae as vae_mod


@dataclass
class VAETrainState:
    vae: vae_mod.VQVAE
    opt: ClippedAdamW
    ema_hits: torch.Tensor  # (S, V) EMA codebook usage (quant.py:35)
    record_hit: int = 0  # recorded steps, for the EMA decay schedule
    step: int = 0


def make_vae_train_step(cfg: VAEConfig, lr: float = 3e-4, beta_recon: float = 1.0,
                        tclip: float = 2.0, gn_impl: str = "dot"):
    """(init_state, step). ``init_state(vae)`` takes a float32 VQVAE that
    requires grad (``models.build_vae_train``); ``step(state, img)`` takes an
    image batch (B, H, W, 3) in [-1, 1], updates ``state.vae`` in place and
    returns (state, metrics): loss, recon, vq (as the JAX step) and the
    pre-clip grad_norm, all tensors."""
    if gn_impl not in vae_mod.GN_IMPLS:
        raise ValueError(f"gn_impl {gn_impl!r}: want one of {vae_mod.GN_IMPLS}")

    def init_state(vae: vae_mod.VQVAE) -> VAETrainState:
        dev = vae.quantize.embedding.weight.device
        ema = torch.zeros(len(cfg.v_patch_nums), cfg.vocab_size, device=dev)
        return VAETrainState(vae, ClippedAdamW(vae, tclip), ema)

    def step(state: VAETrainState, img: torch.Tensor):
        state.opt.zero_grad()
        out = vae_mod.vae_train_forward(state.vae, img, gn_impl)
        recon = ((out.recon - img.float()) ** 2).mean()
        loss = beta_recon * recon + out.vq_loss
        loss.backward()
        gnorm, _ = state.opt.step(lr, 0.0, skip_nonfinite=False)  # zero grads for unused params
        state.ema_hits = q.update_ema_hits(state.ema_hits, out.hits, state.record_hit)
        state.record_hit += 1
        state.step += 1
        metrics: Dict[str, torch.Tensor] = {"loss": loss.detach(), "recon": recon.detach(),
                                            "vq": out.vq_loss.detach(), "grad_norm": gnorm}
        return state, metrics

    return init_state, step


def vocab_usage_percent(state: VAETrainState, cfg: VAEConfig, world_size: int,
                        batch: int) -> torch.Tensor:
    """(S,) percent of the codebook in live use (the reference margin rule,
    ``quant.py:100-102``; tokens per image counted at the last scale, as the
    JAX trainer counts them)."""
    tokens_per_img = cfg.v_patch_nums[-1] ** 2
    return q.vocab_usage(state.ema_hits, cfg, world_size, tokens_per_img, batch)
