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
device: its metrics are tensors. Like JAX's jitted step
(``vae_trainer.py:53``) it is a compiled program (``engine/compiled.py``):
on CUDA the first call of a shape runs eagerly and captures a CUDA graph,
later calls replay it over the state's fixed tensors (parameters, Adam's
moments and count, ``ema_hits``, ``record_hit``). Single device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from var_tpu_torch.config import VAEConfig
from var_tpu_torch.engine.compiled import Compiled
from var_tpu_torch.engine.trainer import ClippedAdamW
from var_tpu_torch.models import quantizer as q
from var_tpu_torch.models import vae as vae_mod


@dataclass
class VAETrainState:
    vae: vae_mod.VQVAE
    opt: ClippedAdamW
    ema_hits: torch.Tensor  # (S, V) EMA codebook usage (quant.py:35), updated in place
    record_hit: torch.Tensor  # int32 device scalar: recorded steps, for the EMA decay
    step: int = 0

    def tensors(self):
        """What a compiled step reads and updates in place."""
        return [*self.vae.parameters(), *self.vae.buffers(), *self.opt.tensors(),
                self.ema_hits, self.record_hit]


def make_vae_train_step(cfg: VAEConfig, lr: float = 3e-4, beta_recon: float = 1.0,
                        tclip: float = 2.0, gn_impl: str = "dot"):
    """(init_state, step). ``init_state(vae)`` takes a float32 VQVAE that
    requires grad (``models.build_vae_train``); ``step(state, img)`` takes an
    image batch (B, H, W, 3) in [-1, 1], updates the state in place and
    returns (state, metrics): loss, recon, vq (as the JAX step) and the
    pre-clip grad_norm, all tensors. ``step.program`` is the
    :class:`Compiled`, ``step.eager`` the same step through the body."""
    if gn_impl not in vae_mod.GN_IMPLS:
        raise ValueError(f"gn_impl {gn_impl!r}: want one of {vae_mod.GN_IMPLS}")

    def init_state(vae: vae_mod.VQVAE) -> VAETrainState:
        dev = vae.quantize.embedding.weight.device
        ema = torch.zeros(len(cfg.v_patch_nums), cfg.vocab_size, device=dev)
        return VAETrainState(vae, ClippedAdamW(vae, tclip), ema,
                             torch.zeros((), dtype=torch.int32, device=dev))

    def body(state: VAETrainState, img: torch.Tensor):
        state.opt.zero_grad()  # the capture's backward makes the gradients in its pool
        out = vae_mod.vae_train_forward(state.vae, img, gn_impl)
        recon = ((out.recon - img.float()) ** 2).mean()
        loss = beta_recon * recon + out.vq_loss
        loss.backward()
        gnorm, _ = state.opt.step(lr, 0.0, skip_nonfinite=False)  # zero grads for unused params
        state.ema_hits.copy_(q.update_ema_hits(state.ema_hits, out.hits, state.record_hit))
        state.record_hit.add_(1)
        return loss.detach(), recon.detach(), out.vq_loss.detach(), gnorm

    program = Compiled(body, 1, None, train=True)

    def make_step(call):
        def step(state: VAETrainState, img: torch.Tensor):
            loss, recon, vq, gnorm = call(state, img)
            state.step += 1
            metrics: Dict[str, torch.Tensor] = {"loss": loss, "recon": recon, "vq": vq,
                                                "grad_norm": gnorm}
            return state, metrics
        return step

    step = make_step(program)
    step.eager = make_step(program.eager)
    step.program = program
    return init_state, step


def vocab_usage_percent(state: VAETrainState, cfg: VAEConfig, world_size: int,
                        batch: int) -> torch.Tensor:
    """(S,) percent of the codebook in live use (the reference margin rule,
    ``quant.py:100-102``; tokens per image counted at the last scale, as the
    JAX trainer counts them)."""
    tokens_per_img = cfg.v_patch_nums[-1] ** 2
    return q.vocab_usage(state.ema_hits, cfg, world_size, tokens_per_img, batch)
