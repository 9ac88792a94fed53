"""VAR training engine: loss, optimizer, train and eval steps (counterpart of
``var_tpu/engine/trainer.py``).

Semantics follow the JAX package (reference ``trainer.py:20-160``,
``utils/lr_control.py:68-108``, ``utils/amp_sc.py:39-75``):

* teacher forcing: frozen-VQVAE tokenize -> quantizer teacher input -> VAR
  forward -> cross entropy (label smoothing) weighted 1/L, summed over L,
  mean over B; progressive training re-weights the newest scale by
  ``prog_wp``;
* the update: global-norm clip (optax's rule: scale by tclip/|g| only when
  |g| >= tclip), then Adam(0.9, 0.95, 1e-8), then decoupled weight decay on
  the >= 2-D weights outside ``NOWD_NAMES`` -- ``torch.optim.AdamW`` with a
  decay and a no-decay group whose lr and wd are set before every step;
* ``ac`` micro-batches accumulate gradients with 1/ac loss scaling;
* ``fp16=1`` skips steps whose gradient norm is not finite (parameters,
  Adam's moments and its step count stay as they were); ``dscale=1`` adds
  dynamic loss scaling with torch-GradScaler semantics.

Parameters and optimizer state are float32; the forward casts to the compute
dtype at each use (no autocast). Single device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from var_tpu_torch.config import TrainArgs, VAEConfig, VARConfig
from var_tpu_torch.engine.schedules import lr_factor, wd_value
from var_tpu_torch.models import quantizer as q
from var_tpu_torch.models import vae as vae_mod
from var_tpu_torch.models import var as var_mod

NOWD_NAMES = ("pos_1LC", "pos_start", "lvl_embed", "ada_gss", "scale_mul")


def weight_decay_mask(var: torch.nn.Module) -> Dict[str, bool]:
    """{parameter name: decayed} (reference ``filter_params``: >= 2-D
    weights outside ``NOWD_NAMES``): every Linear weight and the class
    embedding; not biases, positional tables, ada_gss or scale_mul."""
    return {name: name.endswith(".weight") and not any(n in name for n in NOWD_NAMES)
            for name, _ in var.named_parameters()}


class ClippedAdamW:
    """``make_adamw`` (``trainer.py:66``): p -= lr * (adam(clip(g)) + wd * p * mask)."""

    def __init__(self, var: torch.nn.Module, tclip: float):
        mask = weight_decay_mask(var)
        named = list(var.named_parameters())
        self.params = [p for _, p in named]
        self.tclip = tclip
        self.opt = torch.optim.AdamW(
            [{"params": [p for n, p in named if mask[n]]},
             {"params": [p for n, p in named if not mask[n]]}],
            lr=0.0, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.0)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def grads(self) -> List[torch.Tensor]:
        for p in self.params:  # unused parameters get zero gradients, as under jax.grad
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def step(self, lr: float, wd: float, skip_nonfinite: bool):
        """Clip, then step. Returns (global grad norm before clipping, stepped)."""
        grads = self.grads()
        gnorm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        if skip_nonfinite and not bool(torch.isfinite(gnorm)):
            return gnorm, False
        if self.tclip > 0:
            factor = torch.where(gnorm < self.tclip, torch.ones_like(gnorm), self.tclip / gnorm)
            torch._foreach_mul_(grads, factor)
        decay, no_decay = self.opt.param_groups
        decay.update(lr=lr, weight_decay=wd)
        no_decay.update(lr=lr, weight_decay=0.0)
        self.opt.step()
        return gnorm, True


def make_adamw(var: torch.nn.Module, tclip: float) -> ClippedAdamW:
    return ClippedAdamW(var, tclip)


def make_grad_scaler(init_scale: float = 2.0 ** 11, growth_interval: int = 1000,
                     max_scale: float = 32768.0, min_scale: float = 1.0):
    """Dynamic loss scaling with torch-GradScaler semantics (``trainer.py:89``):
    on non-finite grads the step is skipped and the scale halves; after
    ``growth_interval`` finite steps in a row it doubles (capped).
    Returns (init, update); ``update(state, grads_finite)`` gives the next state."""

    def init() -> dict:
        return {"scale": float(init_scale), "growth_count": 0}

    def update(state: dict, grads_finite: bool) -> dict:
        if not grads_finite:
            return {"scale": max(state["scale"] * 0.5, min_scale), "growth_count": 0}
        if state["growth_count"] + 1 >= growth_interval:
            return {"scale": min(state["scale"] * 2.0, max_scale), "growth_count": 0}
        return {"scale": state["scale"], "growth_count": state["growth_count"] + 1}

    return init, update


# ---------------------------------------------------------------------------
# loss & metrics


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smooth: float = 0.0) -> torch.Tensor:
    """Per-position cross entropy with torch label-smoothing semantics, fp32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    if label_smooth > 0.0:
        nll = (1.0 - label_smooth) * nll + label_smooth * -logp.mean(-1)
    return nll


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    Lm: torch.Tensor  # mean unsmoothed CE
    Lt: torch.Tensor  # tail (last-scale) CE; -1 under progressive training
    accm: torch.Tensor  # mean top-1 acc (%)
    acct: torch.Tensor  # tail top-1 acc (%)
    grad_norm: torch.Tensor
    lr: float
    wd: float
    scale: float  # dynamic loss scale (1.0 unless dscale)
    per_scale_L: torch.Tensor  # (S,)
    per_scale_acc: torch.Tensor  # (S,)
    pred_hist: torch.Tensor  # (V,) argmax histogram -> z_voc_usage


@torch.no_grad()
def _metrics_from_logits(logits: torch.Tensor, gt_bl: torch.Tensor, var_cfg: VARConfig,
                         prog_si: int) -> dict:
    ed = logits.shape[1]
    pred = logits.argmax(-1)
    ce = cross_entropy(logits, gt_bl)
    hit = (pred == gt_bl).float()
    last_l = var_cfg.patch_nums[-1] ** 2
    minus1 = torch.tensor(-1.0, device=logits.device)
    lt = ce[:, -last_l:].mean() if prog_si < 0 else minus1
    acct = hit[:, -last_l:].mean() * 100.0 if prog_si < 0 else minus1
    nan = torch.tensor(float("nan"), device=logits.device)
    per_l = [ce[:, bg:e].mean() if e <= ed else nan for bg, e in var_cfg.begin_ends]
    per_a = [hit[:, bg:e].mean() * 100.0 if e <= ed else nan for bg, e in var_cfg.begin_ends]
    hist = torch.bincount(pred.reshape(-1), minlength=var_cfg.vocab_size).float()
    return dict(Lm=ce.mean(), Lt=lt, accm=hit.mean() * 100.0, acct=acct,
                per_scale_L=torch.stack(per_l), per_scale_acc=torch.stack(per_a), pred_hist=hist)


# ---------------------------------------------------------------------------
# train / eval steps


@dataclass
class TrainState:
    var: torch.nn.Module
    opt: ClippedAdamW
    step: int = 0  # optimizer steps taken, skipped ones included
    scaler: Optional[dict] = field(default=None)  # dynamic loss-scale state (dscale)


@torch.no_grad()
def tokenize(vae: vae_mod.VQVAE, img: torch.Tensor, args: TrainArgs) -> List[torch.Tensor]:
    """Frozen tokenizer: image batch (B, H, W, 3) -> token pyramid. ``vae_bf16``
    runs the encoder in bf16 (the quantizer stays fp32); ``tokenize_chunk``
    encodes in batch chunks of that size (the same tokens, a smaller peak)."""
    if args.vae_bf16:
        img = img.to(torch.bfloat16)
    tc = int(args.tokenize_chunk or 0)
    if 0 < tc < img.shape[0] and img.shape[0] % tc == 0:
        parts = [vae_mod.img_to_idxBl(vae, chunk) for chunk in img.split(tc)]
        return [torch.cat(per_scale) for per_scale in zip(*parts)]
    return vae_mod.img_to_idxBl(vae, img)


def teacher_loss(var: var_mod.VAR, vae: vae_mod.VQVAE, args: TrainArgs,
                 idx_bl: List[torch.Tensor], label: torch.Tensor,
                 generator: Optional[torch.Generator], prog_si: int = -1,
                 prog_wp: float = 1.0, dtype: torch.dtype = torch.bfloat16):
    """(loss, metrics) of one micro-batch from its tokens (``trainer.py:207-241``)."""
    var_cfg = var.cfg
    L = var_cfg.seq_len
    ed = L if prog_si < 0 else var_cfg.begin_ends[prog_si][1]
    bg = 0 if prog_si < 0 else var_cfg.begin_ends[prog_si][0]
    gt_bl = torch.cat(idx_bl, dim=1)[:, :ed]
    with torch.no_grad():
        x_in = q.idxBl_to_var_input(vae.quantize, vae.cfg, idx_bl)
    logits = var_mod.var_forward(var, label, x_in, generator=generator, train=True,
                                 prog_si=prog_si, dtype=dtype, remat=args.remat)
    ce = cross_entropy(logits, gt_bl, args.ls)  # (B, ed)
    lw = torch.full((ed,), 1.0 / L, device=ce.device)
    if prog_si >= 0:
        lw[bg:ed] *= min(max(float(prog_wp), 0.0), 1.0)
    loss = (ce * lw).sum(-1).mean()
    return loss, _metrics_from_logits(logits.detach(), gt_bl, var_cfg, prog_si)


def make_train_step(var_cfg: VARConfig, vae_cfg: VAEConfig, args: TrainArgs,
                    iters_per_ep: int, prog_si: int = -1, dtype: torch.dtype = torch.bfloat16):
    """(init_state, step) (``trainer.py:175``).

    ``step(state, vae, imgs (ac, B, H, W, 3), labels (ac, B), generator, g_it,
    prog_wp) -> (state, StepMetrics)``: updates ``state.var`` in place."""
    skip_nonfinite = args.fp16 == 1
    dynamic_scale = bool(args.dscale) and args.fp16 == 1
    scaler_init, scaler_update = make_grad_scaler()
    max_it = float(args.ep * iters_per_ep)
    wp_it = float(args.wp * iters_per_ep)

    def init_state(var: var_mod.VAR) -> TrainState:
        return TrainState(var, make_adamw(var, args.tclip),
                          scaler=scaler_init() if dynamic_scale else None)

    def step(state: TrainState, vae, imgs, labels, generator, g_it: int, prog_wp: float = 1.0):
        ac = imgs.shape[0]
        scale = state.scaler["scale"] if dynamic_scale else 1.0
        state.opt.zero_grad()
        loss_acc = torch.zeros((), device=imgs.device)
        for i in range(ac):
            idx_bl = tokenize(vae, imgs[i], args)
            loss, m = teacher_loss(state.var, vae, args, idx_bl, labels[i], generator, prog_si,
                                   prog_wp, dtype)
            (loss * (scale / ac)).backward()  # loss scaled before backward (amp_sc.py:43)
            loss_acc += loss.detach() / ac
        if dynamic_scale:  # unscale (GradScaler.unscale_)
            torch._foreach_div_(state.opt.grads(), scale)
        lr = args.tlr * lr_factor(args.sche, g_it, wp_it, max_it, args.wp0, args.wpe)
        wd = wd_value(g_it, max_it, args.twd, args.twde)
        gnorm, _ = state.opt.step(lr, wd, skip_nonfinite)
        if dynamic_scale:  # not skip-guarded: an overflow must halve the scale
            state.scaler = scaler_update(state.scaler, math.isfinite(float(gnorm)))
        state.step += 1
        # metrics of the last micro-batch, as the reference logs them
        return state, StepMetrics(loss=loss_acc, grad_norm=gnorm, lr=lr, wd=wd, scale=scale, **m)

    return init_state, step


def make_eval_step(var_cfg: VARConfig, vae_cfg: VAEConfig, dtype: torch.dtype = torch.bfloat16):
    """Validation step (``trainer.py:328``): summed [L_mean, L_tail, acc_mean,
    acc_tail, n] over the rows where ``valid`` (B,) is nonzero."""
    last_l = var_cfg.patch_nums[-1] ** 2

    @torch.no_grad()
    def step(var, vae, img, label, valid):
        idx_bl = vae_mod.img_to_idxBl(vae, img)
        gt = torch.cat(idx_bl, dim=1)
        x_in = q.idxBl_to_var_input(vae.quantize, vae_cfg, idx_bl)
        logits = var_mod.var_forward(var, label, x_in, train=False, dtype=dtype)
        v = valid.float()
        ce = cross_entropy(logits, gt)
        hit = (logits.argmax(-1) == gt).float()
        return torch.stack([
            (ce.mean(1) * v).sum(),
            (ce[:, -last_l:].mean(1) * v).sum(),
            (hit.mean(1) * 100.0 * v).sum(),
            (hit[:, -last_l:].mean(1) * 100.0 * v).sum(),
            v.sum(),
        ])

    return step
