"""The plain reference of VAR's training step (reference ``trainer.py``,
``train.py``): the frozen tokenizer's token pyramid, teacher forcing with
cond-drop and drop-path, cross entropy weighted 1/L, summed over L and
averaged over the batch, the global-norm clip (scale by tclip / |g| when
|g| >= tclip), then AdamW (betas 0.9, 0.95, eps 1e-8) with decoupled weight
decay on the >= 2-D weights outside the no-decay names.

The random masks are drawn from a generator on the device in the order the
published trainer draws them each step: the cond-drop uniforms of the
batch, then two (B, 1, 1) uniforms for each block whose drop-path rate is
above 0. The batch is run in row blocks whose gradients add up to the
whole batch's.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import models as M

NO_DECAY = ("pos_1LC", "pos_start", "lvl_embed", "ada_gss", "scale_mul", "cls_token",
            "start_token", "gamma", "beta")


def decayed(name: str, p: torch.Tensor) -> bool:
    return p.ndim >= 2 and not any(k in name for k in NO_DECAY)


def draw_masks(s: M.Sizes, labels: torch.Tensor, gen: torch.Generator):
    """(labels after cond-drop, per block None or two keep masks)."""
    b = labels.shape[0]
    drop = torch.rand(b, generator=gen, device=labels.device)
    labels = torch.where(drop < s.cond_drop_rate, torch.full_like(labels, s.num_classes), labels)
    masks = []
    for rate in np.linspace(0.0, s.drop_path_rate, s.depth):
        keep = 1.0 - float(rate)
        if rate <= 0:
            masks.append(None)
            continue
        pair = [(torch.rand(b, 1, 1, generator=gen, device=labels.device) < keep).float() / keep
                for _ in range(2)]
        masks.append(pair)
    return labels, masks


class Trainer:
    """Reference steps over a float32 copy of the weights."""

    def __init__(self, vae: M.VQVAE, var: M.VAR, lr: float, wd: float, tclip: float,
                 prec: M.Prec = M.FP32, rows: int = 8):
        self.vae, self.var, self.prec, self.rows, self.tclip = vae, var, prec, rows, tclip
        self.named = [(n, p) for n, p in var.named_parameters()]
        for _, p in self.named:
            p.requires_grad_(True)
        groups = [{"params": [p for n, p in self.named if decayed(n, p)], "weight_decay": wd},
                  {"params": [p for n, p in self.named if not decayed(n, p)],
                   "weight_decay": 0.0}]
        self.opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.95), eps=1e-8, foreach=False)

    @torch.no_grad()
    def tokens(self, imgs: torch.Tensor) -> List[torch.Tensor]:
        out = []
        for i in range(0, imgs.shape[0], self.rows):
            out.append(M.tokenize(self.vae, M.encode(self.vae, imgs[i:i + self.rows], self.prec),
                                  self.prec))
        return [torch.cat(per) for per in zip(*out)]

    def step(self, imgs: torch.Tensor, labels: torch.Tensor, gen: torch.Generator,
             keep_rows: int = 0) -> Dict[str, object]:
        """One step on (B, H, W, 3) images in [-1, 1] and (B,) labels.
        ``keep_rows`` > 0 plants the half-batch fault: only the first rows
        count, the mean taken over them. Returns the loss and, per leaf,
        the clipped gradient's norm."""
        s, p = self.var.sizes, self.prec
        with M.exact():
            idx = torch.cat(self.tokens(imgs), 1)
            labels, masks = draw_masks(s, labels, gen)
            b = keep_rows or labels.shape[0]
            self.opt.zero_grad(set_to_none=True)
            total = 0.0
            for i in range(0, b, self.rows):
                j = min(i + self.rows, b)
                with torch.no_grad():
                    _, x_in = M.pyramid(self.vae, idx[i:j], p)
                dps = [None if m is None else (m[0][i:j], m[1][i:j]) for m in masks]
                logits = M.forward(self.var, labels[i:j], x_in, p, dps)
                ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), idx[i:j].reshape(-1),
                                     reduction="none").reshape(j - i, -1)
                loss = ce.sum() / (s.seq_len * b)
                loss.backward()
                total += float(loss.detach())
            grads = [q.grad for _, q in self.named]
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            if not torch.isfinite(norm):
                raise FloatingPointError("reference gradient norm is not finite")
            if norm >= self.tclip:
                for g in grads:
                    g.mul_(self.tclip / norm)
            gnorms = {n: float(q.grad.norm()) for n, q in self.named}
            self.opt.step()
        return {"loss": total, "grad_norms": gnorms}

    def param_change(self, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
        return {n: float((q.detach() - start[n].float()).norm()) for n, q in self.named}
