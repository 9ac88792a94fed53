"""The comparisons that decide ``correct``: what the program served or
computed against the plain reference (``benchmark/reference``), which
works everything out again from the same seeded weights and inputs.

Sampling: over the served token pyramids of the checked requests,
* ``greedy_gap``: in greedy requests, the widest gap by which a served
  token's reference logit (classifier-free-guided, float32) lies below the
  reference's best at its position;
* ``filter_share``: in sampled requests, the share of served tokens that
  the reference's top-k then top-p filter would not keep at their
  positions. (A share, not the widest distance past the filter: where the
  kept set ends between two far-apart logits, a rounding that moves the
  boundary by one token moves that distance by their gap.) The control
  draws its tokens from its own filter;
* ``image_err``: of every served image, the mean absolute difference in
  uint8 levels from the reference's render of its served tokens; the worst
  image's.
Training, over the first three steps:
* ``loss_gap``: the widest relative gap between a step's loss and the
  reference's;
* ``grad_gap``: the first step's clipped gradient, by leaf: the gap between
  the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf; the worst leaf's;
* ``change_gap``: the same for the parameters' change after the three
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (the others move under Adam by round-off alone).

The control (``control.py``) puts a lower-precision reference in the
program's place and reads the same numbers.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from benchmark.reference import models as M


def kept(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """The reference's filter (``helpers.py``): top-k, then drop the tokens
    whose mass counted from the least likely up is at most 1 - top_p, never
    the most likely one. A bool mask over the vocabulary."""
    k = logits.shape[-1] if top_k <= 0 else min(top_k, logits.shape[-1])
    vals = logits.topk(k, dim=-1).values
    if top_p > 0:
        probs = torch.softmax(vals, -1)
        n = ((probs.cumsum(-1) - probs) < top_p).sum(-1, keepdim=True).clamp(min=1)
        vals = vals.gather(-1, n - 1)
    return logits >= vals[..., -1:]


def _blocks(n: int, rows: int) -> Iterable[Tuple[int, int]]:
    for i in range(0, n, rows):
        yield i, min(i + rows, n)


@torch.no_grad()
def sample_numbers(vae: M.VQVAE, var: M.VAR, traffic: dict, served: List[dict],
                   prec: Optional[M.Prec] = None, rows: int = 10, seed: int = 0
                   ) -> Dict[str, float]:
    """The three sampling numbers over ``served`` requests ({"labels" (B,),
    "tokens" (B, L), "images" (B, H, W, 3) uint8, "greedy"} on the device).
    With ``prec`` the reference in that precision stands in the program's
    place: its first choice, its kept set and its render are judged
    instead of the served tokens and images."""
    cfg, top_k, top_p = traffic["cfg"], traffic["top_k"], traffic["top_p"]
    out = {"greedy_gap": 0.0, "image_err": 0.0}
    n_out = n_all = 0
    gen = None
    if prec is not None and served:  # the control draws its tokens from its own filter
        gen = torch.Generator(device=served[0]["tokens"].device).manual_seed(seed)
    with M.exact():
        for req in served:
            for i, j in _blocks(req["labels"].shape[0], rows):
                lab, tok = req["labels"][i:j], req["tokens"][i:j]
                ref = M.cfg_logits(var, vae, lab, tok, cfg)
                low = None if prec is None else M.cfg_logits(var, vae, lab, tok, cfg, prec)
                if req["greedy"]:
                    pick = tok if low is None else low.argmax(-1)
                    gap = ref.max(-1).values - ref.gather(-1, pick[..., None])[..., 0]
                    out["greedy_gap"] = max(out["greedy_gap"], float(gap.max()))
                else:
                    if low is None:
                        drawn = tok
                    else:
                        drawn = _draw(low.masked_fill(~kept(low, top_k, top_p), float("-inf")),
                                      gen)
                    outside = ~kept(ref, top_k, top_p).gather(-1, drawn[..., None])[..., 0]
                    n_out += int(outside.sum())
                    n_all += outside.numel()
                f_hat, _ = M.pyramid(vae, tok)
                want = M.to_uint8(M.decode(vae, f_hat)).float()
                got_img = req["images"][i:j].float() if prec is None else \
                    M.to_uint8(M.decode(vae, f_hat, prec)).float()
                err = (got_img - want).abs().mean(dim=(1, 2, 3))
                out["image_err"] = max(out["image_err"], float(err.max()))
    out["filter_share"] = n_out / max(n_all, 1)
    return out


def _draw(masked_logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One token a position from the softmax of ``masked_logits``
    (Gumbel-max)."""
    u = torch.rand(masked_logits.shape, generator=gen, device=masked_logits.device)
    return (masked_logits - torch.log(-torch.log(u.clamp(min=1e-30)))).argmax(-1)


def leaf_gap(got: Dict[str, float], want: Dict[str, float], names: Iterable[str]) -> float:
    """Worst leaf of |got - want| / max(want, the median leaf's want)."""
    names = list(names)
    med = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in names)


def moving_leaves(grad_norms: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= 1e-3 * med]


def train_numbers(got: dict, want: dict) -> Dict[str, float]:
    """``got`` and ``want``: {"losses": [3], "grad_norms": {leaf: norm after
    step 1}, "changes": {leaf: norm of the change after step 3}}."""
    loss_gap = max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(got["grad_norms"], want["grad_norms"], want["grad_norms"]),
            "change_gap": leaf_gap(got["changes"], want["changes"],
                                   moving_leaves(want["grad_norms"]))}
