"""Seeded weights for both sides, made on the device under the reference's
state-dict names (the VQVAE's under ``vae_local.``).

One standard normal draw per network from a ``torch.Generator`` on the
device, cut into the tensors in registration order, each scaled and shifted
by a rule on its name. The scales are those of a trained network, not of
an initialisation: every block's AdaLN gammas are of order 0.3 (an
initialisation's 1e-5 would leave the blocks nearly silent and the check
blind to them), the head spreads the logits to a standard deviation of
about 2, and the codebook's codes are as wide as the encoder's features.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import models as M


def _rule(name: str, shape, s: M.Sizes):
    """(std, mean) of the tensor ``name``."""
    c = s.embed_dim
    last = name.rsplit(".", 1)[-1]
    if name.startswith("vae_local."):
        if name.endswith("quantize.embedding.weight"):
            return 0.5, 0.0
        if len(shape) == 4:  # convolution weights
            fan_in = shape[1] * shape[2] * shape[3]
            gain = 0.5 if name.endswith("decoder.conv_out.weight") else 1.0
            return gain / math.sqrt(fan_in), 0.0
        if ".norm" in name:  # GroupNorm affine
            return (0.1, 1.0) if last == "weight" else (0.05, 0.0)
        return 0.02, 0.0  # convolution biases
    if last == "bias" or name.endswith(("q_bias", "v_bias")):
        return 0.02, 0.0
    if name.endswith("scale_mul_1H11"):
        return 0.1, math.log(4.0)
    if name == "class_emb.weight":
        return 1.0, 0.0
    if name in ("pos_start", "pos_1LC", "lvl_embed.weight"):
        return 0.1, 0.0
    if "ada_lin" in name or name.endswith("ada_gss"):
        return 0.5 / math.sqrt(c), 0.0
    if name == "head.weight":
        return 2.0 / math.sqrt(c), 0.0
    return 1.0 / math.sqrt(shape[-1]), 0.0  # linear weights: fan-in scaling


def names_shapes(s: M.Sizes, var: bool = True, vae: bool = True):
    """[(name, shape)] of the networks asked for, in registration order."""
    out = []
    with torch.device("meta"):
        if vae:
            out += [("vae_local." + n, tuple(t.shape)) for n, t in M.VQVAE(s).state_dict().items()]
        if var:
            out += [(n, tuple(t.shape)) for n, t in M.VAR(s).state_dict().items()]
    return out


@torch.no_grad()
def make(s: M.Sizes, seed: int, device, var: bool = True, vae: bool = True
         ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} on ``device``: views into one draw per
    network, from ``seed``."""
    out = {}
    for i, part in enumerate(p for p, want in (("vae", vae), ("var", var)) if want):
        items = names_shapes(s, var=part == "var", vae=part == "vae")
        total = sum(math.prod(sh) for _, sh in items)
        gen = torch.Generator(device=device).manual_seed((int(seed) * 2 + i) % 2 ** 63)
        flat = torch.randn(total, generator=gen, device=device)
        off = 0
        for name, shape in items:
            n = math.prod(shape)
            std, mean = _rule(name, shape, s)
            t = flat[off:off + n].view(shape)
            t.mul_(std).add_(mean)
            out[name] = t
            off += n
    return out
