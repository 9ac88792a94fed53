"""Weights across the two packages (counterpart of ``var_tpu/engine/convert.py``).

The port's modules carry the reference state-dict names, so a reference
``.pth`` loads with ``load_state_dict`` once the derived buffers are dropped
(:func:`load_torch_state_dict`). The functions below are the inverse of the
JAX package's ``convert_var``/``convert_vae``: they turn its parameter trees
(numpy leaves; ``blocks`` a list or stacked along depth) into
reference-named state dicts of torch tensors:

* Linear kernel (I, O) -> weight (O, I)
* Conv kernel HWIO -> weight OIHW
* GroupNorm scale/bias -> weight/bias
* ``scale_mul`` (1, 1, H, 1) -> ``scale_mul_1H11`` (1, H, 1, 1)
* phi convs -> ``quantize.quant_resi.{qresi_ls.k | qresi | k}``
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from var_tpu_torch.config import VAEConfig, VARConfig
from var_tpu_torch.models.quantizer import num_phi

# buffers the reference modules derive rather than learn: EMA vocab-usage
# stats (quant.py:35), the level-id table and causal mask (var.py:110-112),
# the constant zero k-bias (basic_var.py:76)
DERIVED_BUFFERS = ("ema_vocab_hit_SV", "lvl_1L", "attn_bias_for_masking", "zero_k_bias")


def learned_state_dict(sd) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a reference-named state dict whose values are
    tensors or arrays, without the derived buffers."""
    return {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
            for k, v in sd.items() if not any(b in k for b in DERIVED_BUFFERS)}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pth`` (or a training checkpoint around one) into
    {name: tensor}, without the derived buffers."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "trainer" in obj:  # full training ckpt (train.py:222-227)
        obj = obj["trainer"]["var_wo_ddp"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return learned_state_dict({k: v for k, v in obj.items() if torch.is_tensor(v)})


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _blocks(params: dict, depth: int) -> list:
    blocks = params["blocks"]
    if isinstance(blocks, (list, tuple)):
        return list(blocks)
    return [_index(blocks, i) for i in range(depth)]  # stacked along depth


def var_state_dict(params: dict, cfg: VARConfig) -> Dict[str, torch.Tensor]:
    """JAX VAR parameter tree -> reference-named state dict (the port's
    ``VAR.load_state_dict`` input)."""
    out: Dict[str, torch.Tensor] = {}

    def linear(name: str, p: dict) -> None:
        out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
        if "bias" in p:
            out[f"{name}.bias"] = _t(p["bias"])

    linear("word_embed", params["word_embed"])
    out["class_emb.weight"] = _t(params["class_emb"])
    out["pos_start"] = _t(params["pos_start"])
    out["pos_1LC"] = _t(params["pos_1LC"])
    out["lvl_embed.weight"] = _t(params["lvl_embed"])
    linear("head_nm.ada_lin.1", params["head_nm"]["ada_lin"])
    linear("head", params["head"])
    if cfg.shared_aln:
        linear("shared_ada_lin.1", params["shared_ada_lin"])
    for i, blk in enumerate(_blocks(params, cfg.depth)):
        pre = f"blocks.{i}"
        attn = blk["attn"]
        linear(f"{pre}.attn.mat_qkv", attn["qkv"])
        out[f"{pre}.attn.q_bias"] = _t(attn["q_bias"])
        out[f"{pre}.attn.v_bias"] = _t(attn["v_bias"])
        linear(f"{pre}.attn.proj", attn["proj"])
        linear(f"{pre}.ffn.fc1", blk["ffn"]["fc1"])
        linear(f"{pre}.ffn.fc2", blk["ffn"]["fc2"])
        if cfg.attn_l2_norm:
            out[f"{pre}.attn.scale_mul_1H11"] = _t(
                np.asarray(attn["scale_mul"]).reshape(1, cfg.num_heads, 1, 1))
        if cfg.shared_aln:
            out[f"{pre}.ada_gss"] = _t(blk["ada_gss"])
        else:
            linear(f"{pre}.ada_lin.1", blk["ada_lin"])
    return out


def _conv(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    out[f"{name}.bias"] = _t(p["bias"])


def _norm(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _resblock(out: dict, name: str, p: dict) -> None:
    for part in ("norm1", "norm2"):
        _norm(out, f"{name}.{part}", p[part])
    for part in ("conv1", "conv2", "nin_shortcut"):
        if part in p:
            _conv(out, f"{name}.{part}", p[part])


def _attnblock(out: dict, name: str, p: dict) -> None:
    _norm(out, f"{name}.norm", p["norm"])
    _conv(out, f"{name}.qkv", p["qkv"])
    _conv(out, f"{name}.proj_out", p["proj_out"])


def _enc_dec(out: dict, side: str, p: dict) -> None:
    levels_key, resample = ("down", "downsample") if side == "encoder" else ("up", "upsample")
    _conv(out, f"{side}.conv_in", p["conv_in"])
    for i, level in enumerate(p[levels_key]):
        pre = f"{side}.{levels_key}.{i}"
        for j, blk in enumerate(level["block"]):
            _resblock(out, f"{pre}.block.{j}", blk)
        for j, blk in enumerate(level["attn"]):
            _attnblock(out, f"{pre}.attn.{j}", blk)
        if resample in level:
            _conv(out, f"{pre}.{resample}.conv", level[resample]["conv"])
    _resblock(out, f"{side}.mid.block_1", p["mid"]["block_1"])
    if p["mid"].get("attn_1"):
        _attnblock(out, f"{side}.mid.attn_1", p["mid"]["attn_1"])
    _resblock(out, f"{side}.mid.block_2", p["mid"]["block_2"])
    _norm(out, f"{side}.norm_out", p["norm_out"])
    _conv(out, f"{side}.conv_out", p["conv_out"])


def vae_state_dict(params: dict, cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    """JAX VQVAE parameter tree -> reference-named state dict, encoder side
    included (the port's ``VQVAE.load_state_dict`` input)."""
    out: Dict[str, torch.Tensor] = {}
    for side in ("encoder", "decoder"):
        if side in params:
            _enc_dec(out, side, params[side])
    if "quant_conv" in params:
        _conv(out, "quant_conv", params["quant_conv"])
    _conv(out, "post_quant_conv", params["post_quant_conv"])
    out["quantize.embedding.weight"] = _t(params["quantize"]["embedding"])
    for k in range(num_phi(cfg)):
        if cfg.share_quant_resi == 0:
            prefix = f"quantize.quant_resi.{k}"
        elif cfg.share_quant_resi == 1:
            prefix = "quantize.quant_resi.qresi"
        else:
            prefix = f"quantize.quant_resi.qresi_ls.{k}"
        _conv(out, prefix, params["quantize"]["phi"][k])
    return out
