"""Model factory (counterpart of ``var_tpu/models/__init__.py``).

``build_vae_var`` derives width = 64 * depth, heads = depth and builds the
VQVAE (encoder, quantizer, decoder) and the VAR transformer directly on the
target device, from reference ``.pth`` checkpoints when given, else from
seeded random weights, with the blocks' matmul weights stored in the compute
dtype the sampler will decode in. ``build_vae_var_train`` builds the same
pair for training: float32 VAR parameters that require grad, in train mode
(the forward casts them at each use), and the frozen VQVAE in eval mode.
``build_vae_train`` builds the VQVAE alone for tokenizer training, float32
and trainable. ``from_pretrained_dict`` is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from var_tpu_torch.config import VAEConfig, VARConfig
from var_tpu_torch.device import resolve_device
from var_tpu_torch.models import vae as vae_mod
from var_tpu_torch.models import var as var_mod


def _build(device, seed, patch_nums, V, Cvae, ch, share_quant_resi, num_classes, depth,
           shared_aln, attn_l2_norm, init_adaln, init_adaln_gamma, init_head, init_std,
           vae_ckpt, var_ckpt):
    """(vae_cfg, var_cfg, vae, var), float32, on ``device``."""
    dev = resolve_device(device)
    vae_cfg = VAEConfig(vocab_size=V, z_channels=Cvae, ch=ch,
                        share_quant_resi=share_quant_resi, v_patch_nums=patch_nums)
    var_cfg = VARConfig.from_depth(
        depth, num_classes=num_classes, shared_aln=shared_aln,
        attn_l2_norm=attn_l2_norm, patch_nums=patch_nums, vocab_size=V, z_channels=Cvae)
    # built on the meta device, then allocated on the target once: no default
    # init pass that the checkpoint or the seeded init would overwrite
    with torch.device("meta"):
        vae = vae_mod.VQVAE(vae_cfg)
        var = var_mod.VAR(var_cfg)
    vae, var = vae.to_empty(device=dev), var.to_empty(device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if vae_ckpt:
        from var_tpu_torch.engine.convert import load_torch_state_dict

        vae.load_state_dict(load_torch_state_dict(vae_ckpt))
    else:
        vae_mod.init_vae_params(vae, gen)
    if var_ckpt:
        from var_tpu_torch.engine.convert import load_torch_state_dict

        var.load_state_dict(load_torch_state_dict(var_ckpt))
    else:
        var_mod.init_var_params(var, gen, init_std=init_std, init_head=init_head,
                                init_adaln=init_adaln, init_adaln_gamma=init_adaln_gamma)
    return vae_cfg, var_cfg, vae, var


def build_vae_var(
    device="cuda",
    seed: int = 0,
    patch_nums: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16),
    V: int = 4096,
    Cvae: int = 32,
    ch: int = 160,
    share_quant_resi: int = 4,
    num_classes: int = 1000,
    depth: int = 16,
    shared_aln: bool = False,
    attn_l2_norm: bool = True,
    init_adaln: float = 0.5,
    init_adaln_gamma: float = 1e-5,
    init_head: float = 0.02,
    init_std: float = -1.0,
    vae_ckpt: Optional[str] = None,
    var_ckpt: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
):
    """Returns (vae_cfg, var_cfg, vae, var), both modules in eval mode on
    ``device`` (``"cuda"`` unless the caller passes ``"cpu"``). ``dtype`` is
    the compute dtype of the decode (``make_sampler``'s ``dtype``, bf16 by
    default): the blocks' matmul weights are stored in it."""
    vae_cfg, var_cfg, vae, var = _build(
        device, seed, patch_nums, V, Cvae, ch, share_quant_resi, num_classes, depth, shared_aln,
        attn_l2_norm, init_adaln, init_adaln_gamma, init_head, init_std, vae_ckpt, var_ckpt)
    var_mod.cast_block_matmul_params(var, dtype)
    return vae_cfg, var_cfg, vae.eval().requires_grad_(False), var.eval().requires_grad_(False)


def build_vae_var_train(
    device="cuda",
    seed: int = 0,
    patch_nums: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16),
    V: int = 4096,
    Cvae: int = 32,
    ch: int = 160,
    share_quant_resi: int = 4,
    num_classes: int = 1000,
    depth: int = 16,
    shared_aln: bool = False,
    attn_l2_norm: bool = True,
    init_adaln: float = 0.5,
    init_adaln_gamma: float = 1e-5,
    init_head: float = 0.02,
    init_std: float = -1.0,
    vae_ckpt: Optional[str] = None,
    var_ckpt: Optional[str] = None,
):
    """Returns (vae_cfg, var_cfg, vae, var) for training on ``device``: the
    VAR float32, requiring grad, in train mode; the VQVAE frozen, in eval
    mode. The blocks' matmul weights stay float32 (``cast_block_matmul_params``
    is for decode only)."""
    vae_cfg, var_cfg, vae, var = _build(
        device, seed, patch_nums, V, Cvae, ch, share_quant_resi, num_classes, depth, shared_aln,
        attn_l2_norm, init_adaln, init_adaln_gamma, init_head, init_std, vae_ckpt, var_ckpt)
    return vae_cfg, var_cfg, vae.eval().requires_grad_(False), var.train().requires_grad_(True)


def build_vae_train(device="cuda", seed: int = 0, cfg: VAEConfig = VAEConfig(),
                    state_dict: Optional[Dict[str, torch.Tensor]] = None) -> vae_mod.VQVAE:
    """A trainable VQVAE for ``engine/vae_trainer.py``: float32 parameters
    that require grad, in train mode, on ``device`` (``"cuda"`` unless the
    caller passes ``"cpu"``), from a reference-named ``state_dict`` when
    given, else from seeded random weights (``init_vae_params``)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        vae = vae_mod.VQVAE(cfg)
    vae = vae.to_empty(device=dev)
    if state_dict is not None:
        vae.load_state_dict(state_dict)
    else:
        vae_mod.init_vae_params(vae, torch.Generator(device=dev).manual_seed(seed))
    return vae.train().requires_grad_(True)
