"""The port's greedy CFG decode at PRODUCTION geometry vs the reference
fixture var_prod.npz, on the CPU.

d16 width (C = 1024, 16 heads of 64, attn_l2_norm, V = 4096), the full
10-scale 256px pyramid (L = 680), depth cut to 2, with the weights that
``tests/synth_weights.py`` regenerates. Tokens must equal ``dec_tokens``
over all 10 stages and f_hat must match ``dec_fhat``; the fixture's
smallest greedy logit margin is 2.1e-4, so a fault anywhere shows. (The
JAX package's counterpart is the slow-marked
``test_var_parity_prod.py::test_greedy_decode_prod_geometry_xla``.)
"""

import json
import os

import numpy as np
import torch

from tests.synth_weights import synth_state_dict
from var_tpu_torch.config import VAEConfig, VARConfig
from var_tpu_torch.engine.sampler import decode_tokens_cfg
from var_tpu_torch.models import vae as tvae
from var_tpu_torch.models import var as tvar

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "var_prod.npz")


def _manifest(data, key):
    return json.loads(bytes(data[key]).decode())


def test_greedy_decode_prod_geometry_matches_fixture():
    data = np.load(FIXTURE)
    pns = tuple(data["patch_nums"].tolist())
    depth, width, heads, ncls = data["depth_width_heads_ncls"].tolist()
    var_cfg = VARConfig(num_classes=ncls, depth=depth, embed_dim=width, num_heads=heads,
                        attn_l2_norm=True, shared_aln=False, cond_drop_rate=0.0,
                        patch_nums=pns, vocab_size=4096, z_channels=32)
    vae_cfg = VAEConfig(vocab_size=4096, z_channels=32, ch=160, v_patch_nums=pns)
    var = tvar.VAR(var_cfg)
    var.load_state_dict({k[len("var/"):]: torch.from_numpy(v) for k, v in
                         synth_state_dict(_manifest(data, "var_keys_shapes_json")).items()})
    vae = tvae.VQVAE(vae_cfg)
    # the token decode reads only the quantizer (codebook + phi convs)
    quant_keys = [ks for ks in _manifest(data, "vae_keys_shapes_json")
                  if ks[0].startswith("quantize.") and "ema_vocab_hit" not in ks[0]]
    vae.quantize.load_state_dict({k[len("quantize."):]: torch.from_numpy(v)
                                  for k, v in synth_state_dict(quant_keys).items()})
    with torch.inference_mode():
        tokens, f_hat = decode_tokens_cfg(var, vae, torch.from_numpy(data["dec_label"]),
                                          torch.Generator().manual_seed(0), cfg_scale=1.5,
                                          top_k=1, top_p=0.0, dtype=torch.float32)
    np.testing.assert_array_equal(tokens.numpy(), data["dec_tokens"])
    np.testing.assert_allclose(f_hat.numpy(), np.transpose(data["dec_fhat"], (0, 2, 3, 1)),
                               rtol=1e-4, atol=1e-4)
