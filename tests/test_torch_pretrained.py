"""The port's hub constructor and VQVAE round trips against the JAX package,
on the CPU: ``models.from_pretrained_dict`` (configs field for field, fp32
logits within the parity tolerance rtol 1e-3 / atol 2e-4), and
``vae.img_to_reconstructed_img`` / ``vae.embed_to_img`` against the
reference fixtures' ``recon`` and JAX's functions, at the JAX tests'
tolerances (``tests/test_vae_parity.py``, ``tests/test_vae_parity_prod.py``).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synth_weights import synth_state_dict
from var_tpu.config import VAEConfig
from var_tpu.engine.convert import convert_vae
from var_tpu.models import from_pretrained_dict as jax_from_pretrained_dict
from var_tpu.models import vae as jvae
from var_tpu.models import var as jvar
from var_tpu_torch import config as tcfg
from var_tpu_torch.engine.convert import DERIVED_BUFFERS
from var_tpu_torch.models import from_pretrained_dict
from var_tpu_torch.models import vae as tvae
from var_tpu_torch.models import var as tvar

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# (rtol, atol) of the JAX tests' recon checks per fixture
RECON_TOL = {"tiny": (1e-4, 5e-5), "prod": (1e-3, 2e-3)}


def _hub_inputs(**overrides):
    """A hub config and a bundled state dict from var_tiny.npz's ``l2``
    weights, as ``tests/test_var_parity.py:97`` builds them."""
    data = np.load(os.path.join(FIXTURES, "var_tiny.npz"))
    pns = tuple(data["patch_nums"].tolist())
    vae_sd = {"vae_local." + k[len("vae_sd/"):]: data[k].astype(np.float32)
              for k in data.files if k.startswith("vae_sd/")}
    var_sd = {k[len("l2/var_sd/"):]: data[k].astype(np.float32)
              for k in data.files if k.startswith("l2/var_sd/")}
    config = dict(vae_kwargs=dict(vocab_size=64, z_channels=8, ch=32, v_patch_nums=pns),
                  num_classes=10, depth=3, embed_dim=64, num_heads=4, drop_path_rate=0.1,
                  attn_l2_norm=True, shared_aln=False, cond_drop_rate=0.0,
                  patch_nums=list(pns), **overrides)
    return data, config, vae_sd, var_sd


def test_from_pretrained_dict_matches_jax():
    data, config, vae_sd, var_sd = _hub_inputs()
    j_vae_cfg, j_var_cfg, j_vae, j_var = jax_from_pretrained_dict(config, {**vae_sd, **var_sd})
    vae_cfg, var_cfg, vae, var = from_pretrained_dict(
        config, {**vae_sd, **{k: torch.from_numpy(v) for k, v in var_sd.items()}}, device="cpu")
    assert dataclasses.asdict(vae_cfg) == dataclasses.asdict(j_vae_cfg)
    assert dataclasses.asdict(var_cfg) == dataclasses.asdict(j_var_cfg)
    assert not var.training and not vae.training
    assert not any(p.requires_grad for p in [*var.parameters(), *vae.parameters()])
    for k, v in vae.state_dict().items():  # every learned tensor, derived buffers dropped
        np.testing.assert_array_equal(v.numpy(), vae_sd["vae_local." + k], err_msg=k)
    learned = {k[len("vae_local."):] for k in vae_sd if not any(b in k for b in DERIVED_BUFFERS)}
    assert set(vae.state_dict()) == learned and len(learned) < len(vae_sd)
    label, x_in = data["l2/label"], data["l2/var_input"]
    want = np.asarray(jvar.var_forward(j_var, j_var_cfg, jnp.asarray(label), jnp.asarray(x_in),
                                       train=False, dtype=jnp.float32))
    with torch.no_grad():
        got = tvar.var_forward(var, torch.from_numpy(label), torch.from_numpy(x_in),
                               train=False, dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(got, data["l2/logits"], rtol=1e-3, atol=2e-4)


def test_from_pretrained_dict_defaults_dtype_and_no_tokenizer():
    """JAX's defaults for absent keys; no ``vae_local.`` keys: no VQVAE; a
    compute dtype stores the blocks' matmul weights in it."""
    _, config, _, var_sd = _hub_inputs()
    config = {k: v for k, v in config.items()
              if k not in ("drop_path_rate", "cond_drop_rate")}
    j_vae_cfg, j_var_cfg, j_vae, _ = jax_from_pretrained_dict(config, var_sd)
    vae_cfg, var_cfg, vae, var = from_pretrained_dict(config, var_sd, device="cpu",
                                                      dtype=torch.bfloat16)
    assert vae is None and j_vae is None
    assert dataclasses.asdict(var_cfg) == dataclasses.asdict(j_var_cfg)
    assert dataclasses.asdict(vae_cfg) == dataclasses.asdict(j_vae_cfg)
    assert var_cfg.drop_path_rate == 0.0 and var_cfg.cond_drop_rate == 0.1
    assert var.blocks[0].attn.mat_qkv.weight.dtype == torch.bfloat16
    assert var.head.weight.dtype == torch.float32


def test_from_pretrained_dict_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    _, config, vae_sd, var_sd = _hub_inputs()
    with pytest.raises(RuntimeError, match="cuda"):
        from_pretrained_dict(config, {**vae_sd, **var_sd})


def _vae_fixture(which):
    """(fixture, JAX config, reference-named state dict, port VQVAE)."""
    data = np.load(os.path.join(FIXTURES, f"vae_{which}.npz"))
    pns = tuple(data["patch_nums"].tolist())
    if which == "tiny":
        cfg = VAEConfig(vocab_size=64, z_channels=8, ch=32, v_patch_nums=pns)
        sd = {k[3:]: data[k].astype(np.float32) for k in data.files if k.startswith("sd/")}
    else:
        cfg = VAEConfig(v_patch_nums=pns)
        sd = synth_state_dict(json.loads(bytes(data["keys_shapes_json"]).decode()))
    vae = tvae.VQVAE(tcfg.VAEConfig(**dataclasses.asdict(cfg)))
    vae.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                         if not any(b in k for b in DERIVED_BUFFERS)})
    return data, cfg, sd, vae.eval().requires_grad_(False)


@pytest.mark.parametrize("which", ["tiny", "prod"])
def test_img_to_reconstructed_img_matches_fixture(which):
    data, _, _, vae = _vae_fixture(which)
    img = torch.from_numpy(np.transpose(data["img"], (0, 2, 3, 1)).copy())
    with torch.no_grad():
        recon = tvae.img_to_reconstructed_img(vae, img)
    rtol, atol = RECON_TOL[which]
    np.testing.assert_allclose(np.transpose(recon.numpy(), (0, 3, 1, 2)), data["recon"],
                               rtol=rtol, atol=atol)
    if which == "tiny":  # one image per scale; the last is the reconstruction
        with torch.no_grad():
            per_scale = tvae.img_to_reconstructed_img(vae, img, last_one=False)
        assert len(per_scale) == len(vae.cfg.v_patch_nums)
        np.testing.assert_array_equal(per_scale[-1].numpy(), recon.numpy())


@pytest.mark.parametrize("all_to_max_scale,last_one", [(True, True), (True, False),
                                                       (False, True)])
def test_embed_to_img_matches_jax(all_to_max_scale, last_one):
    """Seeded per-scale embeddings through both packages' embed_to_img, at
    the tiny recon tolerance."""
    _, cfg, sd, vae = _vae_fixture("tiny")
    params = convert_vae(sd, cfg)
    rng = np.random.default_rng(3)
    ms_h = [rng.standard_normal((2, pn, pn, cfg.z_channels)).astype(np.float32)
            for pn in cfg.v_patch_nums]
    want = jvae.embed_to_img(params, cfg, [jnp.asarray(h) for h in ms_h],
                             all_to_max_scale=all_to_max_scale, last_one=last_one)
    with torch.no_grad():
        got = tvae.embed_to_img(vae, [torch.from_numpy(h) for h in ms_h],
                                all_to_max_scale=all_to_max_scale, last_one=last_one)
    if last_one:
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=5e-5)
