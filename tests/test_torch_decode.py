"""The port's CFG decode as a whole vs the JAX ``decode_cfg`` and the
reference fixture (var_tiny.npz), on the CPU.

Greedy decodes (top_k = 1) are RNG-free and compared token by token. RNG
streams differ between the frameworks, so sampled decodes are checked by
candidate set: every drawn token lies in the reference-exact top-k/top-p
mask of the logits it was drawn from.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from var_tpu.config import VAEConfig, VARConfig
from var_tpu.engine.convert import convert_vae, convert_var
from var_tpu.engine.sampler import decode_cfg as jax_decode_cfg
from var_tpu.ops.sampling import top_k_top_p_mask as jax_top_k_top_p_mask
from var_tpu_torch import config as tcfg
from var_tpu_torch.engine import sampler as tsampler
from var_tpu_torch.engine.convert import vae_state_dict, var_state_dict
from var_tpu_torch.models import vae as tvae
from var_tpu_torch.models import var as tvar
from var_tpu_torch.ops.sampling import top_k_top_p_mask

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "var_tiny.npz")


def _torch_cfg(cfg):
    cls = tcfg.VAEConfig if isinstance(cfg, VAEConfig) else tcfg.VARConfig
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__})


def _port_models(vae_params, vae_cfg, var_params, var_cfg):
    vae = tvae.VQVAE(_torch_cfg(vae_cfg))
    vae.load_state_dict(vae_state_dict(vae_params, vae_cfg))
    var = tvar.VAR(_torch_cfg(var_cfg))
    var.load_state_dict(var_state_dict(var_params, var_cfg))
    return vae.eval().requires_grad_(False), var.eval().requires_grad_(False)


def _load_tiny(tag):
    data = np.load(FIXTURE)
    pns = tuple(data["patch_nums"].tolist())
    vae_cfg = VAEConfig(vocab_size=64, z_channels=8, ch=32, v_patch_nums=pns)
    var_cfg = VARConfig(num_classes=10, depth=3, embed_dim=64, num_heads=4,
                        drop_path_rate=0.1, shared_aln=(tag == "saln"),
                        attn_l2_norm=(tag == "l2"), cond_drop_rate=0.0, patch_nums=pns,
                        vocab_size=64, z_channels=8)
    vae_sd = {k[len("vae_sd/"):]: data[k].astype(np.float32)
              for k in data.files if k.startswith("vae_sd/")}
    var_sd = {k[len(f"{tag}/var_sd/"):]: data[k].astype(np.float32)
              for k in data.files if k.startswith(f"{tag}/var_sd/")}
    return data, vae_cfg, var_cfg, convert_vae(vae_sd, vae_cfg), convert_var(var_sd, var_cfg)


@pytest.mark.parametrize("tag", ["l2", "saln"])
def test_greedy_cfg_decode_matches_jax_and_fixture(tag):
    data, vae_cfg, var_cfg, vae_params, var_params = _load_tiny(tag)
    label = data[f"{tag}/label"]
    want = jax_decode_cfg(var_params, vae_params, var_cfg, vae_cfg, jax.random.PRNGKey(0),
                          jnp.asarray(label), cfg_scale=1.5, top_k=1, top_p=0.0,
                          dtype=jnp.float32)
    vae, var = _port_models(vae_params, vae_cfg, var_params, var_cfg)
    sampler = tsampler.make_sampler(var.cfg, vae.cfg, cfg_scale=1.5, top_k=1, top_p=0.0,
                                    dtype=torch.float32, device="cpu")
    got = sampler(var, vae, torch.Generator().manual_seed(0), label)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.f_hat.numpy(), np.asarray(want.f_hat), rtol=0, atol=1e-4)
    img = got.image.numpy()
    np.testing.assert_allclose(img, np.asarray(want.image), rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.transpose(img, (0, 3, 1, 2)), data[f"{tag}/dec_img"],
                               rtol=1e-3, atol=1e-3)


def _random_models(vocab, seed):
    pns = (1, 2, 3)
    vae_cfg = tcfg.VAEConfig(vocab_size=vocab, z_channels=8, ch=32, ch_mult=(1, 1),
                             v_patch_nums=pns)
    var_cfg = tcfg.VARConfig(num_classes=10, depth=2, embed_dim=64, num_heads=4,
                             patch_nums=pns, vocab_size=vocab, z_channels=8,
                             attn_l2_norm=True, cond_drop_rate=0.0)
    gen = torch.Generator().manual_seed(seed)
    vae = tvae.init_vae_params(tvae.VQVAE(vae_cfg), gen)
    # a wider logit spread than the 0.02 head init, so top-p cuts deep
    var = tvar.init_var_params(tvar.VAR(var_cfg), gen, init_head=2.0)
    return vae.eval().requires_grad_(False), var.eval().requires_grad_(False)


def test_sampled_decode_draws_inside_candidate_set(monkeypatch):
    """top_k = 900, top_p = 0.96 at V = 2048: every drawn token is a
    candidate of the reference mask, and the port's mask equals JAX's."""
    vae, var = _random_models(2048, 3)
    drawn = []

    def recording(logits, top_k=0, top_p=0.0, generator=None):
        idx = sample(logits, top_k=top_k, top_p=top_p, generator=generator)
        drawn.append((logits.clone(), idx.clone(), top_k, top_p))
        return idx

    sample = tsampler.sample_with_top_k_top_p
    monkeypatch.setattr(tsampler, "sample_with_top_k_top_p", recording)
    sampler = tsampler.make_sampler(var.cfg, vae.cfg, cfg_scale=1.5, top_k=900, top_p=0.96,
                                    dtype=torch.float32, device="cpu")
    res = sampler(var, vae, torch.Generator().manual_seed(1), [1, 7, 3])
    assert res.tokens.shape == (3, var.cfg.seq_len)
    assert res.image.shape == (3, 6, 6, 3)  # ch_mult (1, 1): 2x upsampling
    assert torch.isfinite(res.image).all() and res.image.min() >= 0 and res.image.max() <= 1
    assert len(drawn) == len(var.cfg.patch_nums)
    for logits, idx, k, p in drawn:
        mask = top_k_top_p_mask(logits, k, p)
        np.testing.assert_array_equal(
            torch.isfinite(mask).numpy(),
            np.isfinite(np.asarray(jax_top_k_top_p_mask(jnp.asarray(logits.numpy()), k, p))))
        assert torch.isfinite(mask.gather(-1, idx[..., None])).all()
        assert (torch.isfinite(mask).sum(-1) < logits.shape[-1]).all()  # the filter cut


def test_more_smooth_decode_runs():
    vae, var = _random_models(64, 4)
    sampler = tsampler.make_sampler(var.cfg, vae.cfg, cfg_scale=1.5, top_k=8, top_p=0.9,
                                    more_smooth=True, dtype=torch.float32, device="cpu")
    res = sampler(var, vae, torch.Generator().manual_seed(2), [0, 5])
    assert torch.isfinite(res.f_hat).all()
    assert res.image.min() >= 0 and res.image.max() <= 1


@pytest.mark.parametrize("arg", ["gt_tokens", "keep_mask", "edit_mask", "kv_window"])
def test_unported_branches_raise(arg):
    vae, var = _random_models(64, 5)
    with pytest.raises(NotImplementedError):
        tsampler.decode_cfg(var, vae, torch.tensor([1]), **{arg: 2})


def test_gumbel_softmax_soft_and_hard():
    from var_tpu_torch.ops.sampling import gumbel_softmax

    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 16)).astype(np.float32))
    soft = gumbel_softmax(logits, tau=0.5, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(soft.sum(-1), torch.ones(5))
    hard = gumbel_softmax(logits, tau=0.5, hard=True, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(hard, torch.nn.functional.one_hot(soft.argmax(-1), 16).float())
