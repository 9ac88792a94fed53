"""The port's modules vs their JAX counterparts, and weights carried across.

Same inputs (numpy, fixed seeds, or the reference-generated fixtures) go
through the JAX function and the port's plain PyTorch path on the CPU.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from var_tpu.config import VAEConfig, VARConfig
from var_tpu.engine.convert import convert_vae, convert_var
from var_tpu.models import quantizer as jq
from var_tpu.models import vae as jvae
from var_tpu.models import var as jvar
from var_tpu.ops.resize import resize as jax_resize
from var_tpu_torch import config as tcfg
from var_tpu_torch.engine.convert import DERIVED_BUFFERS, vae_state_dict, var_state_dict
from var_tpu_torch.models import quantizer as tq
from var_tpu_torch.models import vae as tvae
from var_tpu_torch.models import var as tvar
from var_tpu_torch.ops.resize import resize

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PATCH_NUMS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)


def _torch_cfg(cfg):
    """The port's config with the same fields as a JAX config."""
    cls = tcfg.VAEConfig if isinstance(cfg, VAEConfig) else tcfg.VARConfig
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__})


def _vae_tiny():
    data = np.load(os.path.join(FIXTURES, "vae_tiny.npz"))
    cfg = VAEConfig(vocab_size=64, z_channels=8, ch=32,
                    v_patch_nums=tuple(data["patch_nums"].tolist()))
    sd = {k[3:]: data[k].astype(np.float32) for k in data.files if k.startswith("sd/")}
    vae = tvae.VQVAE(_torch_cfg(cfg))
    vae.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                         if not any(b in k for b in DERIVED_BUFFERS)})
    return data, cfg, sd, convert_vae(sd, cfg), vae.eval().requires_grad_(False)


def _var_tiny(tag):
    data = np.load(os.path.join(FIXTURES, "var_tiny.npz"))
    pns = tuple(data["patch_nums"].tolist())
    cfg = VARConfig(num_classes=10, depth=3, embed_dim=64, num_heads=4, drop_path_rate=0.1,
                    shared_aln=(tag == "saln"), attn_l2_norm=(tag == "l2"),
                    cond_drop_rate=0.0, patch_nums=pns, vocab_size=64, z_channels=8)
    sd = {k[len(f"{tag}/var_sd/"):]: data[k].astype(np.float32)
          for k in data.files if k.startswith(f"{tag}/var_sd/")}
    return cfg, sd


def _nhwc(x):
    return np.transpose(x, (0, 2, 3, 1))


@pytest.mark.parametrize("pn", PATCH_NUMS[:-1])
@pytest.mark.parametrize("mode", ["area", "bicubic"])
def test_resize_pyramid_matches_jax(pn, mode):
    """area: 16 -> pn (residual downsample); bicubic: pn -> 16 (embedding upsample)."""
    rng = np.random.default_rng(pn)
    src, dst = ((16, 16), (pn, pn)) if mode == "area" else ((pn, pn), (16, 16))
    x = rng.standard_normal((2, *src, 5)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), dst, mode))
    got = resize(torch.from_numpy(x), dst, mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("si", [0, 1, 2, 3])
def test_get_next_autoregressive_input_matches_jax(si):
    data, cfg, _, params, vae = _vae_tiny()
    pns = cfg.v_patch_nums
    b = data["img"].shape[0]
    rng = np.random.default_rng(si)
    f_hat = (rng.standard_normal((b, pns[-1], pns[-1], cfg.z_channels)) * 0.1).astype(np.float32)
    idx = data[f"idx_{si}"]
    h_j = jq.embed(params["quantize"], jnp.asarray(idx)).reshape(b, pns[si], pns[si], -1)
    want_f, want_n = jq.get_next_autoregressive_input(params["quantize"], cfg, si,
                                                      jnp.asarray(f_hat), h_j)
    h_t = tq.embed(vae.quantize, torch.from_numpy(idx)).reshape(b, pns[si], pns[si], -1)
    got_f, got_n = tq.get_next_autoregressive_input(vae.quantize, vae.cfg, si,
                                                    torch.from_numpy(f_hat), h_t)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(jq.phi_index(cfg, si)), tq.phi_index(vae.cfg, si))


def test_decode_loop_matches_fixture_steps():
    """The whole quantizer decode loop against the reference's recorded
    f_hat and next-input per step (vae_tiny.npz)."""
    data, cfg, _, _, vae = _vae_tiny()
    pns = cfg.v_patch_nums
    b = data["img"].shape[0]
    f_hat = torch.zeros(b, pns[-1], pns[-1], cfg.z_channels)
    for si, pn in enumerate(pns):
        h = tq.embed(vae.quantize, torch.from_numpy(data[f"idx_{si}"])).reshape(b, pn, pn, -1)
        f_hat, nxt = tq.get_next_autoregressive_input(vae.quantize, vae.cfg, si, f_hat, h)
        np.testing.assert_allclose(f_hat.numpy(), _nhwc(data[f"step_fhat_{si}"]),
                                   rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(nxt.numpy(), _nhwc(data[f"step_next_{si}"]),
                                   rtol=1e-4, atol=2e-5)


def test_fhat_to_img_matches_jax():
    data, cfg, _, params, vae = _vae_tiny()
    f_hat = _nhwc(data["f_hat_final"]).astype(np.float32)
    want = np.asarray(jvae.fhat_to_img(params, cfg, jnp.asarray(f_hat)))
    with torch.no_grad():
        got = tvae.fhat_to_img(vae, torch.from_numpy(f_hat)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _stage_cfg_c128():
    return VARConfig(num_classes=6, depth=2, embed_dim=128, num_heads=2,
                     patch_nums=(1, 2, 3, 4, 5, 6), vocab_size=32, z_channels=8,
                     attn_l2_norm=True, cond_drop_rate=0.0)


@pytest.mark.parametrize("which", ["c128", "tiny_l2", "tiny_saln"])
def test_transformer_stage_matches_jax(which):
    """Stage by stage over the whole pyramid, KV cache carried, fp32,
    against JAX ``transformer_stage`` with attn_impl="xla"."""
    if which == "c128":
        cfg = _stage_cfg_c128()
        params = jax.tree.map(np.asarray, jvar.init_var_params(jax.random.PRNGKey(0), cfg))
    else:
        cfg, sd = _var_tiny(which.split("_")[1])
        params = convert_var(sd, cfg)
    var = tvar.VAR(_torch_cfg(cfg))
    var.load_state_dict(var_state_dict(params, cfg))
    var.eval().requires_grad_(False)
    rng = np.random.default_rng(7)
    b = 2
    cond = rng.standard_normal((b, cfg.embed_dim)).astype(np.float32)
    ctx_j = jvar.cond_context(params, cfg, jnp.asarray(cond), decode=True)
    caches_j = None
    cache_t = tvar.init_prealloc_caches(var.cfg, b, torch.float32, "cpu")
    with torch.no_grad():
        ctx_t = tvar.cond_context(var, torch.from_numpy(cond), torch.float32)
        for si, pn in enumerate(cfg.patch_nums):
            x = rng.standard_normal((b, pn * pn, cfg.embed_dim)).astype(np.float32)
            want, caches_j = jvar.transformer_stage(params, cfg, jnp.asarray(x), ctx_j,
                                                    caches_j, dtype=jnp.float32,
                                                    attn_impl="xla")
            got, cache_t = tvar.transformer_stage(var, torch.from_numpy(x), ctx_t, cache_t,
                                                  torch.float32)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4,
                                       err_msg=f"stage {si}")
    assert cache_t.cum == cfg.seq_len


def _expected(sd):
    return {k: v for k, v in sd.items() if not any(b in k for b in DERIVED_BUFFERS)}


@pytest.mark.parametrize("tag", ["l2", "saln"])
def test_var_weights_carry_across_bit_exact(tag):
    """convert_var then the port's inverse gives back the reference state
    dict bit for bit, and it loads into the port's VAR strictly, for both
    list and depth-stacked blocks."""
    cfg, sd = _var_tiny(tag)
    want = _expected(sd)
    params = convert_var(sd, cfg)
    for tree in (params, jax.tree.map(np.asarray, jvar.stack_block_params(params))):
        got = var_state_dict(tree, cfg)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    tvar.VAR(_torch_cfg(cfg)).load_state_dict(got)


def test_vae_weights_carry_across_bit_exact():
    _, cfg, sd, params, _ = _vae_tiny()
    want = _expected(sd)
    got = vae_state_dict(params, cfg)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    tvae.VQVAE(_torch_cfg(cfg)).load_state_dict(got)  # strict: encoder side included


@pytest.mark.parametrize("tag", ["l2", "saln"])
def test_seeded_init_covers_every_parameter(tag):
    """The random init writes every parameter (the builder allocates them
    uninitialised), matches the JAX init's shapes, and is seeded."""
    cfg, sd = _var_tiny(tag)
    var = tvar.VAR(_torch_cfg(cfg))
    vae = tvae.VQVAE(_torch_cfg(VAEConfig(vocab_size=64, z_channels=8, ch=32,
                                          v_patch_nums=cfg.patch_nums)))
    for m in (var, vae):
        with torch.no_grad():
            for p in m.parameters():
                p.fill_(float("nan"))
    tvar.init_var_params(var, torch.Generator().manual_seed(0))
    tvae.init_vae_params(vae, torch.Generator().manual_seed(0))
    for m in (var, vae):
        for name, p in m.named_parameters():
            assert torch.isfinite(p).all(), name
    ref = var_state_dict(jax.tree.map(np.asarray, jvar.init_var_params(
        jax.random.PRNGKey(0), cfg)), cfg)
    assert {k: tuple(v.shape) for k, v in ref.items()} == \
        {k: tuple(v.shape) for k, v in var.state_dict().items()}
    again = tvar.init_var_params(tvar.VAR(_torch_cfg(cfg)), torch.Generator().manual_seed(0))
    for (k, a), b in zip(var.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
