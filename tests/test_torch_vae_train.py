"""The port's tokenizer-training slice against the JAX package, on the CPU.

Same inputs (numpy, fixed seeds) go through the JAX function and its
counterpart in ``var_tpu_torch``'s plain PyTorch path: row 7's statistics
and their VJP (the JAX kernel in interpret mode, as ``test_vae_parity.py``
runs it), ``group_norm`` in its three impls, ``quantizer_forward``, the
training forward and its gradients for both ``gn_impl`` choices, three
``make_vae_train_step`` steps, the EMA bookkeeping and ``eini``. Tiny
configuration: ch 64 with ch_mult (1, 2) (2 and 4 channels per group),
V 32, Cvae 8, patch numbers (1, 2, 4) on 8x8 images. Each test states its
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from var_tpu.config import VAEConfig
from var_tpu.engine import vae_trainer as jvt
from var_tpu.engine.convert import convert_vae
from var_tpu.models import quantizer as jq
from var_tpu.models import vae as jvae
from var_tpu.ops.pallas.gn_stats import gn_channel_stats as jax_gn_channel_stats
from var_tpu_torch import config as tcfg
from var_tpu_torch.engine import vae_trainer as tvt
from var_tpu_torch.engine.convert import vae_state_dict
from var_tpu_torch.models import build_vae_train
from var_tpu_torch.models import quantizer as tq
from var_tpu_torch.models import vae as tvae
from var_tpu_torch.ops.cuda.gn_stats import gn_channel_stats, gn_channel_stats_plain

torch.set_num_threads(2)

CFG = VAEConfig(vocab_size=32, z_channels=8, ch=64, ch_mult=(1, 2), v_patch_nums=(1, 2, 4))
RESO = 8
LR, TCLIP = 3e-4, 2.0


def _tcfg(cfg):
    return tcfg.VAEConfig(**{f: getattr(cfg, f) for f in tcfg.VAEConfig.__dataclass_fields__})


def _bf16_ulp(x: float) -> float:
    return float(torch.finfo(torch.bfloat16).eps * 2.0 ** np.floor(np.log2(abs(x))))


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


# ---------------------------------------------------------------------------
# row 7 and group_norm


@pytest.mark.parametrize("shape", [(2, 12, 16, 32), (3, 15, 15, 7), (2, 7, 5, 3)])
def test_gn_channel_stats_and_vjp_match_jax(shape):
    """Sums and sums of squares, and the VJP for random cotangents, against
    JAX's kernel in interpret mode (NHWC there, NCHW here), at an even
    shape and two ragged ones with an odd C: fp32 within rtol 1e-5 + atol
    1e-5. The CPU never launches the kernel."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g_s, g_ss = (rng.standard_normal((shape[0], shape[3])).astype(np.float32) for _ in range(2))
    (want_s, want_ss), vjp = jax.vjp(jax_gn_channel_stats, jnp.asarray(x))
    (want_dx,) = vjp((jnp.asarray(g_s), jnp.asarray(g_ss)))

    xt = _nchw(x).requires_grad_()
    before = gn_channel_stats.launches
    s, ss = gn_channel_stats(xt)
    assert gn_channel_stats.launches == before
    ((s * torch.from_numpy(g_s)).sum() + (ss * torch.from_numpy(g_ss)).sum()).backward()
    for got, want in ((s, want_s), (ss, want_ss), (xt.grad, np.transpose(want_dx, (0, 3, 1, 2)))):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    plain = gn_channel_stats_plain(xt.detach())
    np.testing.assert_array_equal(plain[0].numpy(), s.detach().numpy())


def _gn_case(dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 12, 16, 64)) * 2 + 0.3).astype(np.float32)
    scale = (rng.standard_normal(64) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(64) * 0.1).astype(np.float32)
    norm = nn.GroupNorm(32, 64, eps=1e-6)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return x, {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, norm, jx


# bf16 "dot"/"xla" are F.group_norm, which applies the affine in float32 and
# rounds once; JAX rounds the folded scale and shift to bf16 first and then
# rounds the product and the sum: 2 bf16 ulps of max|want| cover both
GN_BF16_DOT_ULPS = 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dot", "xla", "pallas"])
def test_group_norm_matches_jax(impl, dtype):
    """The port's group_norm against JAX's with the same impl (32 groups of 2
    channels): fp32 within rtol 2e-5 + atol 2e-5 (test_vae_parity.py:146);
    bf16 "pallas" within 1 bf16 ulp of max|want| (both round the folded
    scale and shift to bf16 before applying them); bf16 "dot" and "xla"
    within GN_BF16_DOT_ULPS."""
    x, p, norm, jx = _gn_case(dtype)
    want = np.asarray(jvae.group_norm(p, jx, num_groups=32, eps=1e-6, impl=impl)
                      .astype(jnp.float32))
    xt = _nchw(x).to(getattr(torch, dtype))
    with torch.no_grad():
        got = tvae.group_norm(norm, xt, impl)
    assert got.dtype == xt.dtype
    got = np.transpose(got.float().numpy(), (0, 2, 3, 1))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        ulps = 1 if impl == "pallas" else GN_BF16_DOT_ULPS
        err, ulp = np.abs(got - want).max(), _bf16_ulp(np.abs(want).max())
        assert err <= ulps * ulp, f"{impl}: {err} > {ulps} ulps ({ulp})"


def test_group_norm_refuses_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        tvae.group_norm(nn.GroupNorm(2, 4), torch.zeros(1, 4, 2, 2), "fused")
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no quiet plain path
        gn_channel_stats(torch.empty(1, 4, 2, 2, device="meta"))


# ---------------------------------------------------------------------------
# the quantizer's training forward


def _tiny_sd(seed: int) -> dict:
    """Reference-named float32 state dict of a seeded tiny VQVAE, with a
    codebook of N(0, 0.5) so tokens spread over the vocabulary."""
    vae = tvae.init_vae_params(tvae.VQVAE(_tcfg(CFG)), torch.Generator().manual_seed(seed))
    sd = {k: v.numpy().copy() for k, v in vae.state_dict().items()}
    rng = np.random.default_rng(seed)
    sd["quantize.embedding.weight"] = (rng.standard_normal((CFG.vocab_size, CFG.z_channels))
                                       * 0.5).astype(np.float32)
    return sd


def _port_vae(sd) -> tvae.VQVAE:
    return build_vae_train(device="cpu", cfg=_tcfg(CFG),
                           state_dict={k: torch.from_numpy(v.copy()) for k, v in sd.items()})


def _rel_max(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_quantizer_forward_matches_jax():
    """Tokens and hits equal; f_hat and vq_loss within 1e-5; the gradients of
    sum(w * f_hat) + 3 vq_loss with respect to f, the codebook and each phi
    conv within 1e-4 of each tensor's max|want| (phi 2 is used by no scale
    of (1, 2, 4): zero on both sides)."""
    sd = _tiny_sd(1)
    params = convert_vae(sd, CFG)
    rng = np.random.default_rng(2)
    f = (rng.standard_normal((2, 4, 4, CFG.z_channels)) * 0.7).astype(np.float32)
    w = rng.standard_normal(f.shape).astype(np.float32)

    def jloss(p, f_):
        res = jq.quantizer_forward(p["quantize"], CFG, f_)
        return jnp.sum(res.f_hat * w) + 3.0 * res.vq_loss, res

    (_, jres), (jg, jgf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(f))
    want_g = vae_state_dict(jax.tree.map(np.asarray, jg), CFG)

    vae = _port_vae(sd)
    ft = torch.from_numpy(f).requires_grad_()
    res = tq.quantizer_forward(vae.quantize, vae.cfg, ft)
    ((res.f_hat * torch.from_numpy(w)).sum() + 3.0 * res.vq_loss).backward()
    for got, want in zip(res.idx_bl, jres.idx_bl):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(res.hits.numpy(), np.asarray(jres.hits))
    np.testing.assert_allclose(res.f_hat.detach().numpy(), np.asarray(jres.f_hat), atol=1e-5)
    assert float(res.vq_loss.detach()) == pytest.approx(float(jres.vq_loss), rel=1e-5)
    assert _rel_max(ft.grad.numpy(), np.asarray(jgf)) <= 1e-4
    for name, p in vae.quantize.named_parameters():
        want = want_g[f"quantize.{name}"].numpy()
        if p.grad is None:  # phi 2
            assert np.abs(want).max() == 0.0, name
            continue
        assert _rel_max(p.grad.numpy(), want) <= 1e-4, name


def test_update_ema_hits_and_vocab_usage_match_jax():
    """The EMA decay schedule (replace, 0.9 below 100 recorded steps, 0.99
    after) equals JAX's eagerly evaluated update bit for bit; the usage
    margin rule gives JAX's values (rtol 1e-6)."""
    rng = np.random.default_rng(3)
    ema = rng.uniform(0, 4, (3, 64)).astype(np.float32)
    hits = rng.integers(0, 9, (3, 64)).astype(np.float32)
    for rec in (0, 1, 99, 100, 150):
        want = np.asarray(jq.update_ema_hits(jnp.asarray(ema), jnp.asarray(hits), rec))
        got = tq.update_ema_hits(torch.from_numpy(ema), torch.from_numpy(hits), rec).numpy()
        np.testing.assert_array_equal(got, want)
    cfg = VAEConfig(vocab_size=64)
    for ws, tpi, b in ((1, 16, 4), (2, 256, 8)):
        want = np.asarray(jq.vocab_usage(jnp.asarray(ema), cfg, ws, tpi, b))
        got = tq.vocab_usage(torch.from_numpy(ema), _tcfg(cfg), ws, tpi, b).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _trunc_std(value: float, bound: float = 2.0) -> float:
    """Std of N(0, value^2) truncated to [-bound, bound]."""
    from math import erf, exp, pi, sqrt

    a = bound / value
    phi, big_phi = exp(-a * a / 2) / sqrt(2 * pi), 0.5 * (1 + erf(a / sqrt(2)))
    return value * sqrt(1 - 2 * a * phi / (2 * big_phi - 1))


@pytest.mark.parametrize("value", [0.02, 1.5, -0.5, 0.0])
def test_eini_bounds_and_moments_match_jax(value):
    """Codebook re-init, checked by distribution (the streams differ): the
    port's and JAX's draws over a 4096 x 32 codebook both lie within the
    bounds (|x| <= 2 for value > 0, |value| / V for value < 0), have mean
    within 0.01 std of 0 (3.6 standard errors) and std within 2% of the
    truncated normal's or uniform's; value 0 leaves the codebook."""
    v, c = 4096, 32
    quant = tq.VectorQuantizer2(tcfg.VAEConfig(vocab_size=v, z_channels=c))
    before = quant.embedding.weight.detach().clone()
    got = tq.eini(quant, torch.Generator().manual_seed(0), value).embedding.weight.detach().numpy()
    jparams = {"embedding": jnp.zeros((v, c))}
    want = np.asarray(jq.eini(jparams, jax.random.PRNGKey(0), value,
                              VAEConfig(vocab_size=v, z_channels=c))["embedding"])
    if value == 0:
        np.testing.assert_array_equal(got, before.numpy())
        return
    if value > 0:
        bound, std = 2.0, _trunc_std(value)
    else:
        bound = abs(value) / v
        std = bound / np.sqrt(3.0)
    for draw in (got, want):
        assert np.abs(draw).max() <= bound
        assert abs(draw.mean()) <= 0.01 * std
        assert abs(draw.std() / std - 1.0) <= 0.02


# ---------------------------------------------------------------------------
# the training forward, its gradients, and the train step


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's training loss, its parts, tokens, hits and gradients for one
    batch, and three make_vae_train_step steps, computed once."""
    sd = _tiny_sd(0)
    params = convert_vae(sd, CFG)
    rng = np.random.default_rng(7)
    imgs = rng.uniform(-1, 1, (4, 2, RESO, RESO, 3)).astype(np.float32)

    def loss_fn(p, img):
        out = jvae.vae_train_forward(p, CFG, img)
        recon = jnp.mean((out.recon - img) ** 2)
        return recon + out.vq_loss, (recon, out.vq_loss, out.hits, out.idx_bl)

    (loss, (recon, vq, hits, idx_bl)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, jnp.asarray(imgs[0]))
    fwd = {"loss": float(loss), "recon": float(recon), "vq": float(vq),
           "hits": np.asarray(hits), "idx_bl": [np.asarray(i) for i in idx_bl],
           "grads": vae_state_dict(jax.tree.map(np.asarray, grads), CFG)}
    init, step = jvt.make_vae_train_step(CFG, lr=LR, tclip=TCLIP)
    state = init(params)
    metrics = []
    for i in range(1, 4):
        state, m = step(state, jnp.asarray(imgs[i]))
        metrics.append({k: float(v) for k, v in m.items()})
    steps = {"metrics": metrics, "ema_hits": np.asarray(state.ema_hits),
             "record_hit": int(state.record_hit), "step": int(state.step),
             "params": vae_state_dict(jax.tree.map(np.asarray, state.params), CFG)}
    return sd, imgs, fwd, steps


@pytest.mark.parametrize("gn_impl", ["dot", "pallas"])
def test_vae_train_forward_and_grads_match_jax(jax_ref, gn_impl):
    """vae_train_forward (encode, STE quantizer with the commitment loss,
    decode) and its backward against jax.grad of JAX's loss (JAX's default
    GroupNorm): tokens and hits equal, recon and vq_loss within 1e-5
    relative, every parameter's gradient within 1e-4 of its tensor's
    max|want|. The per-tensor check catches a moved detach: with the STE
    written ``f_hat - sg(f) + f`` (its detach on f_hat dropped) this test
    fails at the codebook and phi gradients, and with the commitment
    term's ``mse(f_hat, f)`` (its detach on f dropped) at the encoder's:
    shown once with local mutations of quantizer_forward (worst relative
    gradient error 6.2 and 1.6, against 1e-4)."""
    sd, imgs, fwd, _ = jax_ref
    vae = _port_vae(sd)
    img = torch.from_numpy(imgs[0])
    out = tvae.vae_train_forward(vae, img, gn_impl)
    recon = ((out.recon - img) ** 2).mean()
    (recon + out.vq_loss).backward()
    for got, want in zip(out.idx_bl, fwd["idx_bl"]):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(out.hits.numpy(), fwd["hits"])
    assert float(recon.detach()) == pytest.approx(fwd["recon"], rel=1e-5)
    assert float(out.vq_loss.detach()) == pytest.approx(fwd["vq"], rel=1e-5)
    worst = {}
    for name, p in vae.named_parameters():
        want = fwd["grads"][name].numpy()
        if np.abs(want).max() == 0.0:  # phi 2: no scale of (1, 2, 4) uses it
            assert p.grad is None, name
            continue
        worst[name] = _rel_max(p.grad.numpy(), want)
    print({"gn_impl": gn_impl, "worst": max(worst.values()), "at": max(worst, key=worst.get)})
    assert max(worst.values()) <= 1e-4, {k: v for k, v in worst.items() if v > 1e-4}


def test_vae_train_step_matches_jax(jax_ref):
    """Three make_vae_train_step steps (clip active, Adam, EMA) from the same
    weights on the same images: each step's loss, recon and vq within 1e-4
    relative; record_hit and step equal; ema_hits within 1 float32 ulp
    (rtol 2^-23: inside its jitted step XLA contracts ema * decay + hits *
    (1 - decay) into one fused multiply-add, which rounds once where eager
    JAX and the port round twice; the update itself equals eager JAX's bit
    for bit, test above). Parameters: Adam moves a
    weight by about lr * sign(g) per step, so where |g| is at noise level a
    last-bit difference in g can flip a move; every element is within
    6 lr (three flipped steps) and the share beyond 1e-6 is printed and
    held under 1%."""
    sd, imgs, _, steps = jax_ref
    init, step = tvt.make_vae_train_step(_tcfg(CFG), lr=LR, tclip=TCLIP, gn_impl="pallas")
    state = init(_port_vae(sd))
    for i in range(1, 4):
        state, m = step(state, torch.from_numpy(imgs[i]))
        want = steps["metrics"][i - 1]
        for k in ("loss", "recon", "vq"):
            assert float(m[k]) == pytest.approx(want[k], rel=1e-4), (i, k)
    np.testing.assert_allclose(state.ema_hits.numpy(), steps["ema_hits"], rtol=2.0 ** -23,
                               atol=0)
    assert (state.record_hit, state.step) == (steps["record_hit"], steps["step"]) == (3, 3)
    beyond, total = 0, 0
    for name, p in state.vae.named_parameters():
        diff = np.abs(p.detach().numpy() - steps["params"][name].numpy())
        assert diff.max() <= 6 * LR, name
        beyond, total = beyond + int((diff > 1e-6).sum()), total + diff.size
    print({"params_beyond_1e-6": beyond / total})
    assert beyond / total < 0.01


# ---------------------------------------------------------------------------
# which GroupNorm runs where


@pytest.fixture
def counting(monkeypatch):
    """Counts calls of row 7's entry from the VQVAE functions, and whether
    each input was dense NCHW (what the kernel needs on the GPU)."""
    calls = []
    real = tvae.gn_channel_stats

    def counted(x):
        calls.append(x.is_contiguous())
        return real(x)

    monkeypatch.setattr(tvae, "gn_channel_stats", counted)
    return calls


def _num_group_norms(module: nn.Module) -> int:
    return sum(isinstance(m, nn.GroupNorm) for m in module.modules())


def test_gn_impl_dispatch(counting):
    """The default gn_impl never reaches row 7 (training forward, tokenizer,
    render); "pallas" reaches it once per GroupNorm layer, each time with a
    dense NCHW input, and the published ch160 tokenizer has 67 of them (39
    in the decoder)."""
    with torch.device("meta"):
        big = tvae.VQVAE(tcfg.VAEConfig())
    assert (_num_group_norms(big), _num_group_norms(big.decoder)) == (67, 39)
    vae = tvae.init_vae_params(tvae.VQVAE(_tcfg(CFG)), torch.Generator().manual_seed(0))
    img = torch.rand(2, RESO, RESO, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    f_hat = torch.randn(2, 4, 4, CFG.z_channels)
    with torch.no_grad():
        tvae.vae_train_forward(vae, img)
        tvae.img_to_idxBl(vae, img)
        tvae.fhat_to_img(vae, f_hat)
        assert counting == []
        tvae.vae_train_forward(vae, img, "pallas")
        assert len(counting) == _num_group_norms(vae) == 37
        tvae.fhat_to_img(vae, f_hat, "pallas")
        assert len(counting) == 37 + _num_group_norms(vae.decoder)
    assert all(counting)
    with pytest.raises(ValueError, match="gn_impl"):
        tvt.make_vae_train_step(_tcfg(CFG), gn_impl="fused")
