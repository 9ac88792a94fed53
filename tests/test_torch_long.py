"""The port's long-preset slice against the JAX package, on the CPU: the
streaming flash attention (row 5 of PERF.md's kernel table) and its VJP, the
dense ``xla`` attention, every ``attn`` x remat route of the training
forward, the eval step's attention choice, ``--attn`` and the tokenizer at
non-divisible patch numbers.

Inputs come from numpy seeds; weights carry across through the converters.
JAX runs its Pallas kernel in interpret mode, as ``tests/test_flash_attention.py``
does; the port's wrappers run their plain versions on CPU tensors. Each test
states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from var_tpu import config as jcfg
from var_tpu.engine import trainer as jtr
from var_tpu.engine.convert import convert_vae, convert_var
from var_tpu.models import vae as jvae
from var_tpu.models import var as jvar
from var_tpu.ops.attention import attention as jax_attention
from var_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from var_tpu.ops.resize import resize as jax_resize
from var_tpu_torch import config as tcfg
from var_tpu_torch.engine import trainer as ttr
from var_tpu_torch.engine.convert import vae_state_dict, var_state_dict
from var_tpu_torch.models import vae as tvae
from var_tpu_torch.models import var as tvar
from var_tpu_torch.ops import attention as tattn
from var_tpu_torch.ops.cuda import flash_attention as tfa
from var_tpu_torch.ops.resize import resize

torch.set_num_threads(2)

PNS6 = (1, 2, 3, 4, 5, 6)  # L 91
ENDS6 = (1, 5, 14, 30, 55, 91)


def _torch_cfg(cfg):
    cls = tcfg.VAEConfig if isinstance(cfg, jcfg.VAEConfig) else tcfg.VARConfig
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__})


def _init_var(seed: int, cfg) -> dict:
    """A JAX VAR parameter tree from the port's seeded init, carried across
    by the JAX package's convert_var."""
    var = tvar.init_var_params(tvar.VAR(_torch_cfg(cfg)), torch.Generator().manual_seed(seed))
    return convert_var({k: v.numpy() for k, v in var.state_dict().items()}, cfg)


def _port_var(params, cfg) -> tvar.VAR:
    var = tvar.VAR(_torch_cfg(cfg))
    var.load_state_dict(var_state_dict(jax.tree.map(np.asarray, params), cfg))
    return var.train()


def _bf16_ulp(x: float) -> float:
    return float(torch.finfo(torch.bfloat16).eps * 2.0 ** np.floor(np.log2(abs(x))))


def _qkv(seed, b, lq, lk, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, lq, h, d), (b, lk, h, d), (b, lk, h, d), (b, lq, h, d)))


# ---------------------------------------------------------------------------
# row 5 and the dense attention


FWD_CASES = {  # name: (B, Lq, Lk, H, D, ends, dtype)
    "block_causal": (2, 91, 91, 2, 16, ENDS6, "float32"),
    "unmasked_lq_ne_lk": (2, 24, 40, 2, 16, None, "float32"),
    "short_fp32": (2, 5, 5, 2, 16, (1, 5), "float32"),
    "short_bf16": (2, 5, 5, 2, 16, (1, 5), "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_attention_forward_matches_jax(case):
    """flash_attention against JAX's kernel (block sizes that straddle L)
    and, below 8 queries, its dense branch: fp32 within rtol 2e-5 + atol
    2e-5 (``test_flash_attention.py:28``); bf16 within 2 bf16 ulps of
    max|want| (both round the probabilities and the output to bf16)."""
    b, lq, lk, h, d, ends, dtype = FWD_CASES[case]
    q, k, v, _ = _qkv(lq + lk, b, lq, lk, h, d)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax_flash(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), scale=0.25,
                                scale_ends=ends, block_q=32, block_k=32).astype(jnp.float32))
    got = tfa.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), 0.25,
                              ends).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert np.abs(got - want).max() <= 2 * _bf16_ulp(np.abs(want).max())


def _jax_vjp(q, k, v, do, ends, dtype):
    jdt = jnp.dtype(dtype)

    def fn(q_, k_, v_):
        return jax_flash(q_, k_, v_, scale=0.25, scale_ends=ends, block_q=32, block_k=32)

    out, vjp = jax.vjp(fn, *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *vjp(jnp.asarray(do).astype(jdt)))]


def _port_vjp(q, k, v, do, ends, dtype):
    tdt = getattr(torch, dtype)
    tin = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*tin, 0.25, ends)
    out.backward(torch.from_numpy(do).to(tdt))
    return [t.float().numpy() for t in (out.detach(), *(x.grad for x in tin))]


@pytest.mark.parametrize("ends,lq,lk", [(ENDS6, 91, 91), (None, 24, 40)])
def test_flash_attention_vjp_matches_jax(ends, lq, lk):
    """dq, dk, dv of the plain backward (p recomputed from the lse, delta
    from the rounded output) against jax.vjp of JAX's kernel, fp32: rtol
    5e-4, atol 5e-5 (``test_flash_attention.py:75``)."""
    q, k, v, do = _qkv(lq * lk, 2, lq, lk, 2, 16)
    want = _jax_vjp(q, k, v, do, ends, "float32")
    got = _port_vjp(q, k, v, do, ends, "float32")
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-5, err_msg=name)


def test_flash_attention_bf16_matches_jax():
    """bf16 forward and backward within 2 bf16 ulps of each tensor's
    max|want|: both sides round p and ds to bf16 before their products, at
    different points of the online softmax."""
    q, k, v, do = _qkv(7, 2, 91, 91, 2, 16)
    want = _jax_vjp(q, k, v, do, ENDS6, "bfloat16")
    got = _port_vjp(q, k, v, do, ENDS6, "bfloat16")
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert np.abs(g - w).max() <= 2 * _bf16_ulp(np.abs(w).max()), name


def test_attention_xla_bf16_rounds_logits_as_jax():
    """The dense ``xla`` impl in bf16 against JAX's: the q k^T product is
    rounded to bf16 before the fp32 softmax (logits ~16 here, where that
    rounding moves a probability by up to ~6%). Within 1 bf16 ulp of
    max|want|; the fp32-logit oracle, which does not round, misses JAX by
    more than 4."""
    q, k, v, _ = _qkv(3, 2, 30, 30, 2, 16)
    q, k = q * 2.0, k * 2.0
    ends = (1, 5, 14, 30)
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_attention(*jin, 1.0, impl="xla", scale_ends=ends).astype(jnp.float32))
    tin = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = tattn.attention(*tin, 1.0, impl="xla", scale_ends=ends).float().numpy()
    oracle = tattn.attention_fp32_logits(*tin, 1.0, ends).float().numpy()
    ulp = _bf16_ulp(np.abs(want).max())
    assert np.abs(got - want).max() <= ulp
    assert np.abs(oracle - want).max() > 4 * ulp


def test_recompute_grad_bwd_fn_takes_the_other_backward():
    """recompute_grad keeps only its inputs, recomputes in backward and
    routes gradients to module parameters; with ``bwd_fn`` the backward is
    bwd_fn's: a deliberately different bwd_fn (2x) gives 2x the gradient
    while the forward value stays fn's."""
    lin = torch.nn.Linear(4, 3)
    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(0), requires_grad=True)

    def fn(mod, t):
        return torch.tanh(mod(t))

    want = fn(lin, x)
    gx, gw = torch.autograd.grad(want.sum(), (x, lin.weight))
    out = tattn.recompute_grad(fn)(lin, x)
    out.sum().backward()
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, gx, rtol=0, atol=0)
    torch.testing.assert_close(lin.weight.grad, gw, rtol=0, atol=0)
    x.grad, lin.weight.grad = None, None
    out = tattn.recompute_grad(fn, bwd_fn=lambda mod, t: 2.0 * fn(mod, t))(lin, x)
    out.sum().backward()
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(x.grad, 2.0 * gx, rtol=0, atol=0)
    torch.testing.assert_close(lin.weight.grad, 2.0 * gw, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the training forward: every attn x remat route


def _var_cfg(embed_dim: int = 128, pns=(1, 2, 3, 4)):
    """Two heads: head_dim 64 at embed 128 (paired runs on both sides), 16
    at embed 32 (paired degrades to xla on both sides)."""
    return jcfg.VARConfig(num_classes=10, depth=2, embed_dim=embed_dim, num_heads=2,
                          patch_nums=pns, vocab_size=32, z_channels=8, attn_l2_norm=True,
                          cond_drop_rate=0.0, drop_path_rate=0.0)


ROUTES = [  # (impl, remat, prog_si, embed_dim)
    ("paired", 0, -1, 128), ("paired", 2, -1, 128), ("paired", 0, -1, 32),
    ("pallas", 0, -1, 128), ("pallas", 1, -1, 128), ("pallas", 2, -1, 128),
    ("hybrid", 0, -1, 128), ("hybrid", 2, -1, 128),
    ("xla", 0, -1, 128), ("xla", 2, -1, 128),
    ("pallas", 2, 0, 128), ("pallas", 2, 1, 128),
]


@pytest.mark.parametrize("impl,remat,prog_si,embed_dim", ROUTES)
def test_var_forward_route_matches_jax(impl, remat, prog_si, embed_dim):
    """Logits and every parameter gradient of var_forward(attn_impl, remat,
    prog_si) against JAX's var_forward with the same arguments, fp32:
    logits within rtol/atol 1e-4 (``test_flash_attention.py:87``), each
    gradient within 1e-4 of its max|want| (summation order only)."""
    cfg = _var_cfg(embed_dim)
    params = _init_var(0, cfg)
    ed = cfg.seq_len if prog_si < 0 else cfg.begin_ends[prog_si][1]
    rng = np.random.default_rng(ed + remat)
    label = np.array([1, 7])
    x_in = rng.standard_normal((2, cfg.seq_len - 1, 8)).astype(np.float32)
    do = rng.standard_normal((2, ed, cfg.vocab_size)).astype(np.float32)

    def loss(p):
        lg = jvar.var_forward(p, cfg, jnp.asarray(label), jnp.asarray(x_in), train=True,
                              prog_si=prog_si, dtype=jnp.float32, attn_impl=impl, remat=remat)
        return jnp.sum(lg * do), lg

    (_, want_logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want_grads = var_state_dict(jax.tree.map(np.asarray, grads), cfg)
    var = _port_var(params, cfg)
    logits = tvar.var_forward(var, torch.from_numpy(label), torch.from_numpy(x_in), train=True,
                              prog_si=prog_si, dtype=torch.float32, remat=remat,
                              attn_impl=impl)
    (logits * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=1e-4,
                               atol=1e-4)
    for name, p in var.named_parameters():
        want = want_grads[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()  # unused at prog_si 0
        err = np.abs(got - want).max()
        assert err <= 1e-4 * np.abs(want).max() + 1e-12, f"{name}: {err}"


# (impl, remat, prog_si, embed_dim): launches of each entry point over one
# depth-2 forward and backward
DISPATCH = [
    ("paired", 0, -1, 128, dict(row6_fwd=2, row6_bwd=2)),
    ("paired", 1, -1, 128, dict(row6_fwd=4, row6_bwd=2)),
    ("paired", 2, -1, 128, dict(row6_fwd=4, row6_bwd=2)),
    ("paired", 0, -1, 32, dict(dense=2)),  # head_dim 16: degrades to xla
    ("pallas", 0, -1, 128, dict(row5_fwd=2, row5_bwd=2)),
    ("pallas", 1, -1, 128, dict(row5_fwd=4, row5_bwd=2)),
    ("pallas", 2, -1, 128, dict(row5_fwd=4, row5_bwd=2)),
    ("pallas", 2, 0, 128, dict(dense=4)),  # L 1 and L 5: below 8, the dense branch
    ("pallas", 2, 1, 128, dict(dense=4)),
    ("hybrid", 0, -1, 128, dict(dense=2)),  # no remat: the dense path
    ("hybrid", 1, -1, 128, dict(dense=4)),
    ("hybrid", 2, -1, 128, dict(row5_fwd=2, dense=2)),  # row 5 primal, dense backward
    ("xla", 0, -1, 128, dict(dense=2)),
    ("xla", 2, -1, 128, dict(dense=4)),
]


@pytest.mark.parametrize("impl,remat,prog_si,embed_dim,want", DISPATCH)
def test_attention_dispatch(monkeypatch, impl, remat, prog_si, embed_dim, want):
    """Which entry point each route of JAX's dispatch table reaches: the
    port's row 5 and row 6 forward and backward and the dense probabilities
    are wrapped with counters."""
    counts = dict.fromkeys(("row5_fwd", "row5_bwd", "row6_fwd", "row6_bwd", "dense"), 0)

    def counting(mod, attr, key):
        orig = getattr(mod, attr)

        def wrapped(*a, **kw):
            counts[key] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(mod, attr, wrapped)

    counting(tfa, "flash_attention_fwd", "row5_fwd")
    counting(tfa, "flash_attention_bwd", "row5_bwd")
    counting(tfa, "paired_train_fwd", "row6_fwd")
    counting(tfa, "paired_train_bwd", "row6_bwd")
    counting(tattn, "dense_probs", "dense")
    counting(tfa, "dense_probs", "dense")  # flash_attention's branch below 8 tokens
    cfg = _var_cfg(embed_dim)
    var = tvar.init_var_params(tvar.VAR(_torch_cfg(cfg)), torch.Generator().manual_seed(1))
    x_in = torch.randn(2, cfg.seq_len - 1, 8, generator=torch.Generator().manual_seed(2))
    logits = tvar.var_forward(var, torch.tensor([1, 2]), x_in, train=True, prog_si=prog_si,
                              dtype=torch.float32, remat=remat, attn_impl=impl)
    logits.square().sum().backward()
    assert counts == {**dict.fromkeys(counts, 0), **want}


def test_unknown_attn_impl_raises():
    cfg = _var_cfg()
    var = tvar.VAR(_torch_cfg(cfg))
    with pytest.raises(ValueError, match="impl"):
        tvar.var_forward(var, torch.tensor([1]), torch.zeros(1, cfg.seq_len - 1, 8),
                         dtype=torch.float32, attn_impl="flash")


# ---------------------------------------------------------------------------
# eval, --attn, and the tokenizer at the long presets' patch numbers


@pytest.mark.parametrize("train_attn", ["auto", "paired", "pallas", "hybrid", "xla"])
def test_pick_eval_attn_matches_jax(train_attn):
    for seq_len in (680, 1000, 1001, 2240, 9451):
        assert ttr.pick_eval_attn(train_attn, seq_len) == jtr.pick_eval_attn(train_attn, seq_len)


@pytest.fixture(scope="module")
def eval_models():
    vae_cfg = jcfg.VAEConfig(vocab_size=32, z_channels=8, ch=32, ch_mult=(1, 1),
                             v_patch_nums=(1, 2, 3, 4))
    var_cfg = _var_cfg()
    vae = tvae.init_vae_params(tvae.VQVAE(_torch_cfg(vae_cfg)), torch.Generator().manual_seed(0))
    vae_params = convert_vae({k: v.numpy() for k, v in vae.state_dict().items()}, vae_cfg)
    return vae_cfg, var_cfg, vae_params, _init_var(3, var_cfg)


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_eval_step_attn_matches_jax(eval_models, attn_impl):
    """make_eval_step(attn_impl) sums (one padded row) against JAX's, fp32,
    within 1e-4 relative: ``pallas`` is what pick_eval_attn gives a
    ``paired`` run beyond 1000 tokens, ``xla`` at 256px."""
    vae_cfg, var_cfg, vae_params, params = eval_models
    rng = np.random.default_rng(5)
    reso = var_cfg.patch_nums[-1] * 2
    img = rng.uniform(-1, 1, (3, reso, reso, 3)).astype(np.float32)
    label = np.array([1, 4, 9], np.int32)
    valid = np.array([1.0, 1.0, 0.0], np.float32)
    want = jtr.make_eval_step(var_cfg, vae_cfg, dtype=jnp.float32, attn_impl=attn_impl)(
        params, vae_params, jnp.asarray(img), jnp.asarray(label), jnp.asarray(valid))
    vae = tvae.VQVAE(_torch_cfg(vae_cfg))
    vae.load_state_dict(vae_state_dict(jax.tree.map(np.asarray, vae_params), vae_cfg))
    got = ttr.make_eval_step(_torch_cfg(var_cfg), _torch_cfg(vae_cfg), dtype=torch.float32,
                             attn_impl=attn_impl)(
        _port_var(params, var_cfg).eval(), vae.eval(), torch.from_numpy(img),
        torch.from_numpy(label).long(), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_train_args_attn_parsing_and_auto_resolution():
    """--attn parses as in the JAX CLI; auto resolves as train.py does in
    code (paired off the CPU, xla on it); an unknown value raises."""
    for argv in ([], ["--attn", "pallas"], ["--attn=hybrid"], ["--attn", "xla"]):
        assert tcfg.parse_cli(argv).attn == jcfg.parse_cli(argv).attn
    assert tcfg.TrainArgs().attn == jcfg.TrainArgs().attn == "auto"
    assert tcfg.resolve_attn("auto", "cpu") == "xla"
    assert tcfg.resolve_attn("auto", "cuda") == tcfg.resolve_attn("auto", "cuda:0") == "paired"
    for impl in ("xla", "pallas", "hybrid", "paired"):
        assert tcfg.resolve_attn(impl, "cpu") == tcfg.resolve_attn(impl, "cuda") == impl
    with pytest.raises(ValueError, match="attn"):
        tcfg.resolve_attn("flash", "cpu")


@pytest.mark.parametrize("pn", [9, 18, 24])
@pytest.mark.parametrize("mode", ["area", "bicubic"])
def test_resize_at_512px_ratios_matches_jax(pn, mode):
    """area 32 -> pn and bicubic pn -> 32, the 512px pyramid's
    non-divisible ratios, against JAX's resize matrices within 1e-5."""
    rng = np.random.default_rng(pn)
    src, dst = ((32, 32), (pn, pn)) if mode == "area" else ((pn, pn), (32, 32))
    x = rng.standard_normal((2, *src, 4)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), dst, mode))
    np.testing.assert_allclose(resize(torch.from_numpy(x), dst, mode).numpy(), want, rtol=0,
                               atol=1e-5)


def test_tokens_at_non_divisible_patch_nums_match_jax():
    """A tiny VQVAE at patch numbers (1, 2, 3, 4, 6, 9) -- 4/9 and 6/9 are
    not integer ratios, as 9, 18 and 24 of 32 at 512px -- tokenises seeded
    images to JAX's img_to_idxBl tokens exactly."""
    cfg = jcfg.VAEConfig(vocab_size=64, z_channels=8, ch=32, ch_mult=(1, 1),
                         v_patch_nums=(1, 2, 3, 4, 6, 9))
    vae = tvae.init_vae_params(tvae.VQVAE(_torch_cfg(cfg)), torch.Generator().manual_seed(4))
    params = convert_vae({k: v.numpy() for k, v in vae.state_dict().items()}, cfg)
    img = np.random.default_rng(6).uniform(-1, 1, (3, 18, 18, 3)).astype(np.float32)
    want = jax.jit(jvae.img_to_idxBl, static_argnums=1)(params, cfg, jnp.asarray(img))
    got = tvae.img_to_idxBl(vae.eval(), torch.from_numpy(img))
    for si, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"scale {si}")
