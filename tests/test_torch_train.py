"""The port's training slice against the JAX package, on the CPU.

Same inputs (numpy, fixed seeds, or the reference fixtures) go through the
JAX function and its counterpart in ``var_tpu_torch``'s plain PyTorch path.
The JAX training attention runs its Pallas kernels in interpret mode, as
``tests/test_flash_attention.py`` runs them. Each test states its tolerance.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synth_weights import synth_state_dict
from var_tpu.config import TrainArgs, VAEConfig, VARConfig
from var_tpu.engine import schedules as jsch
from var_tpu.engine import trainer as jtr
from var_tpu.engine.convert import convert_vae, convert_var
from var_tpu.models import quantizer as jq
from var_tpu.models import vae as jvae
from var_tpu.models import var as jvar
from var_tpu.ops.pallas.flash_attention import flash_attention_paired_train as jax_ptrain
from var_tpu_torch import config as tcfg
from var_tpu_torch.engine import checkpoint as tckpt
from var_tpu_torch.engine import schedules as tsch
from var_tpu_torch.engine import trainer as ttr
from var_tpu_torch.engine.convert import DERIVED_BUFFERS, vae_state_dict, var_state_dict
from var_tpu_torch.models import quantizer as tq
from var_tpu_torch.models import vae as tvae
from var_tpu_torch.models import var as tvar
from var_tpu_torch.ops.cuda.flash_attention import flash_attention_paired_train

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _torch_cfg(cfg):
    """The port's config with the same fields as a JAX config."""
    cls = tcfg.VAEConfig if isinstance(cfg, VAEConfig) else tcfg.VARConfig
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__})


def _torch_args(args):
    return tcfg.TrainArgs(**{f: getattr(args, f) for f in tcfg.TrainArgs.__dataclass_fields__
                             if hasattr(args, f)})


def _init_var(seed: int, cfg) -> dict:
    """A JAX VAR parameter tree from the port's seeded init (cheaper than
    tracing the JAX init), carried across by the JAX package's convert_var."""
    var = tvar.init_var_params(tvar.VAR(_torch_cfg(cfg)), torch.Generator().manual_seed(seed))
    return convert_var({k: v.numpy() for k, v in var.state_dict().items()}, cfg)


def _bf16_ulp(x: float) -> float:
    return float(torch.finfo(torch.bfloat16).eps * 2.0 ** np.floor(np.log2(abs(x))))


def _port_var(params, cfg) -> tvar.VAR:
    var = tvar.VAR(_torch_cfg(cfg))
    var.load_state_dict(var_state_dict(jax.tree.map(np.asarray, params), cfg))
    return var.train()


def _port_vae(params, cfg) -> tvae.VQVAE:
    vae = tvae.VQVAE(_torch_cfg(cfg))
    vae.load_state_dict(vae_state_dict(jax.tree.map(np.asarray, params), cfg))
    return vae.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# (a) the plain training attention and its hand-written backward


@pytest.mark.parametrize("dtype,heads,ends,block_q,block_k", [
    ("float32", 2, (1, 5, 14, 30, 55, 91), 32, 48),
    ("bfloat16", 4, (1, 5, 14, 30), 16, 16),
])
def test_paired_train_attention_matches_jax(dtype, heads, ends, block_q, block_k):
    """Values and dq/dk/dv of the plain forward (out, lse) and backward
    (recompute p from lse, delta) against JAX's kernels in interpret mode,
    with block sizes that straddle L. fp32: rtol 2e-5 + atol 2e-5 (the JAX
    kernel's own test against its dense path). bf16: within 2 bf16 ulps of
    max|want| -- both sides round p and ds to bf16, at different points of
    the online softmax."""
    b, l, c = 2, ends[-1], 64 * heads
    rng = np.random.default_rng(len(ends))
    q, k, v, do = (rng.standard_normal((b, l, c)).astype(np.float32) for _ in range(4))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def jfn(q_, k_, v_):
        return jax_ptrain(q_, k_, v_, heads, 0.125, ends, block_q=block_q, block_k=block_k)

    @jax.jit
    def ref(q_, k_, v_, do_):
        out_, vjp = jax.vjp(jfn, q_, k_, v_)
        return out_, vjp(do_)

    want_out, want_g = ref(*(jnp.asarray(a).astype(jdt) for a in (q, k, v, do)))
    tin = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = flash_attention_paired_train(*tin, heads, 0.125, ends)
    out.backward(torch.from_numpy(do).to(tdt))
    pairs = [("out", out.detach(), want_out)] + [
        (n, t.grad, g) for n, t, g in zip(("dq", "dk", "dv"), tin, want_g)]
    for name, got, want in pairs:
        got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5, err_msg=name)
        else:
            err, ulp = np.abs(got - want).max(), _bf16_ulp(np.abs(want).max())
            assert err <= 2 * ulp, f"{name}: {err} > 2 ulps ({ulp})"


# ---------------------------------------------------------------------------
# (b) the encode side of the tokenizer


def _fixture_vae(name):
    data = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    pns = tuple(data["patch_nums"].tolist())
    if name == "vae_tiny":
        cfg = VAEConfig(vocab_size=64, z_channels=8, ch=32, v_patch_nums=pns)
        sd = {k[3:]: data[k].astype(np.float32) for k in data.files if k.startswith("sd/")}
    else:
        cfg = VAEConfig(v_patch_nums=pns)
        sd = synth_state_dict(json.loads(bytes(data["keys_shapes_json"]).decode()))
    vae = tvae.VQVAE(_torch_cfg(cfg))
    vae.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                         if not any(b in k for b in DERIVED_BUFFERS)})
    return data, cfg, sd, vae.eval().requires_grad_(False)


@pytest.mark.parametrize("name", ["vae_tiny", "vae_prod"])
def test_encode_side_matches_fixture(name):
    """img_to_f, every scale's tokens and the teacher-forcing input against
    the reference fixture: features within 1e-4 (the JAX package's own
    tolerance there), tokens equal, var_input within 1e-4."""
    data, cfg, _, vae = _fixture_vae(name)
    rows = slice(0, 2 if name == "vae_tiny" else 1)  # one 256px image keeps the CPU time down
    img = torch.from_numpy(np.transpose(data["img"][rows], (0, 2, 3, 1)).copy())
    with torch.no_grad():
        f = tvae.img_to_f(vae, img)
        np.testing.assert_allclose(np.transpose(f.numpy(), (0, 3, 1, 2)), data["f"][rows],
                                   rtol=1e-4, atol=1e-4)
        idx_bl = tvae.img_to_idxBl(vae, img)
        for si, idx in enumerate(idx_bl):
            np.testing.assert_array_equal(idx.numpy(), data[f"idx_{si}"][rows],
                                          err_msg=f"scale {si}")
        fixture_idx = [torch.from_numpy(data[f"idx_{si}"]).long() for si in range(len(idx_bl))]
        x_in = tq.idxBl_to_var_input(vae.quantize, vae.cfg, fixture_idx)
    np.testing.assert_allclose(x_in.numpy(), data["var_input"], rtol=1e-4, atol=1e-4)


def test_encoder_weights_load_bit_for_bit():
    """A whole reference VQVAE state dict, encoder and quant_conv included,
    loads strictly into the port's VQVAE, bit for bit; the JAX tree carried
    across (vae_state_dict) gives the same tokens as the JAX tokenizer."""
    data, cfg, sd, vae = _fixture_vae("vae_tiny")
    got = vae.state_dict()
    for k, v in sd.items():
        if not any(b in k for b in DERIVED_BUFFERS):
            assert torch.equal(got[k], torch.from_numpy(v)), k
    params = convert_vae(sd, cfg)
    img = np.transpose(data["img"], (0, 2, 3, 1)).copy()
    want = jax.jit(jvae.img_to_idxBl, static_argnums=1)(params, cfg, jnp.asarray(img))
    got_idx = tvae.img_to_idxBl(_port_vae(params, cfg), torch.from_numpy(img))
    for w, g in zip(want, got_idx):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# (c) the teacher-forced forward and its gradients


@pytest.fixture(scope="module")
def c128():
    """JAX var_forward (attn_impl="paired", remat 2, fp32) loss and gradients
    at a head_dim-64 config, computed once for the module."""
    cfg = VARConfig(num_classes=10, depth=2, embed_dim=128, num_heads=2,
                    patch_nums=(1, 2, 3, 4, 5), vocab_size=32, z_channels=8,
                    attn_l2_norm=True, cond_drop_rate=0.0, drop_path_rate=0.0)
    params = _init_var(0, cfg)
    rng = np.random.default_rng(3)
    label = np.array([1, 7])
    x_in = rng.standard_normal((2, cfg.seq_len - 1, 8)).astype(np.float32)
    do = rng.standard_normal((2, cfg.seq_len, 32)).astype(np.float32)

    def loss(p):
        lg = jvar.var_forward(p, cfg, jnp.asarray(label), jnp.asarray(x_in), train=True,
                              dtype=jnp.float32, attn_impl="paired", remat=2)
        return jnp.sum(lg * do), lg

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return cfg, params, label, x_in, do, np.asarray(logits), var_state_dict(
        jax.tree.map(np.asarray, grads), cfg)


@pytest.mark.parametrize("remat", [0, 1, 2])
def test_var_forward_logits_and_grads_match_jax(c128, remat):
    """fp32 logits within 1e-4 and every parameter gradient within 1e-4 of
    its max|want| (measured ~1e-6: summation order only); the JAX side runs
    remat 2, which its own tests hold equal to remat 0."""
    cfg, params, label, x_in, do, want_logits, want_grads = c128
    var = _port_var(params, cfg)
    logits = tvar.var_forward(var, torch.from_numpy(label), torch.from_numpy(x_in), train=True,
                              dtype=torch.float32, remat=remat)
    (logits * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=1e-4, atol=1e-4)
    for name, p in var.named_parameters():
        want = want_grads[name].numpy()
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max() + 1e-12, f"{name}: {err}"


def test_cond_drop_and_drop_path_rates():
    """The RNG streams differ from JAX's, so these are checked by rate and
    scaling over a seeded batch of 20000: cond-drop replaces a share within
    0.02 of cond_drop_rate by the unconditional class; each drop-path mask
    is 0 or 1/keep with a keep share within 0.02 of keep and mean within 0.05 of 1."""
    cfg = tcfg.VARConfig(num_classes=10, depth=3, cond_drop_rate=0.3, drop_path_rate=0.4)
    g = torch.Generator().manual_seed(0)
    labels = torch.arange(20000) % 10
    dropped = tvar.cond_drop(cfg, labels, g)
    kept = dropped == labels
    assert torch.all(dropped[~kept] == cfg.num_classes)
    assert abs(float((~kept).float().mean()) - 0.3) < 0.02
    masks = tvar.drop_path_masks(cfg, 20000, g, "cpu")
    assert masks[0] is None  # rate 0 at the first block
    for rate, pair in zip((0.2, 0.4), masks[1:]):
        for m in pair:
            keep = 1.0 - rate
            assert m.shape == (20000, 1, 1)
            assert torch.all((m == 0) | torch.isclose(m, torch.tensor(1.0 / keep)))
            assert abs(float((m > 0).float().mean()) - keep) < 0.02
            assert abs(float(m.mean()) - 1.0) < 0.05


# ---------------------------------------------------------------------------
# (d)-(f) schedules, optimizer, loss and metrics


@pytest.mark.parametrize("sche", ["cos", "lin", "lin0", "lin00", "lin0.8", "exp"])
def test_schedules_match_jax(sche):
    """lr_factor and wd_value at iterations through warmup and decay, rtol 1e-6
    (JAX evaluates in float32)."""
    for it in (0, 3, 9, 10, 11, 40, 77, 99):
        want = float(jsch.lr_factor(sche, it, 10.0, 100.0, 0.005, 0.01))
        assert tsch.lr_factor(sche, it, 10.0, 100.0, 0.005, 0.01) == pytest.approx(want, rel=1e-6)
        want = float(jsch.wd_value(it, 100.0, 0.05, 0.01))
        assert tsch.wd_value(it, 100.0, 0.05, 0.01) == pytest.approx(want, rel=1e-6)
    with pytest.raises(NotImplementedError):
        tsch.lr_factor("nope", 0, 10.0, 100.0)


def _tiny_var_cfg(**kw):
    kw = {**dict(num_classes=10, depth=2, embed_dim=64, num_heads=4, patch_nums=(1, 2, 3),
                 vocab_size=64, z_channels=8, attn_l2_norm=True, cond_drop_rate=0.0,
                 drop_path_rate=0.0), **kw}
    return VARConfig(**kw)


def test_weight_decay_mask_names_match_jax():
    for saln in (False, True):
        cfg = _tiny_var_cfg(shared_aln=saln)
        params = _init_var(0, cfg)
        mask = jtr.weight_decay_mask(params)
        full = jax.tree.map(lambda m, p: np.full(p.shape, m), mask, params)
        want = {n: bool(t.all()) for n, t in var_state_dict(full, cfg).items()}
        assert ttr.weight_decay_mask(_port_var(params, cfg)) == want


@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_adamw_update_matches_jax(clip):
    """Two updates from seeded gradients (not at noise level): params within
    1e-6 relative + 1e-8 (a few float32 ulps at the weights' ~0.1 scale: the
    decay and the Adam step are summed in another order), and the pre-clip
    global norm within 1e-6."""
    cfg = _tiny_var_cfg()
    params = _init_var(1, cfg)
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32),
                          params) for _ in range(2)]
    gnorm0 = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                               for g in jax.tree.leaves(grads[0]))))
    tclip = 0.5 * gnorm0 if clip == "active" else 10.0 * gnorm0
    init, update = jtr.make_adamw(tclip)
    update = jax.jit(update)
    jp, js = params, init(params)
    var = _port_var(params, cfg)
    opt = ttr.make_adamw(var, tclip)
    for i, g in enumerate(grads):
        lr, wd = 1e-3 * (i + 1), 0.05
        jp, js, jnorm = update(g, js, jp, lr, wd)
        for name, t in var_state_dict(g, cfg).items():
            var.get_parameter(name).grad = t.clone()
        tnorm, stepped = opt.step(lr, wd, skip_nonfinite=True)
        assert stepped
        assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-6)
    want = var_state_dict(jax.tree.map(np.asarray, jp), cfg)
    for name, p in var.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=name)


def test_skipped_step_leaves_optimizer_untouched():
    """Under the fp16=1 guard a non-finite gradient norm skips the step:
    parameters, Adam's moments and its step count stay as they were."""
    var = _port_var(_init_var(2, _tiny_var_cfg()), _tiny_var_cfg())
    opt = ttr.make_adamw(var, 2.0)
    for p in var.parameters():
        p.grad = torch.full_like(p, 1e-3)
    opt.step(1e-3, 0.05, skip_nonfinite=True)
    before = {k: v.clone() for k, v in var.state_dict().items()}
    state = {id(p): {k: v.clone() for k, v in s.items()} for p, s in opt.opt.state.items()}
    next(var.parameters()).grad.fill_(float("inf"))
    gnorm, stepped = opt.step(1e-3, 0.05, skip_nonfinite=True)
    assert not stepped and not torch.isfinite(gnorm)
    for k, v in var.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, s in opt.opt.state.items():
        for k, v in s.items():
            assert torch.equal(v, state[id(p)][k]), k


@pytest.mark.parametrize("prog_si", [-1, 1])
def test_cross_entropy_and_metrics_match_jax(prog_si):
    """Label-smoothed cross entropy within 1e-5 and the step metrics (CE,
    accuracies, per-scale values, prediction histogram) within 1e-4."""
    cfg = _tiny_var_cfg()
    ed = cfg.seq_len if prog_si < 0 else cfg.begin_ends[prog_si][1]
    rng = np.random.default_rng(9)
    logits = (rng.standard_normal((3, ed, cfg.vocab_size)) * 3).astype(np.float32)
    gt = rng.integers(0, cfg.vocab_size, (3, ed))
    for ls in (0.0, 0.1):
        want = np.asarray(jtr.cross_entropy(jnp.asarray(logits), jnp.asarray(gt), ls))
        got = ttr.cross_entropy(torch.from_numpy(logits), torch.from_numpy(gt), ls).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = jtr._metrics_from_logits(jnp.asarray(logits), jnp.asarray(gt), cfg, prog_si)
    got = ttr._metrics_from_logits(torch.from_numpy(logits), torch.from_numpy(gt), cfg, prog_si)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (g) one whole training step


@pytest.fixture(scope="module")
def tiny_models():
    pns = (1, 2, 3)
    vae_cfg = VAEConfig(vocab_size=64, z_channels=8, ch=32, ch_mult=(1, 1), v_patch_nums=pns)
    var_cfg = _tiny_var_cfg(patch_nums=pns)
    vae = tvae.init_vae_params(tvae.VQVAE(_torch_cfg(vae_cfg)), torch.Generator().manual_seed(0))
    vae_params = convert_vae({k: v.numpy() for k, v in vae.state_dict().items()}, vae_cfg)
    params = _init_var(1, var_cfg)
    return vae_cfg, var_cfg, vae_params, params


@pytest.mark.parametrize("ac,prog_si", [(1, -1), (2, -1), (1, 1)])
def test_train_step_matches_jax(tiny_models, ac, prog_si):
    """One fp32 make_train_step step (tokenize, forward, backward, clip,
    AdamW) against JAX's: loss and gradient norm within 1e-5, and with
    ac 1 every gradient within 1e-4 of its max|want|. Updated parameters:
    Adam's first step moves each weight by lr * g / (|g| + eps), about
    lr * sign(g), so where |g| is at noise level a last-bit difference in g
    can flip the move; the tolerance is 1e-3 lr where JAX moved a weight by
    about lr (|g| >> eps) and 2 lr elsewhere."""
    vae_cfg, var_cfg, vae_params, params = tiny_models
    jargs = TrainArgs(depth=2, bs=4, ac=ac, ep=2, pn="1_2_3", tblr=0.5, pg=0.5, pg0=1,
                      pgwp=0.01).finalize()
    b, reso = jargs.batch_size, var_cfg.patch_nums[-1] * vae_cfg.downsample
    rng = np.random.default_rng(ac + prog_si)
    imgs = rng.uniform(-1, 1, (ac, b, reso, reso, 3)).astype(np.float32)
    labels = rng.integers(0, var_cfg.num_classes, (ac, b)).astype(np.int32)
    g_it, prog_wp = 3, 0.5
    jinit, jstep = jtr.make_train_step(var_cfg, vae_cfg, jargs, 10, prog_si=prog_si,
                                       dtype=jnp.float32, attn_impl="xla")
    jstate, jm = jstep(jinit(jax.tree.map(jnp.asarray, params)), vae_params, jnp.asarray(imgs),
                       jnp.asarray(labels), jax.random.PRNGKey(0), jnp.int32(g_it),
                       jnp.float32(prog_wp))

    tinit, tstep = ttr.make_train_step(_torch_cfg(var_cfg), _torch_cfg(vae_cfg),
                                       _torch_args(jargs), 10, prog_si=prog_si,
                                       dtype=torch.float32)
    state = tinit(_port_var(params, var_cfg))
    state, m = tstep(state, _port_vae(vae_params, vae_cfg), torch.from_numpy(imgs),
                     torch.from_numpy(labels).long(), None, g_it, prog_wp)
    assert float(m.loss) == pytest.approx(float(jm.loss), rel=1e-5)
    assert float(m.grad_norm) == pytest.approx(float(jm.grad_norm), rel=1e-5)
    assert m.lr == pytest.approx(float(jm.lr), rel=1e-6) and state.step == 1
    if ac == 1 and prog_si < 0:
        def loss(p):
            img = jnp.asarray(imgs[0])
            idx_bl = jvae.img_to_idxBl(vae_params, vae_cfg, img)
            x_in = jq.idxBl_to_var_input(vae_params["quantize"], vae_cfg, idx_bl)
            lg = jvar.var_forward(p, var_cfg, jnp.asarray(labels[0]), x_in, train=True,
                                  dtype=jnp.float32)
            ce = jtr.cross_entropy(lg, jnp.concatenate(idx_bl, 1), jargs.ls)
            return (ce / var_cfg.seq_len).sum(-1).mean()

        want_g = var_state_dict(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params)),
                                var_cfg)
        for name, p in state.var.named_parameters():
            want = want_g[name].numpy()
            assert np.abs(p.grad.numpy() - want).max() <= 1e-4 * np.abs(want).max() + 1e-12, name
    lr = float(jm.lr)
    want_p = var_state_dict(jax.tree.map(np.asarray, jstate.params), var_cfg)
    before = var_state_dict(params, var_cfg)
    decayed = ttr.weight_decay_mask(state.var)
    for name, p in state.var.named_parameters():
        want, old = want_p[name].numpy(), before[name].numpy()
        adam_move = np.abs(want - old * (1 - lr * float(jm.wd) * decayed[name]))
        tol = np.where(adam_move > 0.9 * lr, 1e-3 * lr, 2 * lr)
        assert np.all(np.abs(p.detach().numpy() - want) <= tol), name


def test_eval_step_matches_jax(tiny_models):
    """make_eval_step's five sums (with one padded row) within 1e-4 relative."""
    vae_cfg, var_cfg, vae_params, params = tiny_models
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (3, 6, 6, 3)).astype(np.float32)
    label = np.array([1, 4, 9], np.int32)
    valid = np.array([1.0, 1.0, 0.0], np.float32)
    want = jtr.make_eval_step(var_cfg, vae_cfg, dtype=jnp.float32)(
        params, vae_params, jnp.asarray(img), jnp.asarray(label), jnp.asarray(valid))
    got = ttr.make_eval_step(_torch_cfg(var_cfg), _torch_cfg(vae_cfg), dtype=torch.float32)(
        _port_var(params, var_cfg), _port_vae(vae_params, vae_cfg), torch.from_numpy(img),
        torch.from_numpy(label).long(), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_tokenize_options_and_grad_scaler(tiny_models):
    """tokenize_chunk gives the tokens of the whole batch; vae_bf16 gives
    valid tokens of the same shapes (rare near-tie flips are allowed); the
    dynamic loss scaler follows JAX's make_grad_scaler rules."""
    vae_cfg, _, vae_params, _ = tiny_models
    vae = _port_vae(vae_params, vae_cfg)
    img = torch.rand(4, 6, 6, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1
    whole = ttr.tokenize(vae, img, tcfg.TrainArgs())
    chunked = ttr.tokenize(vae, img, tcfg.TrainArgs(tokenize_chunk=2))
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))
    for a, b in zip(whole, ttr.tokenize(vae, img, tcfg.TrainArgs(vae_bf16=1))):
        assert a.shape == b.shape and int(b.min()) >= 0 and int(b.max()) < vae_cfg.vocab_size
    jinit, jupdate = jtr.make_grad_scaler(growth_interval=2)
    tinit, tupdate = ttr.make_grad_scaler(growth_interval=2)
    js, ts = jinit(), tinit()
    for finite in (True, True, True, False, True):
        js, ts = jupdate(js, jnp.bool_(finite)), tupdate(ts, finite)
        assert ts == {"scale": float(js["scale"]), "growth_count": int(js["growth_count"])}


# ---------------------------------------------------------------------------
# (h) checkpoints and the CLI smoke


def test_checkpoint_round_trip(tmp_path, tiny_models):
    vae_cfg, var_cfg, vae_params, params = tiny_models
    args = tcfg.TrainArgs(bs=2, ep=2, pn="1_2_3").finalize()
    init, step = ttr.make_train_step(_torch_cfg(var_cfg), _torch_cfg(vae_cfg), args, 10,
                                     dtype=torch.float32)
    state = init(_port_var(params, var_cfg))
    imgs = torch.rand(1, 2, 6, 6, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    state, _ = step(state, _port_vae(vae_params, vae_cfg), imgs, torch.tensor([[1, 2]]), None,
                    0, 1.0)
    path = str(tmp_path / "ar-ckpt-last.pth")
    tckpt.save_checkpoint(path, state, {"epoch": 1, "iter": 0})
    assert tckpt.auto_resume(str(tmp_path)) == (path, {"epoch": 1, "iter": 0})
    fresh = tckpt.load_checkpoint(path, init(_port_var(params, var_cfg)))
    assert fresh.step == state.step == 1
    for (k, a), b in zip(state.var.state_dict().items(), fresh.var.state_dict().values()):
        assert torch.equal(a, b), k
    for (pa, sa), (pb, sb) in zip(state.opt.opt.state.items(), fresh.opt.opt.state.items()):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert tckpt.auto_resume(str(tmp_path / "absent")) == (None, {})


def test_train_app_local_debug_on_cpu(tmp_path, capsys):
    from var_tpu_torch.apps.train import main

    main(["--local_debug=1", "--device", "cpu", "--bs", "4",
          "--local_out_dir_path", str(tmp_path)])
    out = capsys.readouterr().out
    assert "checkpoint round trip OK" in out and "smoke finished OK" in out
    assert out.count("prog_si 1") == 2  # progressive training at the first stage
    assert (tmp_path / "ar-ckpt-last.pth").is_file()
