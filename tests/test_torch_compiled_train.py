"""The compiled training, eval and FID programs (``engine/compiled.py`` with
``train=True``, ``engine/trainer.py``, ``engine/vae_trainer.py``,
``metrics/fid.py``) on the CPU, where each runs its capture-ready body
eagerly over its static buffers: the code a CUDA graph captures on the card.

Covered, against the JAX package's jitted programs on the same inputs:
(a) the compiled VAR step over three steps whose lr, wd and prog_wp differ,
at ac 1 and 2 and at one progressive stage, also bit for bit against its
own eager body; (b) the fp16=1 skip guard on a planted non-finite gradient
and the dscale=1 loss scale; (c) the tokenizer step across record_hit 100
and ``update_ema_hits`` on a device record_hit; (d) the eval step and both
FID extractors with a ragged last batch; (e) every body with host reads and
host-to-tensor constructors patched to raise; (f) a resumed state (the
optimizer's ``load_state_dict``) making a new entry.

Tolerances (those of ``tests/test_torch_train.py`` and
``tests/test_torch_vae_train.py``, stated at each test): loss and gradient
norm within 1e-5 relative of JAX, lr within 1e-6; parameters, where Adam
moves a weight by about lr * sign(g) a step and a last-bit difference in a
noise-level gradient can flip a move, within 2 lr a step summed, with the
share beyond 1e-3 of that under 1%; the compiled body against its eager
call, bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import _init_var, _port_vae as _port_frozen_vae
from tests.test_torch_train import _port_var, _tiny_var_cfg, _torch_args, _torch_cfg
from tests.test_torch_vae_train import CFG as VCFG
from tests.test_torch_vae_train import LR as VLR
from tests.test_torch_vae_train import RESO as VRESO
from tests.test_torch_vae_train import TCLIP as VTCLIP
from tests.test_torch_vae_train import _port_vae, _tcfg, _tiny_sd
from var_tpu.config import TrainArgs, VAEConfig
from var_tpu.engine import trainer as jtr
from var_tpu.engine import vae_trainer as jvt
from var_tpu.engine.convert import convert_vae
from var_tpu.metrics import fid as J
from var_tpu.models import quantizer as jq
from var_tpu_torch.engine import checkpoint as tckpt
from var_tpu_torch.engine import trainer as ttr
from var_tpu_torch.engine import vae_trainer as tvt
from var_tpu_torch.engine.convert import vae_state_dict, var_state_dict
from var_tpu_torch.metrics import fid as F
from var_tpu_torch.models import quantizer as tq
from var_tpu_torch.models import vae as tvae

torch.set_num_threads(2)

PNS = (1, 2, 3)
STEPS = ((3, 0.25), (7, 0.5), (12, 1.0))  # (g_it, prog_wp): lr, wd and prog_wp move


@pytest.fixture(scope="module")
def models():
    vae_cfg = VAEConfig(vocab_size=64, z_channels=8, ch=32, ch_mult=(1, 1), v_patch_nums=PNS)
    var_cfg = _tiny_var_cfg(patch_nums=PNS)
    vae = tvae.init_vae_params(tvae.VQVAE(_torch_cfg(vae_cfg)), torch.Generator().manual_seed(0))
    vae_params = convert_vae({k: v.numpy() for k, v in vae.state_dict().items()}, vae_cfg)
    return vae_cfg, var_cfg, vae_params, _init_var(1, var_cfg)


def _jargs(ac=1, **kw):
    return TrainArgs(depth=2, bs=4, ac=ac, ep=2, pn="1_2_3", tblr=0.5, pg=0.5, pg0=1,
                     pgwp=0.01, twde=0.01, **kw).finalize()


def _batches(var_cfg, vae_cfg, jargs, seed):
    b, reso = jargs.batch_size, var_cfg.patch_nums[-1] * vae_cfg.downsample
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1, 1, (jargs.ac, b, reso, reso, 3)).astype(np.float32),
             rng.integers(0, var_cfg.num_classes, (jargs.ac, b)).astype(np.int32))
            for _ in STEPS]


def _steps(models, jargs, prog_si=-1):
    vae_cfg, var_cfg, _, _ = models
    jinit, jstep = jtr.make_train_step(var_cfg, vae_cfg, jargs, 10, prog_si=prog_si,
                                       dtype=jnp.float32, attn_impl="xla")
    tinit, tstep = ttr.make_train_step(_torch_cfg(var_cfg), _torch_cfg(vae_cfg),
                                       _torch_args(jargs), 10, prog_si=prog_si,
                                       dtype=torch.float32)
    return jinit, jstep, tinit, tstep


def _equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Bit for bit, NaN where NaN (progressive training's unreached scales)."""
    return torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(), y.nan_to_num())


def _same(a, b) -> bool:
    return all(_equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(a, b))


def _params_close(var, jparams, var_cfg, lr_sum: float):
    """Every parameter within 2 lr a step (summed) of JAX's, and the share
    of elements beyond 1e-3 of that under 1%."""
    want = var_state_dict(jax.tree.map(np.asarray, jparams), var_cfg)
    beyond, total = 0, 0
    for name, p in var.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= 2 * lr_sum, (name, diff.max(), lr_sum)
        beyond, total = beyond + int((diff > 1e-3 * lr_sum).sum()), total + diff.size
    assert beyond / total < 0.01, beyond / total


# ---------------------------------------------------------------------------
# (a) the compiled VAR step against JAX's jitted make_train_step


@pytest.mark.parametrize("ac,prog_si", [(1, -1), (2, -1), (1, 1)])
def test_compiled_train_step_matches_jax(models, ac, prog_si):
    """Three steps with other g_it (lr and wd move) and prog_wp: loss and
    gradient norm within 1e-5 relative of JAX's, lr and wd within 1e-6;
    after them the parameters within 2 lr a step of JAX's. Each call reuses
    one entry, and equals the eager body on a copy of the state bit for
    bit (loss, metrics, parameters, moments and count)."""
    vae_cfg, var_cfg, vae_params, params = models
    jargs = _jargs(ac)
    jinit, jstep, tinit, tstep = _steps(models, jargs, prog_si)
    jstate = jinit(jax.tree.map(jnp.asarray, params))
    state, eager = tinit(_port_var(params, var_cfg)), tinit(_port_var(params, var_cfg))
    vae = _port_frozen_vae(vae_params, vae_cfg)
    lrs, wds = [], []
    for i, ((g_it, wp), (imgs, labels)) in enumerate(zip(STEPS, _batches(var_cfg, vae_cfg,
                                                                          jargs, ac + prog_si))):
        jstate, jm = jstep(jstate, vae_params, jnp.asarray(imgs), jnp.asarray(labels),
                           jax.random.PRNGKey(i), jnp.int32(g_it), jnp.float32(wp))
        args = (vae, torch.from_numpy(imgs), torch.from_numpy(labels).long(), None, g_it, wp)
        state, m = tstep(state, *args)
        eager, me = tstep.eager(eager, *args)
        assert float(m.loss) == pytest.approx(float(jm.loss), rel=1e-5), i
        assert float(m.grad_norm) == pytest.approx(float(jm.grad_norm), rel=1e-5), i
        assert m.lr == pytest.approx(float(jm.lr), rel=1e-6)
        assert m.wd == pytest.approx(float(jm.wd), rel=1e-6)
        assert _same(m, me), i
        lrs.append(m.lr)
        wds.append(m.wd)
    assert len(tstep.program.graphs) == 1 and state.step == 3
    assert len(set(lrs)) == len(set(wds)) == 3
    assert all(_equal(a, b) for a, b in zip(state.tensors(), eager.tensors()))
    assert float(state.opt.tensors()[0]) == 3.0
    _params_close(state.var, jstate.params, var_cfg, sum(lrs))


# ---------------------------------------------------------------------------
# (b) the fp16=1 guard and the dscale=1 loss scale


def _plant_nan(var, jparams):
    """A NaN in pos_start, on both sides: the loss and every gradient go
    non-finite."""
    with torch.no_grad():
        var.pos_start[0, 0, 0] = float("nan")
    return {**jparams, "pos_start": jparams["pos_start"].at[0, 0, 0].set(jnp.nan)}


@pytest.mark.parametrize("dscale", [0, 1])
def test_fp16_guard_skips_a_nonfinite_step_as_jax(models, dscale):
    """fp16=1: one finite step, then one with a planted non-finite
    gradient. On both sides the skipped step leaves the parameters, Adam's
    moments and its count (1) as they were; with dscale=1 the loss scale
    halves (2048 -> 1024) with its growth count at 0, as JAX's scaler."""
    vae_cfg, var_cfg, vae_params, params = models
    jargs = _jargs(fp16=1, dscale=dscale)
    jinit, jstep, tinit, tstep = _steps(models, jargs)
    jstate = jinit(jax.tree.map(jnp.asarray, params))
    state = tinit(_port_var(params, var_cfg))
    vae = _port_frozen_vae(vae_params, vae_cfg)
    batches = _batches(var_cfg, vae_cfg, jargs, 40)
    for i in range(2):
        (g_it, wp), (imgs, labels) = STEPS[i], batches[i]
        if i == 1:
            jstate = jstate._replace(params=_plant_nan(state.var, jstate.params))
            before = [t.clone() for t in (*state.var.parameters(), *state.opt.tensors())]
            jbefore = jax.tree.map(np.asarray, jstate.params)  # the step donates jstate
        jstate, jm = jstep(jstate, vae_params, jnp.asarray(imgs), jnp.asarray(labels),
                           jax.random.PRNGKey(i), jnp.int32(g_it), jnp.float32(wp))
        state, m = tstep(state, vae, torch.from_numpy(imgs), torch.from_numpy(labels).long(),
                         None, g_it, wp)
        assert float(m.scale) == float(jm.scale)
    assert not np.isfinite(float(jm.grad_norm)) and not torch.isfinite(m.grad_norm)
    for a, b in zip((*state.var.parameters(), *state.opt.tensors()), before):
        assert _equal(a, b)
    for new, old in zip(jax.tree.leaves(jstate.params), jax.tree.leaves(jbefore)):
        np.testing.assert_array_equal(np.asarray(new), old)
    adam = jstate.opt_state["adam"]
    assert int(adam.count) == int(float(state.opt.tensors()[0])) == 1
    if dscale:
        want = jstate.opt_state["scaler"]
        assert float(state.scaler["scale"]) == float(want["scale"]) == 1024.0
        assert int(state.scaler["growth_count"]) == int(want["growth_count"]) == 0
    else:
        assert state.scaler is None


# ---------------------------------------------------------------------------
# (c) the tokenizer step across record_hit 100, and update_ema_hits


def test_compiled_vae_step_across_record_hit_100_matches_jax():
    """Two steps from record_hit 99 and a seeded nonzero ema_hits, so that
    the EMA decay goes 0.9 -> 0.99 inside the compiled step: loss, recon
    and vq within 1e-4 relative of JAX's jitted step each step, ema_hits
    within 1 float32 ulp (XLA's fused multiply-add, as in
    test_vae_train_step_matches_jax), record_hit 101; the compiled call
    equals its eager body on a copy bit for bit."""
    sd = _tiny_sd(0)
    params = convert_vae(sd, VCFG)
    rng = np.random.default_rng(11)
    imgs = rng.uniform(-1, 1, (2, 2, VRESO, VRESO, 3)).astype(np.float32)
    ema0 = rng.uniform(0, 3, (len(VCFG.v_patch_nums), VCFG.vocab_size)).astype(np.float32)
    jinit, jstep = jvt.make_vae_train_step(VCFG, lr=VLR, tclip=VTCLIP)
    jstate = jinit(params)._replace(record_hit=jnp.int32(99), ema_hits=jnp.asarray(ema0))
    init, step = tvt.make_vae_train_step(_tcfg(VCFG), lr=VLR, tclip=VTCLIP, gn_impl="pallas")
    state, eager = init(_port_vae(sd)), init(_port_vae(sd))
    for s in (state, eager):
        s.record_hit.fill_(99)
        s.ema_hits.copy_(torch.from_numpy(ema0))
    for img in imgs:
        jstate, jm = jstep(jstate, jnp.asarray(img))
        state, m = step(state, torch.from_numpy(img))
        eager, me = step.eager(eager, torch.from_numpy(img))
        for k in ("loss", "recon", "vq"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
        assert all(torch.equal(m[k], me[k]) for k in m)
    np.testing.assert_allclose(state.ema_hits.numpy(), np.asarray(jstate.ema_hits),
                               rtol=2.0 ** -23, atol=0)
    assert int(state.record_hit) == int(jstate.record_hit) == 101
    assert len(step.program.graphs) == 1 and state.step == 2
    for a, b in zip(state.tensors(), eager.tensors()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("record_hit", [0, 1, 99, 100, 150])
def test_update_ema_hits_on_a_device_record_hit_matches_jax(record_hit):
    """The EMA update with record_hit an int32 tensor, as the compiled step
    passes it: JAX's values to 1 float32 ulp (its jit contracts to one
    fused multiply-add) at both sides of each decay switch."""
    rng = np.random.default_rng(record_hit)
    ema = rng.uniform(0, 5, (3, 16)).astype(np.float32)
    hits = rng.integers(0, 9, (3, 16)).astype(np.float32)
    want = jax.jit(jq.update_ema_hits)(jnp.asarray(ema), jnp.asarray(hits),
                                       jnp.int32(record_hit))
    got = tq.update_ema_hits(torch.from_numpy(ema), torch.from_numpy(hits),
                             torch.tensor(record_hit, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.0 ** -23, atol=0)


# ---------------------------------------------------------------------------
# (d) the eval step and the extractors


def test_compiled_eval_step_matches_jax(models):
    """Three calls on one entry (the last a padded batch: valid 1, 1, 0)
    against JAX's jitted make_eval_step: the five sums within 1e-4
    relative (test_eval_step_matches_jax's tolerance), and each equal to
    the eager body bit for bit."""
    vae_cfg, var_cfg, vae_params, params = models
    want_step = jtr.make_eval_step(var_cfg, vae_cfg, dtype=jnp.float32)
    got_step = ttr.make_eval_step(_torch_cfg(var_cfg), _torch_cfg(vae_cfg), dtype=torch.float32)
    var, vae = _port_var(params, var_cfg), _port_frozen_vae(vae_params, vae_cfg)
    rng = np.random.default_rng(8)
    for valid in ([1.0, 1.0, 1.0], [1.0, 0.0, 1.0], [1.0, 1.0, 0.0]):
        img = rng.uniform(-1, 1, (3, 6, 6, 3)).astype(np.float32)
        label = rng.integers(0, 10, (3,)).astype(np.int32)
        valid = np.asarray(valid, np.float32)
        want = want_step(params, vae_params, jnp.asarray(img), jnp.asarray(label),
                         jnp.asarray(valid))
        args = (var, vae, torch.from_numpy(img), torch.from_numpy(label).long(),
                torch.from_numpy(valid))
        got = got_step(*args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
        assert torch.equal(got, got_step.eager(*args))
    assert len(got_step.graphs) == 1


def _tiny_vae_cfgs():
    return (VAEConfig(vocab_size=32, z_channels=8, ch=32, ch_mult=(1, 1)),
            _tcfg(VAEConfig(vocab_size=32, z_channels=8, ch=32, ch_mult=(1, 1))))


@pytest.mark.parametrize("name", ["vae", "pixel"])
def test_compiled_extractors_match_jax_with_a_ragged_last_batch(name):
    """Batches of 3, 3 and a ragged 1: features within rtol 1e-5 / atol 1e-6
    of JAX's jitted extractor (test_torch_fid.py's FEAT_TOL), the ragged
    batch in an entry of its own, each call equal to the eager body bit
    for bit."""
    imgs = np.random.default_rng(12).integers(0, 256, (7, 32, 32, 3), dtype=np.uint8)
    if name == "vae":
        jcfg, tcfg_ = _tiny_vae_cfgs()
        from var_tpu.models import vae as jvae

        params = jvae.init_vae_params(jax.random.PRNGKey(3), jcfg)
        vae = tvae.VQVAE(tcfg_)
        vae.load_state_dict(vae_state_dict(jax.tree.map(np.asarray, params), jcfg))
        got, want = (F.make_vae_extractor(vae=vae, device="cpu"),
                     J.make_vae_extractor(vae_params=params, vae_cfg=jcfg))
    else:
        got, want = F.make_pixel_extractor(size=8, device="cpu"), J.make_pixel_extractor(size=8)
    for i in range(0, len(imgs), 3):
        chunk = imgs[i:i + 3]
        g = got(chunk)
        np.testing.assert_allclose(g, want(chunk), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(g, got.eager(chunk))
    assert sorted(e.signature[0][0][0] for e in got.program.graphs.values()) == [1, 3]


# ---------------------------------------------------------------------------
# (e) no host reads in any body


_HOST_READS = ("item", "__bool__", "__int__", "__float__", "tolist", "cpu", "numpy")
_HOST_WRITES = ("tensor", "as_tensor", "from_numpy", "bincount")


def _program(models, name):
    """(program, what holds its modules) of one compiled body, called once
    so that it has its entry: an entry holds its modules weakly, so the
    caller keeps them alive while it uses the entry."""
    vae_cfg, var_cfg, vae_params, params = models
    if name.startswith("var"):
        jargs = _jargs(ac=2, fp16=1, dscale=1) if name == "var_guarded_ac2" else _jargs()
        _, _, tinit, tstep = _steps(models, jargs, prog_si=1 if name == "var_prog" else -1)
        imgs, labels = _batches(var_cfg, vae_cfg, jargs, 3)[0]
        state, vae = tinit(_port_var(params, var_cfg)), _port_frozen_vae(vae_params, vae_cfg)
        tstep(state, vae, torch.from_numpy(imgs), torch.from_numpy(labels).long(), None, 5, 0.5)
        return tstep.program, (state, vae)
    if name == "vae":
        init, step = tvt.make_vae_train_step(_tcfg(VCFG), lr=VLR, tclip=VTCLIP, gn_impl="pallas")
        img = np.random.default_rng(2).uniform(-1, 1, (2, VRESO, VRESO, 3)).astype(np.float32)
        state = init(_port_vae(_tiny_sd(0)))
        step(state, torch.from_numpy(img))
        return step.program, state
    if name == "eval":
        step = ttr.make_eval_step(_torch_cfg(var_cfg), _torch_cfg(vae_cfg), dtype=torch.float32)
        var, vae = _port_var(params, var_cfg), _port_frozen_vae(vae_params, vae_cfg)
        step(var, vae, torch.rand(2, 6, 6, 3) * 2 - 1, torch.tensor([1, 2]), torch.ones(2))
        return step, (var, vae)
    imgs = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    ex = F.make_vae_extractor(vae_cfg=_tiny_vae_cfgs()[1], device="cpu") if name == "fid_vae" \
        else F.make_pixel_extractor(size=8, device="cpu")
    ex(imgs)
    return ex.program, ex


@pytest.mark.parametrize("name", ["var", "var_prog", "var_guarded_ac2", "vae", "eval",
                                  "fid_vae", "fid_pixel"])
def test_body_reads_nothing_back_to_the_host(models, monkeypatch, name):
    """Each body runs again on its entry's buffers with every way of reading
    a tensor on the host patched to raise, and every way of making a tensor
    from host data (and torch.bincount, which reads its input's range
    back on a GPU) too: a capture allows none of them."""
    program, _held = _program(models, name)
    (entry,) = program.graphs.values()

    def refuse(what):
        def raise_(*a, **k):
            raise AssertionError(f"the body called {what}")
        return raise_

    with monkeypatch.context() as m:
        for n in _HOST_READS:
            m.setattr(torch.Tensor, n, refuse(f"Tensor.{n}"))
        for n in _HOST_WRITES:
            m.setattr(torch, n, refuse(f"torch.{n}"))
        with torch.inference_mode(not program.train):
            entry.body()


# ---------------------------------------------------------------------------
# (f) entries: a resumed optimizer captures anew


def test_resumed_state_makes_a_new_entry(models, tmp_path):
    """An in-place parameter update keeps the step's entry; loading a
    checkpoint (the optimizer's load_state_dict makes new moment tensors)
    makes a new one, whose next step equals the uninterrupted run's bit for
    bit."""
    vae_cfg, var_cfg, vae_params, params = models
    jargs = _jargs()
    _, _, tinit, tstep = _steps(models, jargs)
    vae = _port_frozen_vae(vae_params, vae_cfg)
    batches = [(torch.from_numpy(i), torch.from_numpy(lb).long())
               for i, lb in _batches(var_cfg, vae_cfg, jargs, 9)]
    state = tinit(_port_var(params, var_cfg))
    state, _ = tstep(state, vae, *batches[0], None, 0, 1.0)
    (first,) = tstep.program.graphs.values()
    with torch.no_grad():
        next(state.var.parameters()).add_(0.0)
    path = str(tmp_path / "ar-ckpt-last.pth")
    tckpt.save_checkpoint(path, state, {"epoch": 0, "iter": 1})
    uninterrupted = copy.deepcopy(state)
    _, want = tstep.eager(uninterrupted, vae, *batches[1], None, 1, 1.0)
    state = tckpt.load_checkpoint(path, state)
    state, got = tstep(state, vae, *batches[1], None, 1, 1.0)
    (second,) = tstep.program.graphs.values()
    assert second is not first and second.key != first.key
    assert _same(got, want)
    for a, b in zip(state.tensors(), uninterrupted.tensors()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode,hw,out", [("bicubic", (3, 4), (16, 16)), ("bicubic", (16, 16), (5, 7)),
                                         ("area", (16, 13), (4, 5)), ("nearest", (4, 4), (8, 8))])
def test_resize_backward_is_the_operators_transpose(mode, hw, out):
    """``ops/resize.py`` takes a resize's gradient as two matrix products
    with the operator's own weights (the CUDA ``F.interpolate`` backward
    scatters with atomic adds, which a replay cannot hold bit for bit):
    forward bit for bit with ``F.interpolate``, the gradient within 1e-5 of
    its max|want| (another summation order)."""
    import torch.nn.functional as tF

    from var_tpu_torch.ops.resize import resize

    rng = np.random.default_rng(len(mode) + hw[0])
    x = torch.from_numpy(rng.standard_normal((2, *hw, 3)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((2, *out, 3)).astype(np.float32))
    y = resize(x, out, mode)
    (y * g).sum().backward()
    x2 = x.detach().clone().requires_grad_()
    kw = {"align_corners": False} if mode == "bicubic" else {}
    y2 = tF.interpolate(x2.permute(0, 3, 1, 2), size=out, mode=mode, **kw).permute(0, 2, 3, 1)
    (y2 * g).sum().backward()
    assert torch.equal(y, y2)
    assert float((x.grad - x2.grad).abs().max()) <= 1e-5 * float(x2.grad.abs().max())
