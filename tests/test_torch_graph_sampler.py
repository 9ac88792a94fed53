"""The captured sampler's body (``engine/sampler.py::GraphDecode``) on the
CPU, where ``make_sampler`` runs it directly: the code a CUDA graph
captures on the card.

Models are the tiny fixture's (``var_tiny.npz``: depth 3, C 64, 4 heads,
V 64, pyramid 1-4). Greedy fp32 decodes are compared with JAX token for
token, f_hat within the parity contract's rtol 1e-3 / atol 2e-4; sampled
decodes of the body against fresh eager ``decode_cfg`` calls from the same
generator state, bit for bit (the same code on the same inputs).
"""

import copy
import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from var_tpu.config import VAEConfig, VARConfig
from var_tpu.engine import sampler as jsampler
from var_tpu.engine.convert import convert_vae, convert_var
from var_tpu_torch import config as tcfg
from var_tpu_torch.apps.masks import keep_scales_mask
from var_tpu_torch.engine import sampler as tsampler
from var_tpu_torch.engine.convert import vae_state_dict, var_state_dict
from var_tpu_torch.models import vae as tvae
from var_tpu_torch.models import var as tvar

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "var_tiny.npz")
PNS = (1, 2, 3, 4)
SAMPLED = dict(cfg_scale=1.5, top_k=4, top_p=0.9, dtype=torch.float32)


def _torch_cfg(cfg):
    cls = tcfg.VAEConfig if isinstance(cfg, VAEConfig) else tcfg.VARConfig
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__})


class Tiny:
    def __init__(self, tag: str):
        data = np.load(FIXTURE)
        self.vae_cfg = VAEConfig(vocab_size=64, z_channels=8, ch=32, v_patch_nums=PNS)
        self.var_cfg = VARConfig(num_classes=10, depth=3, embed_dim=64, num_heads=4,
                                 shared_aln=(tag == "saln"), attn_l2_norm=(tag == "l2"),
                                 cond_drop_rate=0.0, patch_nums=PNS, vocab_size=64,
                                 z_channels=8)
        self.vae_params = convert_vae({k[7:]: data[k].astype(np.float32) for k in data.files
                                       if k.startswith("vae_sd/")}, self.vae_cfg)
        pre = f"{tag}/var_sd/"
        self.var_params = convert_var({k[len(pre):]: data[k].astype(np.float32)
                                       for k in data.files if k.startswith(pre)}, self.var_cfg)
        self.vae = tvae.VQVAE(_torch_cfg(self.vae_cfg))
        self.vae.load_state_dict(vae_state_dict(self.vae_params, self.vae_cfg))
        self.var = tvar.VAR(_torch_cfg(self.var_cfg))
        self.var.load_state_dict(var_state_dict(self.var_params, self.var_cfg))
        self.vae.eval().requires_grad_(False)
        self.var.eval().requires_grad_(False)
        self.gt = data[f"{tag}/gt_BL"]
        self.label = data[f"{tag}/label"]


@pytest.fixture(scope="module")
def tiny():
    return Tiny("l2")


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _eager(t, var, labels, seed, gt=None, mask=None, **kw):
    g = _gen(seed)
    with torch.inference_mode():
        res = tsampler.decode_cfg(var, t.vae, torch.as_tensor(labels), g,
                                  gt_tokens=None if gt is None else torch.as_tensor(gt),
                                  keep_mask=None if mask is None else torch.as_tensor(mask),
                                  **kw)
    return res, g


def _assert_same(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tag", ["l2", "saln"])
def test_body_greedy_matches_jax_make_sampler(tag):
    t = Tiny(tag)
    jax_sampler = jsampler.make_sampler(t.var_cfg, t.vae_cfg, cfg_scale=1.5, top_k=1,
                                        top_p=0.0, dtype=jnp.float32)
    # JAX's make_sampler is jax.jit of its decode_cfg: both halves of the want
    want = jax_sampler(t.var_params, t.vae_params, jax.random.PRNGKey(0), jnp.asarray(t.label))
    sampler = tsampler.make_sampler(t.var.cfg, t.vae.cfg, cfg_scale=1.5, top_k=1, top_p=0.0,
                                    dtype=torch.float32, device="cpu")
    got = sampler(t.var, t.vae, _gen(0), t.label)
    entry = sampler.graphs[(len(t.label), False)]
    assert entry.graph is None and torch.equal(entry.out.tokens, got.tokens)  # the body ran
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.f_hat.numpy(), np.asarray(want.f_hat), rtol=1e-3, atol=2e-4)


BRANCHES = {  # name: make_sampler keywords
    "chunked": {},
    "prealloc": {"cache_impl": "prealloc"},
    "concat": {"cache_impl": "concat"},
    "kv_window": {"kv_window": 2},
    "more_smooth": {"more_smooth": True},
}


@pytest.mark.parametrize("inpainting", [False, True])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_successive_calls_on_static_buffers_equal_fresh_decodes(tiny, branch, inpainting):
    """Three calls at one batch size reuse one entry's buffers, with other
    labels, seeds and keep masks each time; each equals a fresh eager
    decode from the same generator state and leaves the generator where it
    does (stale cache rows, an f_hat not zeroed or a stale mask would
    show)."""
    kw = {**SAMPLED, **BRANCHES[branch]}
    sampler = tsampler.make_sampler(tiny.var.cfg, tiny.vae.cfg, device="cpu",
                                    inpainting=inpainting, **kw)
    rng = np.random.default_rng(5)
    masks = [np.tile(keep_scales_mask(PNS, 2)[None], (2, 1)), rng.random((2, 30)) < 0.5,
             np.zeros((2, 30), bool)]
    entries = []
    for i in range(3):
        labels = rng.integers(0, 10, 2)
        extra = (tiny.gt, masks[i]) if inpainting else ()
        g = _gen(10 + i)
        got = sampler(tiny.var, tiny.vae, g, labels, *extra)
        want, g_eager = _eager(tiny, tiny.var, labels, 10 + i, *extra, **kw)
        _assert_same(got, want)
        assert torch.equal(g.get_state(), g_eager.get_state())
        entries.append(sampler.graphs[(2, inpainting)])
    assert entries[0] is entries[1] is entries[2] and len(sampler.graphs) == 1


_HOST_READS = ("item", "__bool__", "__int__", "__float__", "tolist", "cpu", "numpy")
_HOST_WRITES = ("tensor", "as_tensor", "from_numpy")


@pytest.mark.parametrize("inpainting", [False, True])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_body_reads_nothing_back_to_the_host(tiny, monkeypatch, branch, inpainting):
    """The body completes with every way of reading a tensor's values on
    the host patched to raise, and every way of making a tensor from host
    data too: a capture allows neither a synchronising read nor a copy from
    pageable host memory."""
    kw = {**SAMPLED, **BRANCHES[branch]}
    sampler = tsampler.make_sampler(tiny.var.cfg, tiny.vae.cfg, device="cpu",
                                    inpainting=inpainting, **kw)
    extra = (tiny.gt, np.tile(keep_scales_mask(PNS, 2)[None], (2, 1))) if inpainting else ()
    want = sampler(tiny.var, tiny.vae, _gen(3), tiny.label, *extra)
    entry = sampler.graphs[(2, inpainting)]

    def refuse(name):
        def raise_(*a, **k):
            raise AssertionError(f"the decode body called {name}")
        return raise_

    with monkeypatch.context() as m:
        for name in _HOST_READS:
            m.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
        for name in _HOST_WRITES:
            m.setattr(torch, name, refuse(f"torch.{name}"))
        with torch.inference_mode():
            entry.body(_gen(3))
    _assert_same(entry.out, want)


def test_other_modules_rekey_in_place_updates_do_not(tiny):
    """Other modules, a parameter at a new address, or other TF32 switches
    make a new entry (a graph is bound to the pointers it captured); an
    in-place update of a parameter (what AdamW does) keeps the entry and
    the decode reads the new values."""
    sampler = tsampler.make_sampler(tiny.var.cfg, tiny.vae.cfg, device="cpu", **SAMPLED)
    other = copy.deepcopy(tiny.var)
    with torch.no_grad():
        other.head.weight.mul_(1.5)
    slot = (2, False)
    first = None
    for var in (tiny.var, other, tiny.var):
        got = sampler(var, tiny.vae, _gen(1), tiny.label)
        entry = sampler.graphs[slot]
        assert entry.var is var and entry is not first
        _assert_same(got, _eager(tiny, var, tiny.label, 1, **SAMPLED)[0])
        first = entry
    with torch.no_grad():  # an in-place update keeps the addresses
        other.head.weight.add_(0.25)
    sampler(other, tiny.vae, _gen(1), tiny.label)
    kept = sampler.graphs[slot]
    got = sampler(other, tiny.vae, _gen(1), tiny.label)
    assert sampler.graphs[slot] is kept
    _assert_same(got, _eager(tiny, other, tiny.label, 1, **SAMPLED)[0])
    other.head.weight.data = other.head.weight.data.clone()  # a new address
    sampler(other, tiny.vae, _gen(1), tiny.label)
    assert sampler.graphs[slot] is not kept
    kept = sampler.graphs[slot]
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = not tf32
        sampler(other, tiny.vae, _gen(1), tiny.label)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert sampler.graphs[slot] is not kept


def test_an_entry_dies_with_its_model(tiny):
    """A sampler's entry holds its model weakly: once the model is
    collected the entry is dead, its static buffers (and on the card its
    graph and pool) dropped, while the sampler lives on; a call with
    another model makes a new entry that decodes as the eager function."""
    sampler = tsampler.make_sampler(tiny.var.cfg, tiny.vae.cfg, device="cpu", **SAMPLED)
    other = copy.deepcopy(tiny.var)
    sampler(other, tiny.vae, _gen(1), tiny.label)
    entry = sampler.graphs[(2, False)]
    assert entry.var is other and not entry.dead and entry.out is not None
    del other
    gc.collect()
    assert entry.dead and entry.var is None and entry.vae is tiny.vae
    assert entry.out is None and entry.graph is None and entry.inputs == []
    got = sampler(tiny.var, tiny.vae, _gen(1), tiny.label)
    fresh = sampler.graphs[(2, False)]
    assert fresh is not entry and fresh.var is tiny.var and not fresh.dead
    _assert_same(got, _eager(tiny, tiny.var, tiny.label, 1, **SAMPLED)[0])


@pytest.mark.parametrize("branch", ["chunked", "more_smooth"])
def test_scan_rounds_equal_make_sampler_with_fold_in(tiny, branch):
    kw = {**SAMPLED, **BRANCHES[branch]}
    labels = np.asarray([[1, 2], [3, 0], [5, 5]])
    gen = _gen(9)
    state = gen.get_state().clone()
    scan = tsampler.make_scan_sampler(tiny.var.cfg, tiny.vae.cfg, rounds=3, device="cpu", **kw)
    got = scan(tiny.var, tiny.vae, gen, labels)
    assert torch.equal(gen.get_state(), state)  # the caller's generator is untouched
    assert list(scan.graphs) == [(2, False)]  # every round on one entry's buffers
    plain = tsampler.make_sampler(tiny.var.cfg, tiny.vae.cfg, device="cpu", **kw)
    for r in range(3):
        want = plain(tiny.var, tiny.vae, tsampler.fold_in(gen, r), labels[r])
        for a, b in zip(got, want):
            assert torch.equal(a[r], b)
