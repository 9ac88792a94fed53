"""The zero-shot apps' compiled programs (``engine/compiled.py``) on the
CPU, where each runs its capture-ready body eagerly over its static
buffers: the code a CUDA graph captures on the card.

Covered: box editing (``make_sampler(editing=True)``), the compiled smooth
sampler, the compiled tokenizer, the classifier's compiled scores and the
analysis app's ``make_score_fn``, each (a) against its JAX counterpart
jitted as the JAX apps jit it, (b) with every host read and host-to-tensor
constructor patched to raise, (c) over three calls on one entry's static
buffers against fresh eager calls, (d) re-keyed by another shape or other
modules but kept by an in-place update; (e) the three CLIs against the
eager functions they compile.

Models are the tiny fixture's (``var_tiny.npz``: depth 3, C 64, 4 heads,
V 64, pyramid 1-4); the CLIs run seeded random models at depth 2, pyramid
1-3. Tolerances: greedy tokens and ids equal; f_hat, scores and
log-likelihoods within rtol 1e-3 / atol 2e-4 of JAX; a body against the
eager function it compiles, bit for bit (the same code on the same
inputs).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from var_tpu.apps import analysis as janalysis
from var_tpu.apps import classify as jclf
from var_tpu.apps import masks as jmasks
from var_tpu.config import VAEConfig, VARConfig
from var_tpu.engine import sampler as jsampler
from var_tpu.engine.convert import convert_vae, convert_var
from var_tpu.models import quantizer as jq
from var_tpu.models import vae as jvae
from var_tpu_torch import config as tcfg
from var_tpu_torch.apps import analysis as tanalysis
from var_tpu_torch.apps import classify as tclf
from var_tpu_torch.apps.masks import get_edit_mask, keep_scales_mask
from var_tpu_torch.engine import sampler as tsampler
from var_tpu_torch.engine.compiled import Compiled
from var_tpu_torch.engine.convert import vae_state_dict, var_state_dict
from var_tpu_torch.models import quantizer as tq
from var_tpu_torch.models import vae as tvae
from var_tpu_torch.models import var as tvar

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "var_tiny.npz")
PNS = (1, 2, 3, 4)
RTOL, ATOL = 1e-3, 2e-4
SCORE_MODES = ("bayesian", "smooth_bayesian", "fast_neighbor_bayesian")
SCORE_CASES = ((0.0, False), (1.5, True))  # make_score_fn's (cfg_scale, l2_dist)


def _torch_cfg(cfg):
    cls = tcfg.VAEConfig if isinstance(cfg, VAEConfig) else tcfg.VARConfig
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__})


class Tiny:
    def __init__(self):
        data = np.load(FIXTURE)
        self.vae_cfg = VAEConfig(vocab_size=64, z_channels=8, ch=32, v_patch_nums=PNS)
        self.var_cfg = VARConfig(num_classes=10, depth=3, embed_dim=64, num_heads=4,
                                 attn_l2_norm=True, cond_drop_rate=0.0, patch_nums=PNS,
                                 vocab_size=64, z_channels=8)
        self.vae_params = convert_vae({k[7:]: data[k].astype(np.float32) for k in data.files
                                       if k.startswith("vae_sd/")}, self.vae_cfg)
        self.var_params = convert_var({k[len("l2/var_sd/"):]: data[k].astype(np.float32)
                                       for k in data.files if k.startswith("l2/var_sd/")},
                                      self.var_cfg)
        self.vae = tvae.VQVAE(_torch_cfg(self.vae_cfg))
        self.vae.load_state_dict(vae_state_dict(self.vae_params, self.vae_cfg))
        self.var = tvar.VAR(_torch_cfg(self.var_cfg))
        self.var.load_state_dict(var_state_dict(self.var_params, self.var_cfg))
        self.vae.eval().requires_grad_(False)
        self.var.eval().requires_grad_(False)
        self.gt = data["l2/gt_BL"]
        self.label = data["l2/label"]


@pytest.fixture(scope="module")
def tiny():
    return Tiny()


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _images(seed: int, b: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (b, 64, 64, 3)).astype(np.float32)


def _teacher_inputs(t, seed: int, b: int = 4):
    """A seeded image's ids (b, L) and teacher inputs (b, L - 1, Cvae), tiled
    over b classes, and b seeded labels, as numpy."""
    idx = jvae.img_to_idxBl(t.vae_params, t.vae_cfg, jnp.asarray(_images(seed, 1)))
    gt = np.tile(np.asarray(jnp.concatenate(idx, axis=1)), (b, 1))
    x_in = np.tile(np.asarray(jq.idxBl_to_var_input(t.vae_params["quantize"], t.vae_cfg, idx)),
                   (b, 1, 1))
    labels = np.random.default_rng(seed).integers(0, 10, b)
    return labels, x_in, gt


def _assert_same(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _editor(t, **kw):
    kw = {"cfg_scale": 4.0, "top_k": 1, "dtype": torch.float32, **kw}
    return tsampler.make_sampler(t.var.cfg, t.vae.cfg, device="cpu", editing=True, **kw)


def _score_program(t, kind: str) -> Compiled:
    """The classifier's ``_score`` for a mode, or ``make_score_fn``'s
    program for 'cfg{scale}_l2{0|1}'."""
    if kind in SCORE_MODES:
        return tclf.VARClassifier(t.var, t.vae, mode=kind, threshold=1.0, smooth_k=4)._score
    cfg_scale, l2 = SCORE_CASES[int(kind == "cfg1.5_l21")]
    return tanalysis.make_score_fn(t.var, t.vae, cfg_scale, l2).program


def _score_args(t, kind: str, inputs):
    labels, x_in, gt = (torch.from_numpy(a) for a in inputs)
    return ((t.var,) if kind in SCORE_MODES else (t.var, t.vae)) + (labels, x_in, gt)


SCORE_KINDS = SCORE_MODES + ("cfg0_l20", "cfg1.5_l21")
PROGRAMS = ("edit", "smooth_count", "smooth_threshold", "tokenizer") + SCORE_KINDS


def _program_and_args(t, name: str, seed: int):
    """A compiled program of this slice and the (modules, inputs) of one
    call of it, from a numpy seed."""
    rng = np.random.default_rng(seed)
    if name == "edit":
        y0, x0 = rng.uniform(0, 0.4, 2)
        em = get_edit_mask(PNS, y0, x0, y0 + 0.5, x0 + 0.5, inpainting=bool(seed % 2))
        return _editor(t, top_k=4, top_p=0.9, cfg_scale=1.5), (
            t.var, t.vae, rng.integers(0, 10, 2), t.gt, em)
    if name.startswith("smooth"):
        thr = None if name == "smooth_count" else 1.0
        prog = tsampler.make_smooth_sampler(16, neighbor_threshold=thr, dtype=torch.float32,
                                            device="cpu")
        gt = rng.integers(0, 64, t.gt.shape)
        return prog, (t.var, t.vae, torch.from_numpy(gt), torch.from_numpy(rng.integers(0, 10, 2)))
    if name == "tokenizer":
        return tvae.make_tokenizer("cpu"), (t.vae, torch.from_numpy(_images(seed)))
    return _score_program(t, name), _score_args(t, name, _teacher_inputs(t, seed))


def _call(name, prog, args, seed):
    """One call: (static outputs, the generator after it)."""
    if name == "edit":
        g = _gen(seed)
        return prog.static_decode(args[0], args[1], g, *args[2:]), g
    return prog.static(*args), None


def _eager(name, prog, args, seed):
    """The eager function the program compiles, on the same inputs."""
    if name == "edit":
        g = _gen(seed)
        var, vae, labels, gt, em = args
        with torch.inference_mode():
            res = tsampler.decode_cfg(var, vae, torch.as_tensor(labels), g, cfg_scale=1.5,
                                      top_k=4, top_p=0.9, dtype=torch.float32,
                                      gt_tokens=torch.as_tensor(gt),
                                      edit_mask=torch.as_tensor(em))
        return res, g
    return prog.eager(*args), None


def _leaves(res) -> list:
    return [res] if isinstance(res, torch.Tensor) else list(res)


def _entry(prog):
    graphs = prog.graphs
    assert len(graphs) == 1
    return next(iter(graphs.values()))


# ---------------------------------------------------------------------------
# (a) each compiled body against its JAX jitted counterpart


def test_box_edit_body_matches_jax_jit(tiny):
    t = tiny
    em = jmasks.get_edit_mask(PNS, 0.25, 0.25, 0.75, 0.75)
    fn = jax.jit(lambda vp, ve, rng, lab, gt, e: jsampler.decode_cfg(
        vp, ve, t.var_cfg, t.vae_cfg, rng, lab, cfg_scale=4.0, top_k=1, dtype=jnp.float32,
        gt_tokens=gt, edit_mask=e))
    want = fn(t.var_params, t.vae_params, jax.random.PRNGKey(0), jnp.asarray(t.label),
              jnp.asarray(t.gt), jnp.asarray(em))
    editor = _editor(t)
    got = editor(t.var, t.vae, _gen(0), t.label, t.gt, em)
    assert list(editor.graphs) == [(2, em.shape)]
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.f_hat.numpy(), np.asarray(want.f_hat), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("threshold", [None, 1.0])
def test_smooth_body_matches_jax_jit(tiny, threshold):
    t = tiny
    rng = np.random.default_rng(4)
    gt, labels = rng.integers(0, 64, t.gt.shape), rng.integers(0, 10, 2)
    fn = jax.jit(lambda vp, ve, g, lab: jsampler.smooth_sampling(
        vp, ve, t.var_cfg, t.vae_cfg, g, n=16, label_b=lab, cfg_scale=1.5,
        neighbor_threshold=threshold, dtype=jnp.float32))
    want = fn(t.var_params, t.vae_params, jnp.asarray(gt), jnp.asarray(labels))
    smooth = tsampler.make_smooth_sampler(16, neighbor_threshold=threshold, dtype=torch.float32,
                                          device="cpu")
    got = smooth(t.var, t.vae, torch.from_numpy(gt), torch.from_numpy(labels))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    for g, w in ((got.log_likelihood, want.log_likelihood),
                 (got.distance_log_likelihood, want.distance_log_likelihood)):
        assert g.shape == ()
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL)


def test_tokenizer_body_matches_jax_jit(tiny):
    t = tiny
    img = _images(6)
    want = jax.jit(lambda ve, x: jvae.img_to_idxBl(ve, t.vae_cfg, x))(t.vae_params,
                                                                     jnp.asarray(img))
    got = tvae.make_tokenizer("cpu")(t.vae, torch.from_numpy(img))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", SCORE_MODES)
def test_classifier_score_body_matches_jax_jit(tiny, mode):
    t = tiny
    kw = dict(mode=mode, threshold=1.0, smooth_k=4)
    inputs = _teacher_inputs(t, 7)
    want = jclf.VARClassifier(t.var_params, t.vae_params, t.var_cfg, t.vae_cfg,
                              **kw)._score(*(jnp.asarray(a) for a in inputs))
    clf = tclf.VARClassifier(t.var, t.vae, **kw)
    got = clf._score(t.var, *(torch.from_numpy(a) for a in inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cfg_scale,l2_dist", SCORE_CASES)
def test_analysis_score_fn_matches_jax_jit(tiny, cfg_scale, l2_dist):
    t = tiny
    inputs = _teacher_inputs(t, 8)
    want = janalysis.make_score_fn(t.var_params, t.vae_params, t.var_cfg, t.vae_cfg, cfg_scale,
                                   l2_dist)(*(jnp.asarray(a) for a in inputs))
    got = tanalysis.make_score_fn(t.var, t.vae, cfg_scale, l2_dist)(
        *(torch.from_numpy(a) for a in inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# (b) no host reads, (c) successive calls on static buffers


_HOST_READS = ("item", "__bool__", "__int__", "__float__", "tolist", "cpu", "numpy")
_HOST_WRITES = ("tensor", "as_tensor", "from_numpy")


@pytest.mark.parametrize("name", PROGRAMS)
def test_body_reads_nothing_back_to_the_host(tiny, monkeypatch, name):
    """The body completes with every way of reading a tensor's values on
    the host patched to raise, and every way of making a tensor from host
    data too: a capture allows neither."""
    prog, args = _program_and_args(tiny, name, 1)
    want = [t.clone() for t in _leaves(_call(name, prog, args, 3)[0])]
    entry = _entry(prog)

    def refuse(what):
        def raise_(*a, **k):
            raise AssertionError(f"the body called {what}")
        return raise_

    with monkeypatch.context() as m:
        for n in _HOST_READS:
            m.setattr(torch.Tensor, n, refuse(f"Tensor.{n}"))
        for n in _HOST_WRITES:
            m.setattr(torch, n, refuse(f"torch.{n}"))
        with torch.inference_mode():
            entry.body(_gen(3))
    _assert_same(entry.out, want)


@pytest.mark.parametrize("name", PROGRAMS)
def test_successive_calls_on_static_buffers_equal_fresh_eager_calls(tiny, name):
    """Three calls with other inputs (labels, boxes, images, ground truth,
    seeds) reuse one entry's buffers; each equals the eager function on
    the same inputs bit for bit, and leaves a generator where it does."""
    entries = []
    prog = None
    for i in range(3):
        p, args = _program_and_args(tiny, name, 10 + i)
        if prog is None:
            prog = p
        got, g = _call(name, prog, args, 20 + i)
        want, g_eager = _eager(name, prog, args, 20 + i)
        _assert_same(got, want)
        if g is not None:
            assert torch.equal(g.get_state(), g_eager.get_state())
        entries.append(_entry(prog))
    assert entries[0] is entries[1] is entries[2]


# ---------------------------------------------------------------------------
# (d) entries: another shape or other modules capture anew


def _sig(img):
    return ((tuple(img.shape), img.dtype),)


def test_other_shapes_or_modules_make_new_entries_in_place_updates_do_not(tiny):
    vae = copy.deepcopy(tiny.vae)
    tok = tvae.make_tokenizer("cpu")
    img2, img1 = torch.from_numpy(_images(1)), torch.from_numpy(_images(2, 1))
    tok(vae, img2)
    first = tok.graphs[_sig(img2)]
    tok(vae, img1)  # another shape: a second entry beside the first
    assert len(tok.graphs) == 2 and tok.graphs[_sig(img2)] is first
    with torch.no_grad():  # an in-place update keeps the addresses and the entry
        vae.quantize.embedding.weight.mul_(-1.0)
    got = tok(vae, img2)
    assert tok.graphs[_sig(img2)] is first
    _assert_same(got, tvae.img_to_idxBl(vae, img2))
    other = copy.deepcopy(vae)  # other modules: a new entry in the slot
    tok(other, img2)
    assert tok.graphs[_sig(img2)] is not first
    assert tok.graphs[_sig(img2)].modules[0] is other
    kept = tok.graphs[_sig(img2)]
    other.quantize.embedding.weight.data = other.quantize.embedding.weight.data.clone()
    tok(other, img2)  # a new address
    assert tok.graphs[_sig(img2)] is not kept


def test_score_batches_key_by_shape(tiny):
    """A ragged last batch of classes is a second entry of the classifier's
    score program, and the scores equal the eager ones."""
    clf = tclf.VARClassifier(tiny.var, tiny.vae, mode="bayesian")
    img = _images(3, 1)
    got = clf.class_likelihoods(img, list(range(10)), batch_size=4)
    assert sorted(k[0][0][0] for k in clf._score.graphs) == [2, 4]
    with torch.inference_mode():
        idx = tvae.img_to_idxBl(tiny.vae, torch.from_numpy(img))
        gt = torch.cat(idx, 1).expand(10, -1)
        x_in = tq.idxBl_to_var_input(tiny.vae.quantize, tiny.vae.cfg, idx).expand(10, -1, -1)
        want = clf._score_fn(tiny.var, torch.arange(10), x_in, gt)[0]
    np.testing.assert_array_equal(got, want.numpy())


def test_a_failing_body_raises_and_drops_its_entry(tiny):
    calls = []

    def body(vae, img):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("planted")
        return tvae.img_to_idxBl(vae, img)

    prog = Compiled(body, 1, "cpu")
    img = torch.from_numpy(_images(4))
    with pytest.raises(RuntimeError, match="planted"):
        prog(tiny.vae, img)
    assert prog.graphs == {}
    _assert_same(prog(tiny.vae, img), tvae.img_to_idxBl(tiny.vae, img))


# ---------------------------------------------------------------------------
# (e) the CLIs against the eager functions they compile


APP_ARGS = ["--device", "cpu", "--depth", "2", "--pn", "1_2_3", "--limit", "2"]


def _write_pngs(root):
    from PIL import Image

    rng = np.random.default_rng(0)
    for ci, cls in enumerate(("n01", "n02")):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i, (w, h) in enumerate(((70, 50), (48, 80), (64, 64))[ci:]):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                os.path.join(root, cls, f"{i}.png"))
    return root


def _cli_models(num_classes: int = 1000):
    """The CLIs' seeded random models (the classifier's CLI has as many
    classes as it scores)."""
    from var_tpu_torch.models import build_vae_var

    return build_vae_var(device="cpu", patch_nums=(1, 2, 3), depth=2, num_classes=num_classes,
                         dtype=torch.float32)


def _cli_images(root, n: int = 2):
    from var_tpu_torch.data.imagenet import FolderDataset, make_transform

    ds, tf = FolderDataset(root), make_transform(48, train=False)
    rng = np.random.default_rng(0)
    return [(torch.from_numpy(tf(p, rng))[None], lab) for p, lab in ds.samples[:n]]


def _png(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    return _write_pngs(str(tmp_path_factory.mktemp("pngs")))


INPAINT_MODES = {"keep": ["--keep_through", "1"], "box": ["--box", "0.25,0.25,0.75,0.75"],
                 "patch": ["--target_layer", "1", "--patches", "0,1", "--reverse"]}


@pytest.mark.parametrize("mode", sorted(INPAINT_MODES))
def test_inpaint_cli_equals_the_eager_decode(tmp_path, cli_root, mode):
    from var_tpu_torch.apps import inpaint
    from var_tpu_torch.apps.masks import generate_inpainting_mask
    from var_tpu_torch.apps.sample import save_grid

    inpaint.main(APP_ARGS + ["--data_path", cli_root, "--out_dir", str(tmp_path / "cli")]
                 + INPAINT_MODES[mode])
    _, _, vae, var = _cli_models()
    pns = (1, 2, 3)
    masks = {"keep": dict(keep_mask=torch.from_numpy(keep_scales_mask(pns, 1))[None]),
             "box": dict(edit_mask=torch.from_numpy(get_edit_mask(pns, .25, .25, .75, .75))),
             "patch": dict(keep_mask=torch.from_numpy(
                 generate_inpainting_mask(pns, 1, [(0, 1)], True))[None])}[mode]
    for idx, (img, lab) in enumerate(_cli_images(cli_root)):
        with torch.inference_mode():
            gt = torch.cat(tvae.img_to_idxBl(vae, img), dim=1)
            res = tsampler.decode_cfg(var, vae, torch.tensor([lab]), _gen(idx), cfg_scale=4.0,
                                      top_k=1, dtype=torch.float32, gt_tokens=gt, **masks)
        want = str(tmp_path / f"{idx}.png")
        save_grid(res.image.numpy(), want, per_row=1)
        assert _png(tmp_path / "cli" / f"{idx}_inpainted_{lab}.png") == _png(want)


def test_smooth_cli_equals_the_eager_smooth_sampling(tmp_path, cli_root, capsys):
    from var_tpu_torch.apps import smooth
    from var_tpu_torch.apps.sample import save_grid

    smooth.main(APP_ARGS + ["--data_path", cli_root, "--out_dir", str(tmp_path / "cli"),
                            "--n", "16", "--limit", "1"])
    printed = capsys.readouterr().out.strip().splitlines()
    _, _, vae, var = _cli_models()
    for idx, (img, lab) in enumerate(_cli_images(cli_root, 1)):
        with torch.inference_mode():
            gt = torch.cat(tvae.img_to_idxBl(vae, img), dim=1)
        res = tsampler.smooth_sampling(var, vae, gt, 16, torch.tensor([lab]),
                                       dtype=torch.float32)
        want = str(tmp_path / f"{idx}.png")
        save_grid(res.image.numpy(), want, per_row=1)
        assert _png(tmp_path / "cli" / f"{idx}_smoothed_{lab}.png") == _png(want)
        ll, dll = float(res.log_likelihood), float(res.distance_log_likelihood)
        assert printed[idx] == (f"[{idx}] label={lab} log_lik={ll:.2f} dist_log_lik={dll:.2f} "
                                f"sum={ll + dll:.2f}")


@pytest.mark.parametrize("mode,limit", [("bayesian", 2), ("gen", 1)])
def test_classify_cli_equals_the_eager_scores(tmp_path, cli_root, mode, limit):
    from var_tpu_torch.apps import classify

    out = tmp_path / "out"
    classify.main(["--device", "cpu", "--depth", "2", "--pn", "1_2_3", "--data_path", cli_root,
                   "--out_dir", str(out), "--num_classes", "4", "--batch_size", "3",
                   "--limit", str(limit), "--mode", mode])
    _, _, vae, var = _cli_models(num_classes=4)
    clf = tclf.VARClassifier(var, vae, mode=mode)
    for idx, (img, lab) in enumerate(_cli_images(cli_root, limit)):
        with torch.inference_mode():
            idx_bl = tvae.img_to_idxBl(vae, img)
            gt = torch.cat(idx_bl, dim=1)
            if mode == "bayesian":
                x_in = tq.idxBl_to_var_input(vae.quantize, vae.cfg, idx_bl)
                scores = torch.cat([clf._score_fn(var, torch.arange(b, min(b + 3, 4)),
                                                  x_in.expand(min(3, 4 - b), -1, -1),
                                                  gt.expand(min(3, 4 - b), -1))[0]
                                    for b in (0, 3)]).numpy()
            else:
                feat_in = clf._features(img)
                scores = []
                for c in range(4):
                    res = tsampler.decode_cfg(var, vae, torch.tensor([c]), _gen(0), top_k=1,
                                              dtype=torch.float32, gt_tokens=gt,
                                              keep_mask=torch.ones_like(gt, dtype=torch.bool))
                    scores.append(-float((feat_in - clf._features(res.image * 2 - 1))
                                         .abs().mean()))
        np.testing.assert_array_equal(clf.class_likelihoods(img, list(range(4)), 3), scores)
        rec = json.loads((out / f"{idx}.json").read_text())
        assert rec == {"pred": int(np.argmax(scores)), "label": lab}
