"""The port's zero-shot slice against the JAX package, on the CPU:
inpainting, box editing, ``kv_window`` pruning and the cache
representations, smooth sampling and the neighbour tables, the scan
sampler, the tokenizer's round trips, the classifier, the masks, the eval
data transforms, the decode kernel of row 4 (``flash_decode_paired``) and
the three apps.

Models are the tiny fixture's (``var_tiny.npz``: depth 3, C 64, 4 heads,
V 64, pyramid 1-4), carried across with the JAX package's ``convert_*``
and the port's ``*_state_dict``. Inputs come from numpy seeds. Tolerances
are the parity contract's: greedy fp32 decodes token-equal, f_hat within
1e-4 and images within 1e-3 of JAX (the existing decode tests' bounds);
scores and log-likelihoods within rtol 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from var_tpu.apps import classify as jclf
from var_tpu.apps import masks as jmasks
from var_tpu.config import VAEConfig, VARConfig
from var_tpu.data import imagenet as jdata
from var_tpu.engine import sampler as jsampler
from var_tpu.engine.convert import convert_vae, convert_var
from var_tpu.models import quantizer as jq
from var_tpu.models import vae as jvae
from var_tpu.ops.pallas.flash_attention import flash_decode_paired as jax_decode_paired
from var_tpu.ops.resize import resize_bilinear as jax_resize_bilinear
from var_tpu_torch import config as tcfg
from var_tpu_torch.apps import classify as tclf
from var_tpu_torch.apps import masks as tmasks
from var_tpu_torch.data import imagenet as tdata
from var_tpu_torch.engine import sampler as tsampler
from var_tpu_torch.engine.convert import vae_state_dict, var_state_dict
from var_tpu_torch.models import quantizer as tq
from var_tpu_torch.models import vae as tvae
from var_tpu_torch.models import var as tvar
from var_tpu_torch.ops.cuda.flash_attention import flash_decode_paired, flash_decode_paired_plain
from var_tpu_torch.ops.resize import resize_bilinear

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "var_tiny.npz")
PNS = (1, 2, 3, 4)


def _torch_cfg(cfg):
    cls = tcfg.VAEConfig if isinstance(cfg, VAEConfig) else tcfg.VARConfig
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__})


class Tiny:
    """Both packages' tiny models, the fixture's two images, their tokens
    and labels."""

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
        self.img = np.transpose(data[f"{tag}/img"], (0, 2, 3, 1)).astype(np.float32)
        self.gt = data[f"{tag}/gt_BL"]
        self.label = data[f"{tag}/label"]

    def jax_decode(self, cfg_scale=4.0, **kw):
        kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        return jsampler.decode_cfg(self.var_params, self.vae_params, self.var_cfg, self.vae_cfg,
                                   jax.random.PRNGKey(0), jnp.asarray(self.label),
                                   cfg_scale=cfg_scale, top_k=1, dtype=jnp.float32, **kw)

    def port_decode(self, cfg_scale=4.0, **kw):
        kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
        return tsampler.decode_cfg(self.var, self.vae, torch.from_numpy(self.label),
                                   torch.Generator().manual_seed(0), cfg_scale=cfg_scale,
                                   top_k=1, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def tiny():
    return Tiny("l2")


@pytest.fixture(scope="module")
def tiny_saln():
    return Tiny("saln")


def _assert_decodes_equal(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.f_hat.numpy(), np.asarray(want.f_hat), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image), rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# masks


MASK_CASES = {
    "keep_through_0": ("keep_scales_mask", (PNS, 0)),
    "keep_through_2": ("keep_scales_mask", (PNS + (6, 8), 2)),
    "patch": ("generate_inpainting_mask", (PNS, 1, [(0, 1)])),
    "patches_reverse": ("generate_inpainting_mask", ((1, 2, 3, 5, 8), 2, [(0, 1), (2, 2)], True)),
    "edit_inpaint": ("get_edit_mask", (PNS + (13, 16), 0.25, 0.25, 0.75, 0.75)),
    "edit_outpaint": ("get_edit_mask", (PNS, 0.1, 0.3, 0.6, 0.9, False)),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_masks_equal_jax(case):
    name, args = MASK_CASES[case]
    got, want = getattr(tmasks, name)(*args), getattr(jmasks, name)(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# decode branches: greedy fp32, token-equal to the JAX package


INPAINT_MASKS = {
    "keep_scales": lambda: jmasks.keep_scales_mask(PNS, 1),
    "patch": lambda: jmasks.generate_inpainting_mask(PNS, 1, [(0, 1)]),
    "patches_reverse": lambda: jmasks.generate_inpainting_mask(PNS, 1, [(0, 1), (1, 0)], True),
}


@pytest.mark.parametrize("mask", sorted(INPAINT_MASKS))
def test_inpainting_decode_matches_jax(tiny, mask):
    keep = np.tile(INPAINT_MASKS[mask]()[None], (2, 1))
    want = tiny.jax_decode(gt_tokens=tiny.gt, keep_mask=keep)
    got = tiny.port_decode(gt_tokens=tiny.gt, keep_mask=keep)
    _assert_decodes_equal(got, want)
    np.testing.assert_array_equal(got.tokens.numpy()[keep], tiny.gt[keep])


@pytest.mark.parametrize("inpainting", [True, False])
def test_box_edit_decode_matches_jax(tiny, inpainting):
    em = jmasks.get_edit_mask(PNS, 0.25, 0.25, 0.75, 0.75, inpainting=inpainting)
    for pn in PNS:  # the per-scale keep regions agree exactly
        want = np.asarray(jax_resize_bilinear(jnp.asarray(em)[None, :, :, None], (pn, pn)) > 0.5)
        got = resize_bilinear(torch.from_numpy(em)[None, :, :, None], (pn, pn)) > 0.5
        np.testing.assert_array_equal(got.numpy(), want)
    want = tiny.jax_decode(gt_tokens=tiny.gt, edit_mask=em)
    got = tiny.port_decode(gt_tokens=tiny.gt, edit_mask=em)
    _assert_decodes_equal(got, want)


def test_full_keep_edit_reproduces_the_reconstruction(tiny):
    em = jmasks.get_edit_mask(PNS, 0.0, 0.0, 1.0, 1.0, inpainting=False)
    got = tiny.port_decode(gt_tokens=tiny.gt, edit_mask=em)
    idx_bl = [torch.from_numpy(tiny.gt[:, b:e]) for b, e in tiny.var_cfg.begin_ends]
    want = tvae.idxBl_to_img(tiny.vae, idx_bl) * 0.5 + 0.5
    np.testing.assert_allclose(got.image.numpy(), want.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("jax_cache", ["concat", "chunked"])
@pytest.mark.parametrize("kv_window", [1, 2, len(PNS)])
def test_kv_window_decode_matches_jax(tiny, kv_window, jax_cache):
    want = tiny.jax_decode(cfg_scale=1.5, kv_window=kv_window, cache_impl=jax_cache)
    got = tiny.port_decode(cfg_scale=1.5, kv_window=kv_window, cache_impl=jax_cache)
    _assert_decodes_equal(got, want)
    if kv_window == len(PNS):  # the whole pyramid: the unpruned decode
        base = tiny.port_decode(cfg_scale=1.5)
        np.testing.assert_array_equal(got.tokens.numpy(), base.tokens.numpy())


def test_kv_window_keeps_the_window_contiguous(monkeypatch, tiny):
    """Each stage attends to exactly stage 0 plus the window's stages: the
    rows [0, lk) it reads hold those stages' keys, in order."""
    lens = [pn * pn for pn in PNS]
    full, seen = [], []
    real = tvar.flash_decode_paired

    def spy(q, k, v, h, scale, lk=None, **kw):
        seen.append(k[:, :lk].clone())
        return real(q, k, v, h, scale, lk=lk, **kw)

    monkeypatch.setattr(tvar, "flash_decode_paired", spy)
    tiny.port_decode(cfg_scale=1.5, cache_impl="prealloc")
    full = seen[tiny.var_cfg.depth * (len(PNS) - 1)]  # layer 0, last stage: every stage
    seen.clear()
    tiny.port_decode(cfg_scale=1.5, kv_window=2)
    starts = np.cumsum([0] + lens)
    for t in range(len(PNS)):
        k = seen[tiny.var_cfg.depth * t]
        stages = [0] + list(range(max(1, t - 1), t + 1))
        want = torch.cat([full[:, starts[s]:starts[s + 1]] for s in stages], dim=1)
        torch.testing.assert_close(k, want, rtol=0, atol=0)
    assert tsampler.window_len(PNS, 2) == 1 + 9 + 16


@pytest.mark.parametrize("tag", ["l2", "saln"])
def test_cache_impls_agree_with_each_other_and_jax(tiny, tiny_saln, tag):
    t = tiny if tag == "l2" else tiny_saln
    want = t.jax_decode(cfg_scale=1.5)
    outs = {impl: t.port_decode(cfg_scale=1.5, cache_impl=impl)
            for impl in tsampler.CACHE_IMPLS}
    for impl, got in outs.items():
        _assert_decodes_equal(got, want)
        np.testing.assert_array_equal(got.tokens.numpy(), outs["chunked"].tokens.numpy())
        np.testing.assert_allclose(got.image.numpy(), outs["chunked"].image.numpy(), rtol=0,
                                   atol=1e-4)


def test_inpainting_sampler_matches_decode_cfg(tiny):
    keep = np.tile(jmasks.keep_scales_mask(PNS, 2)[None], (2, 1))
    sampler = tsampler.make_sampler(tiny.var.cfg, tiny.vae.cfg, cfg_scale=4.0, top_k=1,
                                    dtype=torch.float32, device="cpu", inpainting=True,
                                    kv_window=3, cache_impl="concat")
    got = sampler(tiny.var, tiny.vae, torch.Generator().manual_seed(0), tiny.label, tiny.gt, keep)
    want = tiny.jax_decode(gt_tokens=tiny.gt, keep_mask=keep, kv_window=3, cache_impl="concat")
    _assert_decodes_equal(got, want)
    with pytest.raises(ValueError):
        sampler(tiny.var, tiny.vae, None, tiny.label)


def test_scan_sampler_rounds_equal_make_sampler(tiny):
    kw = dict(cfg_scale=1.5, top_k=4, top_p=0.9, dtype=torch.float32, device="cpu")
    labels = np.asarray([[1, 2], [3, 0], [5, 5]])
    gen = torch.Generator().manual_seed(9)
    state = gen.get_state().clone()
    scan = tsampler.make_scan_sampler(tiny.var.cfg, tiny.vae.cfg, rounds=3, **kw)
    got = scan(tiny.var, tiny.vae, gen, labels)
    assert torch.equal(gen.get_state(), state)  # the caller's generator is untouched
    assert got.tokens.shape == (3, 2, tiny.var_cfg.seq_len)
    plain = tsampler.make_sampler(tiny.var.cfg, tiny.vae.cfg, **kw)
    for r in range(3):
        want = plain(tiny.var, tiny.vae, tsampler.fold_in(gen, r), labels[r])
        np.testing.assert_array_equal(got.tokens[r].numpy(), want.tokens.numpy())
        np.testing.assert_allclose(got.image[r].numpy(), want.image.numpy(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# smooth sampling and the neighbour tables


@pytest.mark.parametrize("threshold", [None, 1.0])
def test_smooth_sampling_matches_jax(tiny, threshold):
    """One image, every codebook entry a neighbour (n = V): the shapes the
    classifier's neighbor_bayesian mode uses."""
    gt, label = tiny.gt[:1], tiny.label[:1]
    want = jsampler.smooth_sampling(tiny.var_params, tiny.vae_params, tiny.var_cfg, tiny.vae_cfg,
                                    jnp.asarray(gt), 64, jnp.asarray(label),
                                    neighbor_threshold=threshold, dtype=jnp.float32)
    got = tsampler.smooth_sampling(tiny.var, tiny.vae, torch.from_numpy(gt), 64,
                                   torch.from_numpy(label), neighbor_threshold=threshold,
                                   dtype=torch.float32)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    for g, w in ((got.log_likelihood, want.log_likelihood),
                 (got.distance_log_likelihood, want.distance_log_likelihood)):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4)
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image), rtol=0, atol=1e-3)


@pytest.mark.parametrize("planted", [False, True])
def test_codebook_neighbor_tables_match_jax(planted):
    emb = np.random.default_rng(7).standard_normal((64, 8)).astype(np.float32)
    if planted:  # duplicate rows: exact ties, broken by the lower id
        emb[9] = emb[5]
        emb[40] = emb[20] = emb[3]
    wd, wi, wdist = jsampler.codebook_neighbor_tables(jnp.asarray(emb), 16)
    gd, gi, gdist = tsampler.codebook_neighbor_tables(torch.from_numpy(emb), 16)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gdist.numpy(), np.asarray(wdist), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0, atol=1e-5)
    if planted:
        assert list(gi[3, :3].numpy()) == [3, 20, 40]


# ---------------------------------------------------------------------------
# the tokenizer's round trips


@pytest.mark.parametrize("all_to_max_scale", [True, False])
def test_embed_to_fhat_matches_jax(tiny, all_to_max_scale):
    rng = np.random.default_rng(3)
    ms_h = [rng.standard_normal((2, pn, pn, 8)).astype(np.float32) for pn in PNS]
    want = jq.embed_to_fhat(tiny.vae_params["quantize"], tiny.vae_cfg,
                            [jnp.asarray(h) for h in ms_h], all_to_max_scale=all_to_max_scale)
    got = tq.embed_to_fhat(tiny.vae.quantize, tiny.vae.cfg, [torch.from_numpy(h) for h in ms_h],
                           all_to_max_scale=all_to_max_scale)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_img_to_fhat_matches_jax(tiny):
    want = jvae.img_to_fhat(tiny.vae_params, tiny.vae_cfg, jnp.asarray(tiny.img))
    got = tvae.img_to_fhat(tiny.vae, torch.from_numpy(tiny.img))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


@pytest.mark.parametrize("same_shape,last_one", [(True, False), (False, True)])
def test_idxBl_to_img_matches_jax(tiny, same_shape, last_one):
    ends = tiny.var_cfg.begin_ends
    want = jvae.idxBl_to_img(tiny.vae_params, tiny.vae_cfg,
                             [jnp.asarray(tiny.gt[:, b:e]) for b, e in ends],
                             same_shape=same_shape, last_one=last_one)
    got = tvae.idxBl_to_img(tiny.vae, [torch.from_numpy(tiny.gt[:, b:e]) for b, e in ends],
                            same_shape=same_shape, last_one=last_one)
    if last_one:
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the classifier


def _tied_log_probs():
    rng = np.random.default_rng(5)
    logits = rng.integers(0, 3, (2, 3, 10)).astype(np.float32)  # many equal probabilities
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))


SMOOTH_CASES = {
    "k_divides_v": (lambda: np.asarray(jax.nn.log_softmax(jnp.asarray(
        np.random.default_rng(0).standard_normal((2, 3, 16)), jnp.float32), -1)), 4),
    "k_not_dividing_v": (lambda: np.asarray(jax.nn.log_softmax(jnp.asarray(
        np.random.default_rng(1).standard_normal((2, 3, 10)), jnp.float32), -1)), 3),
    "tied": (_tied_log_probs, 4),
}


@pytest.mark.parametrize("case", sorted(SMOOTH_CASES))
def test_smooth_log_probs_by_k_matches_jax(case):
    make, k = SMOOTH_CASES[case]
    lp = make()
    want = np.asarray(jclf.smooth_log_probs_by_k(jnp.asarray(lp), k))
    got = tclf.smooth_log_probs_by_k(torch.tensor(lp), k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_cumsum_tokens_matches_jax():
    for pns in (PNS, (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)):
        assert tclf.cumsum_tokens(pns) == jclf.cumsum_tokens(pns)


CLF_CASES = [("bayesian", "vae_fhat"), ("smooth_bayesian", "vae_fhat"),
             ("fast_neighbor_bayesian", "vae_fhat"), ("neighbor_bayesian", "vae_fhat"),
             ("gen", "vae_fhat"), ("gen", "vae_post")]


@pytest.mark.parametrize("clayer", [0, 2])
@pytest.mark.parametrize("mode,feat", CLF_CASES)
def test_classifier_matches_jax(tiny, mode, feat, clayer):
    """Scores within rtol 1e-4 of the JAX classifier's, the same argmax."""
    classes = list(range(10)) if mode.endswith("bayesian") and mode != "neighbor_bayesian" \
        else [0, 3, 7]
    kw = dict(mode=mode, Clayer=clayer, threshold=1.0, smooth_k=4, feat=feat)
    img = tiny.img[:1]
    want = jclf.VARClassifier(tiny.var_params, tiny.vae_params, tiny.var_cfg, tiny.vae_cfg,
                              **kw).class_likelihoods(jnp.asarray(img), classes, batch_size=4)
    got = tclf.VARClassifier(tiny.var, tiny.vae, **kw).class_likelihoods(img, classes,
                                                                         batch_size=4)
    assert got.shape == (len(classes),) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert int(np.argmax(got)) == int(np.argmax(want))


def test_classifier_external_features_raise(tiny):
    clf = tclf.VARClassifier(tiny.var, tiny.vae, mode="gen", feat="clip")
    with pytest.raises(ValueError, match="not in the repository"):
        clf.class_likelihoods(tiny.img[:1], [0])


def test_run_eval_caches_per_image(tiny, tmp_path):
    clf = tclf.VARClassifier(tiny.var, tiny.vae, mode="bayesian")
    data = [(tiny.img[0], 3), (tiny.img[1], int(tiny.label[1]))]
    acc = tclf.run_eval(clf, iter(data), str(tmp_path), num_classes=10, batch_size=5)
    cached = [json.loads((tmp_path / f"{i}.json").read_text()) for i in range(2)]
    assert [c["label"] for c in cached] == [3, int(tiny.label[1])]
    # a rerun reads the cache and never calls the classifier
    assert tclf.run_eval(None, iter(data), str(tmp_path), num_classes=10) == acc


# ---------------------------------------------------------------------------
# eval data: folder dataset and transforms


def _write_pngs(root, sizes=((70, 50), (48, 80), (64, 64))):
    from PIL import Image

    rng = np.random.default_rng(0)
    for ci, cls in enumerate(("n01", "n02")):
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        for i, (w, h) in enumerate(sizes[ci:]):
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(root, cls, f"{i}.png"))
    with open(os.path.join(root, "n02", "notes.txt"), "w") as f:
        f.write("not an image")
    return root


def test_folder_dataset_and_transforms_match_jax(tmp_path):
    root = _write_pngs(str(tmp_path / "data"))
    got, want = tdata.FolderDataset(root), jdata.FolderDataset(root)
    assert got.samples == want.samples and got.class_to_idx == want.class_to_idx
    for train in (False, True):
        tt, tj = tdata.make_transform(32, train=train, hflip=True), \
            jdata.make_transform(32, train=train, hflip=True)
        for i, (path, _) in enumerate(got.samples):
            a = tt(path, np.random.default_rng(i))
            b = tj(path, np.random.default_rng(i))
            assert a.shape == (32, 32, 3) and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_imagenet_a_class_map_matches_jax(tmp_path):
    root = _write_pngs(str(tmp_path / "data"))
    index = tmp_path / "index.json"
    index.write_text(json.dumps({"7": ["n02", "b"], "3": ["n01", "a"], "9": ["n99", "c"]}))
    got = tdata.build_imagenet_a_class_map(str(index), root)
    assert got == jdata.build_imagenet_a_class_map(str(index), root) == {"n01": 3, "n02": 7}
    assert [s[1] for s in tdata.FolderDataset(root, got).samples] == [3, 3, 3, 7, 7]


# ---------------------------------------------------------------------------
# row 4: flash_decode_paired's plain version against the JAX kernel


@pytest.mark.parametrize("dtype,h,lq,lk,scale", [
    (torch.float32, 2, 1, 9, 0.17),
    (torch.float32, 2, 9, 100, 1.0),
    (torch.float32, 4, 100, 341, 0.17),
    (torch.float32, 16, 36, 91, 0.5),
    (torch.bfloat16, 2, 36, 119, 0.125),
    (torch.bfloat16, 4, 100, 341, 1.0),
])
def test_flash_decode_paired_plain_matches_jax_kernel(dtype, h, lq, lk, scale):
    """The JAX kernel runs in interpret mode on the CPU. fp32 within 2e-5;
    bf16 inputs within 2 bf16 ulps of max|want|. The port reads rows
    [0, lk) of a longer buffer, as the decode does."""
    c = 64 * h
    rng = np.random.default_rng(lq * 1000 + lk)
    q, k, v = (rng.standard_normal((2, n, c)).astype(np.float32) for n in (lq, lk + 7, lk + 7))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax_decode_paired(jnp.asarray(q, jdt), jnp.asarray(k[:, :lk], jdt),
                                        jnp.asarray(v[:, :lk], jdt), h, scale)).astype(np.float32)
    tq_, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    got = flash_decode_paired(tq_, tk, tv, h, scale, lk=lk)
    assert got.dtype == dtype and got.shape == (2, lq, c)
    torch.testing.assert_close(got, flash_decode_paired_plain(tq_, tk, tv, h, scale, lk),
                               rtol=0, atol=0)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        ulp = float(torch.finfo(torch.bfloat16).eps * 2.0 ** np.floor(np.log2(np.abs(want).max())))
        assert float(np.abs(got.float().numpy() - want).max()) <= 2 * ulp


@pytest.mark.parametrize("dtype,h,lq,lk,scale", [
    (torch.float32, 2, 1, 9, 1.0),
    (torch.float32, 4, 100, 341, 0.17),
    (torch.bfloat16, 2, 36, 119, 1.0),
    (torch.bfloat16, 4, 100, 341, 0.125),
])
def test_flash_decode_paired_folded_q_norm_matches_jax(dtype, h, lq, lk, scale):
    """Row 4 with the q norm in its launch: the port reads the first C lanes
    of a raw (2, Lq, 3C) qkv and normalises them per head with
    ``q_l2_scale_mul``; JAX normalises as ``_split_norm`` does (fp32 norm
    times exp(min(scale_mul, ln 100)), cast to the dtype) and passes q to
    its kernel in interpret mode. fp32 within 2e-5; bf16 within 2 bf16 ulps
    of max|want|."""
    c = 64 * h
    rng = np.random.default_rng(lq * 1000 + lk + 1)
    qkv = rng.standard_normal((2, lq, 3 * c)).astype(np.float32)
    k, v = (rng.standard_normal((2, lk + 7, c)).astype(np.float32) for _ in range(2))
    scale_mul = rng.uniform(0.0, 5.0, h).astype(np.float32)  # some past ln 100
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    sm = jnp.exp(jnp.minimum(jnp.asarray(scale_mul), np.log(100.0)))
    qf = jnp.asarray(qkv[..., :c], jdt).astype(jnp.float32).reshape(2, lq, h, 64)
    qn = (qf * jax.lax.rsqrt(jnp.sum(qf * qf, -1, keepdims=True) + 1e-24)
          * sm[:, None]).astype(jdt).reshape(2, lq, c)
    want = np.asarray(jax_decode_paired(qn, jnp.asarray(k[:, :lk], jdt),
                                        jnp.asarray(v[:, :lk], jdt), h, scale)).astype(np.float32)
    tqkv, tk, tv = (torch.from_numpy(a).to(dtype) for a in (qkv, k, v))
    tsm = torch.exp(torch.from_numpy(scale_mul).clamp(max=float(np.log(100.0))))
    got = flash_decode_paired(tqkv, tk, tv, h, scale, lk=lk, q_l2_scale_mul=tsm)
    assert got.dtype == dtype and got.shape == (2, lq, c)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        ulp = float(torch.finfo(torch.bfloat16).eps * 2.0 ** np.floor(np.log2(np.abs(want).max())))
        assert float(np.abs(got.float().numpy() - want).max()) <= 2 * ulp


def test_flash_decode_paired_refuses_other_devices():
    x = torch.empty(2, 3, 64, device="meta")
    with pytest.raises(ValueError):
        flash_decode_paired(x, x, x, 1)


# ---------------------------------------------------------------------------
# the apps, on the CPU


APP_ARGS = ["--device", "cpu", "--depth", "2", "--pn", "1_2_3", "--limit", "2"]


def test_inpaint_app_runs(tmp_path, capsys):
    from var_tpu_torch.apps import inpaint

    root = _write_pngs(str(tmp_path / "data"))
    for extra, out in ((["--keep_through", "1"], "keep"), (["--box", "0.25,0.25,0.75,0.75"], "box"),
                       (["--target_layer", "1", "--patches", "0,1", "--reverse"], "patch")):
        inpaint.main(APP_ARGS + ["--data_path", root, "--out_dir", str(tmp_path / out)] + extra)
        names = sorted(os.listdir(tmp_path / out))
        assert names == ["0_inpainted_0.png", "0_original.png", "1_inpainted_0.png",
                         "1_original.png"]
        assert (tmp_path / out / names[0]).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert capsys.readouterr().out.count("saved") == 6


def test_smooth_app_runs(tmp_path, capsys):
    from var_tpu_torch.apps import smooth

    root = _write_pngs(str(tmp_path / "data"))
    smooth.main(APP_ARGS + ["--data_path", root, "--out_dir", str(tmp_path / "out"), "--n", "16"])
    assert sorted(os.listdir(tmp_path / "out")) == ["0_smoothed_0.png", "1_smoothed_0.png"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all("log_lik=" in ln for ln in lines)


def test_classify_app_runs(tmp_path):
    from var_tpu_torch.apps import classify

    root = _write_pngs(str(tmp_path / "data"))
    out = tmp_path / "out"
    acc = classify.main(["--device", "cpu", "--depth", "2", "--pn", "1_2_3", "--data_path", root,
                         "--out_dir", str(out), "--num_classes", "4", "--batch_size", "3",
                         "--limit", "3"])
    assert 0.0 <= acc <= 100.0
    assert sorted(os.listdir(out)) == ["0.json", "1.json", "2.json"]
