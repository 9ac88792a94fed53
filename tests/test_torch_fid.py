"""The port's FID scorer and sampling protocol against the JAX package, on
the CPU: ``metrics/fid.py``, ``apps/fid_score.py``, ``apps/fid_sample.py``.

The numpy half (Fréchet distance, statistics, sources) must equal JAX's to
rel 1e-12 on the same features. The extractors run on the same images and,
for the vae extractor, the same tokenizer weights carried across with
``vae_state_dict``; they are float32 on both sides, so their features agree
within FEAT_TOL (a few float32 ulps of the features' scale, summed over the
encoder's convolutions in another order). Images come from numpy seeds.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from var_tpu.apps import fid_score as jfid_score
from var_tpu.config import VAEConfig
from var_tpu.metrics import fid as J
from var_tpu.models import vae as jvae
from var_tpu_torch import config as tcfg
from var_tpu_torch.apps import fid_sample, fid_score
from var_tpu_torch.engine.convert import vae_state_dict
from var_tpu_torch.metrics import fid as F
from var_tpu_torch.models import vae as tvae

torch.set_num_threads(2)

FEAT_TOL = dict(rtol=1e-5, atol=1e-6)  # float32 features, port vs JAX (measured 6e-8)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    """The pixel extractor's 3072-d covariances are eigendecomposed on one
    BLAS thread: under a parallel test run (several workers on the same
    cores) OpenBLAS threads spinning against each other made these tests
    ~10x slower than alone."""
    with threadpool_limits(limits=1):
        yield


def _rand_imgs(rng, n=24, hw=48):
    return rng.integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)


def _write(d, arr):
    d.mkdir()
    for i, img in enumerate(arr):
        Image.fromarray(img).save(d / f"{i:06d}.png")
    return str(d)


def _tiny_vae_cfg():
    return tcfg.VAEConfig(vocab_size=32, z_channels=8, ch=32, ch_mult=(1, 1))


def _jax_tiny_vae_cfg():
    return VAEConfig(vocab_size=32, z_channels=8, ch=32, ch_mult=(1, 1))


# ---------------------------------------------------------------------------
# the six cases of tests/test_fid.py, on the port


def test_frechet_distance_identity_and_symmetry():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(200, 8))
    mu, s = F.feature_stats(feats)
    assert F.frechet_distance(mu, s, mu, s) == pytest.approx(0.0, abs=1e-9)
    mu2, s2 = F.feature_stats(rng.normal(loc=1.0, size=(200, 8)))
    d12 = F.frechet_distance(mu, s, mu2, s2)
    d21 = F.frechet_distance(mu2, s2, mu, s)
    assert d12 == pytest.approx(d21, rel=1e-9) and d12 > 0.5


def test_frechet_distance_known_value():
    """Isotropic Gaussians: FID = |dmu|^2 + (sqrt(a) - sqrt(b))^2 * D."""
    d = 4
    mu1, mu2 = np.zeros(d), np.full(d, 2.0)
    s1, s2 = np.eye(d) * 3.0, np.eye(d) * 1.0
    want = 4.0 * d + (np.sqrt(3.0) - 1.0) ** 2 * d
    assert F.frechet_distance(mu1, s1, mu2, s2) == pytest.approx(want, rel=1e-12)


def test_fid_identical_folders_zero_and_noise_monotone(tmp_path):
    """Identical image sets score ~0; increasing pixel noise increases the
    score monotonically (both extractors; the pixel one at 16x16, 768-d,
    where JAX's test takes the 3072-d default: the three 3072-d
    eigendecompositions were most of this file's time)."""
    rng = np.random.default_rng(1)
    base = _rand_imgs(rng, n=32)
    ref = _write(tmp_path / "ref", base)
    same = _write(tmp_path / "same", base)
    noisy = {}
    for amp in (16, 64):
        pert = np.clip(base.astype(np.int16) + rng.integers(-amp, amp + 1, base.shape), 0, 255)
        noisy[amp] = _write(tmp_path / f"noise{amp}", pert.astype(np.uint8))

    for name in ("pixel", "vae"):
        ex = F.get_extractor(name, device="cpu", size=16) if name == "pixel" \
            else F.make_vae_extractor(vae_cfg=_tiny_vae_cfg(), seed=0, device="cpu")
        d0 = F.fid_between(ref, same, ex, batch=16)
        d1 = F.fid_between(ref, noisy[16], ex, batch=16)
        d2 = F.fid_between(ref, noisy[64], ex, batch=16)
        assert abs(d0) < 1e-2, (name, d0)
        assert d0 < d1 < d2 and d1 > 0, (name, d0, d1, d2)


def test_npz_and_stats_npz_sources(tmp_path):
    """images-npz (arr_0) and precomputed-stats npz (mu/sigma) both work and
    agree with the folder path."""
    rng = np.random.default_rng(2)
    a, b = _rand_imgs(rng, n=16), _rand_imgs(rng, n=16)
    da = _write(tmp_path / "a", a)
    np.savez(tmp_path / "b.npz", arr_0=b)

    ex = F.make_pixel_extractor(size=8, device="cpu")
    d_folder_npz = F.fid_between(da, str(tmp_path / "b.npz"), ex, batch=8)

    mu, s = F.path_stats(str(tmp_path / "b.npz"), ex, batch=8)
    np.savez(tmp_path / "b_stats.npz", mu=mu, sigma=s)
    d_stats = F.fid_between(da, str(tmp_path / "b_stats.npz"), ex, batch=8)
    assert d_folder_npz == pytest.approx(d_stats, rel=1e-12)

    mu_a, s_a = F.path_stats(da, ex, batch=8)
    assert F.frechet_distance(mu_a, s_a, mu, s) == pytest.approx(d_folder_npz, rel=1e-12)


def test_fid_score_cli(tmp_path, capsys):
    rng = np.random.default_rng(3)
    imgs = _rand_imgs(rng, n=12, hw=32)
    for name in ("x", "y"):
        _write(tmp_path / name, imgs)
    stats_out = str(tmp_path / "y_stats.npz")
    score = fid_score.main([str(tmp_path / "x"), str(tmp_path / "y"), "--extractor", "pixel",
                            "--batch", "8", "--save_stats", stats_out, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "fid_pixel"
    assert abs(line["value"]) < 1e-2  # identical sets, up to eigensolver noise
    assert abs(score) < 1e-2
    assert os.path.exists(stats_out)


def test_inception_extractor_gates_cleanly(tmp_path):
    with pytest.raises(FileNotFoundError, match="pt_inception"):
        F.make_inception_extractor(str(tmp_path / "missing.pt"), device="cpu")
    with pytest.raises(FileNotFoundError, match="pt_inception"):
        F.get_extractor("inception", device="cpu", inception_pt=str(tmp_path / "missing.pt"))


# ---------------------------------------------------------------------------
# against the JAX package


def test_numpy_half_equals_jax():
    """frechet_distance and feature_stats on the same features: JAX's values
    to rel 1e-12 (the same numpy code)."""
    rng = np.random.default_rng(4)
    fa, fb = rng.normal(size=(64, 12)), rng.normal(loc=0.3, scale=1.2, size=(80, 12))
    for got, want in zip(F.feature_stats(fa), J.feature_stats(fa)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    mu_a, s_a = F.feature_stats(fa)
    mu_b, s_b = F.feature_stats(fb)
    assert F.frechet_distance(mu_a, s_a, mu_b, s_b) == pytest.approx(
        J.frechet_distance(mu_a, s_a, mu_b, s_b), rel=1e-12)


def test_path_stats_equals_jax_on_the_same_features(tmp_path):
    """path_stats over a PNG folder, an images npz and a stats npz, with one
    extractor function given to both packages: JAX's (mu, sigma) to rel
    1e-12."""
    rng = np.random.default_rng(5)
    imgs = _rand_imgs(rng, n=20, hw=16)
    folder = _write(tmp_path / "f", imgs)
    np.savez(tmp_path / "i.npz", arr_0=imgs)
    proj = rng.normal(size=(16 * 16 * 3, 6))
    ex = lambda u8: u8.reshape(len(u8), -1).astype(np.float64) @ proj  # noqa: E731
    for src in (folder, str(tmp_path / "i.npz")):
        got, want = F.path_stats(src, ex, batch=7), J.path_stats(src, ex, batch=7)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    mu, s = F.path_stats(folder, ex, batch=7)
    np.savez(tmp_path / "s.npz", mu=mu, sigma=s)
    for g, w in zip(F.path_stats(str(tmp_path / "s.npz"), ex),
                    J.path_stats(str(tmp_path / "s.npz"), ex)):
        np.testing.assert_array_equal(g, w)
    assert F.fid_between(folder, str(tmp_path / "i.npz"), ex, limit=15) == pytest.approx(
        J.fid_between(folder, str(tmp_path / "i.npz"), ex, limit=15), rel=1e-12, abs=1e-9)


def test_vae_extractor_matches_jax_on_carried_weights():
    """The vae extractor on JAX's tiny tokenizer weights carried across:
    features within FEAT_TOL; both label the space ``vae``."""
    cfg = _jax_tiny_vae_cfg()
    params = jvae.init_vae_params(jax.random.PRNGKey(3), cfg)
    vae = tvae.VQVAE(_tiny_vae_cfg())
    vae.load_state_dict(vae_state_dict(jax.tree.map(np.asarray, params), cfg))
    imgs = _rand_imgs(np.random.default_rng(6), n=6, hw=32)
    got = F.make_vae_extractor(vae=vae, device="cpu")
    want = J.make_vae_extractor(vae_params=params, vae_cfg=cfg)
    g, w = got(imgs), want(imgs)
    assert g.dtype == np.float64 and g.shape == (6, 2 * cfg.z_channels)
    np.testing.assert_allclose(g, w, **FEAT_TOL)
    assert got.feature_space == want.feature_space == "vae"
    assert F.make_vae_extractor(vae_cfg=_tiny_vae_cfg(), device="cpu").feature_space \
        == "vae_randproj"


def test_randproj_extractor_is_the_cpu_seeded_init():
    """Without weights the vae extractor is ``init_vae_params`` drawn from a
    CPU generator at ``seed`` (so a seed names one tokenizer on every
    device): its features equal those of that tokenizer passed as ``vae``,
    and another seed gives other features."""
    imgs = _rand_imgs(np.random.default_rng(10), n=4, hw=32)
    vae = tvae.init_vae_params(tvae.VQVAE(_tiny_vae_cfg()), torch.Generator().manual_seed(5))
    got = F.make_vae_extractor(vae_cfg=_tiny_vae_cfg(), seed=5, device="cpu")(imgs)
    np.testing.assert_array_equal(got, F.make_vae_extractor(vae=vae, device="cpu")(imgs))
    other = F.make_vae_extractor(vae_cfg=_tiny_vae_cfg(), seed=6, device="cpu")(imgs)
    assert not np.allclose(got, other)


@pytest.mark.parametrize("size", [8, 32])
def test_pixel_extractor_matches_jax(size):
    imgs = _rand_imgs(np.random.default_rng(7), n=5, hw=48)
    got = F.make_pixel_extractor(size=size, device="cpu")(imgs)
    want = J.make_pixel_extractor(size=size)(imgs)
    assert got.dtype == np.float64 and got.shape == (5, 3 * size * size)
    np.testing.assert_allclose(got, want, **FEAT_TOL)


def test_fid_score_line_matches_jax(tmp_path, capsys):
    """fid_score's JSON line on the same two folders (pixel extractor): the
    metric name, the sources and the value (rel 1e-5: six decimals of the
    rounded score, from features within FEAT_TOL)."""
    rng = np.random.default_rng(8)
    x = _write(tmp_path / "x", _rand_imgs(rng, n=12, hw=32))
    y = _write(tmp_path / "y", _rand_imgs(rng, n=12, hw=32))
    fid_score.main([x, y, "--extractor", "pixel", "--batch", "5", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jfid_score.main([x, y, "--extractor", "pixel", "--batch", "5"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: got[k] for k in ("metric", "ref", "samples")} \
        == {k: want[k] for k in ("metric", "ref", "samples")}
    assert got["value"] == pytest.approx(want["value"], rel=1e-5)


def test_fid_score_warns_for_random_projection_features(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(9)
    x = _write(tmp_path / "x", _rand_imgs(rng, n=4, hw=16))
    np.savez(tmp_path / "y.npz", arr_0=_rand_imgs(rng, n=4, hw=16))
    # a tiny tokenizer keeps the default-config extractor off the test's clock
    monkeypatch.setattr(F, "VAEConfig", _tiny_vae_cfg)
    fid_score.main([x, str(tmp_path / "y.npz"), "--vae_ckpt", str(tmp_path / "absent.pth"),
                    "--device", "cpu"])
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1])["metric"] == "fid_vae_randproj"
    assert "RANDOM-PROJECTION" in out.err


# ---------------------------------------------------------------------------
# fid_sample (the port's counterparts of tests/test_apps.py:133 and :181)

TINY = ["--depth", "2", "--pn", "1_2_3", "--V", "64", "--Cvae", "8", "--ch", "32",
        "--device", "cpu"]


def test_fid_sample_writes_resumes_and_packs(tmp_path):
    out = str(tmp_path / "fid")
    argv = TINY + ["--num_classes", "4", "--per_class", "2", "--batch", "4", "--out_dir", out,
                   "--pack"]
    fid_sample.main(argv)
    pngs = sorted(os.listdir(out))
    assert pngs == [f"{i:06d}.png" for i in range(8)]
    arr = np.load(out + ".npz")["arr_0"]
    assert arr.shape == (8, 48, 48, 3) and arr.dtype == np.uint8
    mtimes = {f: os.path.getmtime(os.path.join(out, f)) for f in pngs}
    fid_sample.main(argv[:-1])  # resume, no --pack: nothing resampled
    assert {f: os.path.getmtime(os.path.join(out, f)) for f in pngs} == mtimes


def test_fid_sample_rounds_with_ragged_tail(tmp_path):
    out = str(tmp_path / "fid_r")
    fid_sample.main(TINY + ["--num_classes", "5", "--per_class", "2", "--batch", "2",
                            "--rounds", "2", "--out_dir", out])
    assert sorted(os.listdir(out)) == [f"{i:06d}.png" for i in range(10)]


def test_decode_chunks_keeps_the_seed_of_a_skipped_chunk():
    """A resumed run decodes each remaining chunk with the generator the
    uninterrupted run used: the seed counter advances over skipped chunks
    (JAX ``fid_sample.py:97-101``), also across the ragged-tail switch."""
    from var_tpu_torch.models import build_vae_var

    _, _, vae, var = build_vae_var(device="cpu", depth=2, patch_nums=(1, 2), V=64, Cvae=8, ch=32,
                                   num_classes=5, dtype=torch.float32)
    labels = np.repeat(np.arange(5), 2)
    kw = dict(batch=2, rounds=2, top_k=8, dtype=torch.float32, device="cpu")
    full = dict(fid_sample.decode_chunks(var, vae, labels, **kw))
    assert sorted(full) == [0, 4, 8] and [len(v) for v in full.values()] == [4, 4, 2]
    resumed = dict(fid_sample.decode_chunks(var, vae, labels, done=lambda i, n: i < 4, **kw))
    assert sorted(resumed) == [4, 8]
    for i in resumed:
        np.testing.assert_array_equal(resumed[i], full[i])


@pytest.mark.slow
def test_fid_sample_greedy_pngs_match_jax(tmp_path):
    """With --top_k 1 and the same .pth weights, the port's PNGs are JAX's
    fid_sample's within 1/255."""
    from var_tpu.apps import fid_sample as jfid_sample
    from var_tpu_torch.models import build_vae_var

    _, _, vae, var = build_vae_var(device="cpu", depth=2, patch_nums=(1, 2, 3), V=64, Cvae=8,
                                   ch=32, num_classes=4, dtype=torch.float32)
    torch.save(vae.state_dict(), tmp_path / "vae.pth")
    torch.save(var.state_dict(), tmp_path / "var.pth")
    common = ["--depth", "2", "--pn", "1_2_3", "--V", "64", "--Cvae", "8", "--ch", "32",
              "--num_classes", "4", "--per_class", "2", "--batch", "4", "--top_k", "1",
              "--vae_ckpt", str(tmp_path / "vae.pth"), "--var_ckpt", str(tmp_path / "var.pth")]
    fid_sample.main(common + ["--device", "cpu", "--out_dir", str(tmp_path / "port")])
    jfid_sample.main(common + ["--out_dir", str(tmp_path / "jax")])
    for i in range(8):
        got = np.asarray(Image.open(tmp_path / "port" / f"{i:06d}.png"), np.int16)
        want = np.asarray(Image.open(tmp_path / "jax" / f"{i:06d}.png"), np.int16)
        assert np.abs(got - want).max() <= 1, i
