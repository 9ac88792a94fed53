"""The port's analysis apps against the JAX package, on the CPU:
``apps/analysis.py`` (teacher-forced per-scale scores, the manual CFG ramp,
``l2_dist``, per-image records, aggregates, plots) and
``apps/investigate.py`` (reports over the records).

Models are the tiny fixture's (``var_tiny.npz``: depth 3, C 64, 4 heads,
V 64, 10 classes, pyramid 1-4, q/k L2 norm), carried across with the JAX
package's ``convert_*`` and the port's ``*_state_dict``. Scores are fp32 on
both sides: within rtol 1e-4 (the parity contract's zero-shot scores), the
predictions equal.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from var_tpu.apps import analysis as ja
from var_tpu.apps import investigate as ji
from var_tpu.config import VAEConfig, VARConfig
from var_tpu.engine.convert import convert_vae, convert_var
from var_tpu.models import quantizer as jq
from var_tpu.models import vae as jvae
from var_tpu_torch import config as tcfg
from var_tpu_torch.apps import analysis as ta
from var_tpu_torch.apps import investigate as ti
from var_tpu_torch.engine.convert import vae_state_dict, var_state_dict
from var_tpu_torch.models import quantizer as tq
from var_tpu_torch.models import vae as tvae
from var_tpu_torch.models import var as tvar

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "var_tiny.npz")
PNS = (1, 2, 3, 4)
RTOL = 1e-4
CLASSES = list(range(10))


def _torch_cfg(cfg):
    cls = tcfg.VAEConfig if isinstance(cfg, VAEConfig) else tcfg.VARConfig
    return cls(**{f: getattr(cfg, f) for f in cls.__dataclass_fields__})


@pytest.fixture(scope="module")
def tiny():
    """(JAX params and configs, port modules, two images (B, H, W, 3), labels)."""
    data = np.load(FIXTURE)
    vae_cfg = VAEConfig(vocab_size=64, z_channels=8, ch=32, v_patch_nums=PNS)
    var_cfg = VARConfig(num_classes=10, depth=3, embed_dim=64, num_heads=4, attn_l2_norm=True,
                        cond_drop_rate=0.0, patch_nums=PNS, vocab_size=64, z_channels=8)
    vae_params = convert_vae({k[7:]: data[k].astype(np.float32) for k in data.files
                              if k.startswith("vae_sd/")}, vae_cfg)
    var_params = convert_var({k[len("l2/var_sd/"):]: data[k].astype(np.float32)
                              for k in data.files if k.startswith("l2/var_sd/")}, var_cfg)
    vae = tvae.VQVAE(_torch_cfg(vae_cfg))
    vae.load_state_dict(vae_state_dict(vae_params, vae_cfg))
    var = tvar.VAR(_torch_cfg(var_cfg))
    var.load_state_dict(var_state_dict(var_params, var_cfg))
    img = np.transpose(data["l2/img"], (0, 2, 3, 1)).astype(np.float32)
    return dict(jax=(var_params, vae_params, var_cfg, vae_cfg),
                port=(var.eval().requires_grad_(False), vae.eval().requires_grad_(False)),
                img=img, label=data["l2/label"])


def _inputs(tiny, b=4):
    """The first image's tokens and teacher inputs, tiled over b classes,
    on both sides."""
    var_params, vae_params, var_cfg, vae_cfg = tiny["jax"]
    var, vae = tiny["port"]
    img = tiny["img"][:1]
    idx_j = jvae.img_to_idxBl(vae_params, vae_cfg, jnp.asarray(img))
    gt_j = jnp.tile(jnp.concatenate(idx_j, axis=1), (b, 1))
    x_j = jnp.tile(jq.idxBl_to_var_input(vae_params["quantize"], vae_cfg, idx_j), (b, 1, 1))
    idx_t = tvae.img_to_idxBl(vae, torch.from_numpy(img))
    gt_t = torch.cat(idx_t, dim=1).expand(b, -1)
    x_t = tq.idxBl_to_var_input(vae.quantize, vae.cfg, idx_t).expand(b, -1, -1)
    np.testing.assert_array_equal(gt_t.numpy(), np.asarray(gt_j))
    labels = np.arange(b) * 2
    return (jnp.asarray(labels), x_j, gt_j), (torch.from_numpy(labels), x_t, gt_t)


@pytest.mark.parametrize("cfg_scale", [0.0, 1.5])
def test_teacher_forced_log_probs_match_jax(tiny, cfg_scale):
    var_params, _, var_cfg, _ = tiny["jax"]
    var, _ = tiny["port"]
    (lj, xj, gj), (lt, xt, gt) = _inputs(tiny)
    tok_j, logp_j = ja.teacher_forced_log_probs(var_params, var_cfg, lj, xj, gj, cfg_scale)
    with torch.inference_mode():
        tok_t, logp_t = ta.teacher_forced_log_probs(var, lt, xt, gt, cfg_scale)
    np.testing.assert_allclose(tok_t.numpy(), np.asarray(tok_j), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), rtol=RTOL, atol=1e-5)


def test_l2_dist_scores_and_per_scale_sums_match_jax(tiny):
    var_params, vae_params, var_cfg, _ = tiny["jax"]
    var, vae = tiny["port"]
    (lj, xj, gj), (lt, xt, gt) = _inputs(tiny)
    _, logp_j = ja.teacher_forced_log_probs(var_params, var_cfg, lj, xj, gj)
    with torch.inference_mode():
        _, logp_t = ta.teacher_forced_log_probs(var, lt, xt, gt)
        d_t = ta.l2_dist_scores(logp_t, gt, vae.quantize.embedding.weight)
        s_t = ta.per_scale_sums(d_t, var.cfg)
    d_j = ja.l2_dist_scores(logp_j, gj, vae_params["quantize"]["embedding"])
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=RTOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(ja.per_scale_sums(d_j, var_cfg)),
                               rtol=RTOL)
    assert [(s.start, s.stop) for s in ta.scale_segments(var.cfg)] \
        == [(s.start, s.stop) for s in ja.scale_segments(var_cfg)]


@pytest.mark.parametrize("cfg_scale,l2_dist", [(0.0, False), (1.5, False), (0.0, True),
                                               (1.5, True)])
def test_analyze_image_and_aggregate_match_jax(tiny, cfg_scale, l2_dist):
    """The per-image records of both images (scores within rtol 1e-4,
    predictions and correctness equal) and their aggregate."""
    var_params, vae_params, var_cfg, vae_cfg = tiny["jax"]
    var, vae = tiny["port"]
    jfn = ja.make_score_fn(var_params, vae_params, var_cfg, vae_cfg, cfg_scale, l2_dist)
    models_j = {"d3": (var_params, vae_params, var_cfg, vae_cfg, jfn)}
    models_t = {"d3": (var, vae, ta.make_score_fn(var, vae, cfg_scale, l2_dist))}
    recs_j, recs_t = [], []
    for img, label in zip(tiny["img"], tiny["label"]):
        recs_j.append(ja.analyze_image(models_j, jnp.asarray(img[None]), int(label), CLASSES,
                                       cfg_scale=cfg_scale, l2_dist=l2_dist, batch_size=4))
        recs_t.append(ta.analyze_image(models_t, torch.from_numpy(img[None]), int(label),
                                       CLASSES, batch_size=4))
    for rt, rj in zip(recs_t, recs_j):
        np.testing.assert_allclose(rt["d3"]["per_scale"], rj["d3"]["per_scale"], rtol=RTOL)
        assert {k: v for k, v in rt["d3"].items() if k != "per_scale"} \
            == {k: v for k, v in rj["d3"].items() if k != "per_scale"}
        assert rt["label"] == rj["label"]
    assert ta.aggregate(recs_t, ["d3"]) == ja.aggregate(recs_j, ["d3"])


def _records(seed: int, n: int = 12, classes: int = 5, scales: int = 4):
    """Synthetic per-image records of two models, with ties among the
    confusion pairs."""
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        label = int(rng.integers(0, classes))
        rec = {"label": label}
        for name in ("d16", "d30"):
            per = rng.normal(size=(classes, scales))
            cum = per.cumsum(1)
            rec[name] = {"per_scale": per.tolist(),
                         "pred": int(cum[:, -1].argmax()),
                         "correct": bool(cum[:, -1].argmax() == label),
                         "correct_per_scale": (per.argmax(0) == label).tolist(),
                         "correct_cumulative": (cum.argmax(0) == label).tolist()}
        recs.append(rec)
    return recs


@pytest.mark.parametrize("seed", [0, 1])
def test_investigate_report_matches_jax(seed, tmp_path):
    """Every section of the report on the same records, through both CLIs
    (JAX's counts confusion pairs with pandas, the port with numpy)."""
    recs = _records(seed)
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d)
        for i, r in enumerate(recs):
            with open(tmp_path / d / f"{i}.json", "w") as f:
                json.dump(r, f)
    assert ti.load_records(str(tmp_path / "port")) == ji.load_records(str(tmp_path / "jax"))
    ti.main(["--records_dir", str(tmp_path / "port")])
    ji.main(["--records_dir", str(tmp_path / "jax")])
    with open(tmp_path / "port" / "investigation.json") as f, \
            open(tmp_path / "jax" / "investigation.json") as g:
        assert json.load(f) == json.load(g)
    # a second run reads the records again, not its own report
    assert ti.main(["--records_dir", str(tmp_path / "port")]) == ti.report(recs)


def test_analysis_and_investigate_apps_plot(tmp_path):
    """analysis --plot over a folder of class subdirectories (two model
    sizes, cfg, l2_dist; per-image JSON cache resumed on a rerun), then
    investigate --plot over its records."""
    rng = np.random.default_rng(3)
    for c in range(2):
        os.makedirs(tmp_path / "imgs" / f"c{c}")
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (56, 60, 3), dtype=np.uint8)).save(
                tmp_path / "imgs" / f"c{c}" / f"{i}.png")
    out = str(tmp_path / "out")
    argv = ["--device", "cpu", "--depths", "1,2", "--pn", "1_2_3", "--data_path",
            str(tmp_path / "imgs"), "--out_dir", out, "--num_classes", "3", "--cfg", "1.5",
            "--l2_dist", "--limit", "3", "--plot", "--vae_ckpt", str(tmp_path / "absent.pth")]
    agg = ta.main(argv)
    assert set(agg) == {"d1", "d2"} and agg["d1"]["n"] == 3
    assert {"0.json", "1.json", "2.json", "summary.json", "accuracy.png", "kde.png"} \
        <= set(os.listdir(out))
    mtime = os.path.getmtime(os.path.join(out, "0.json"))
    assert ta.main(argv[:-3] + ["--vae_ckpt", str(tmp_path / "absent.pth")]) == agg
    assert os.path.getmtime(os.path.join(out, "0.json")) == mtime
    rep = ti.main(["--records_dir", out, "--num_classes", "3", "--plot"])
    assert rep["n"] == 3 and "agreement" in rep["model_differences"]
    assert {"investigation.json", "confusion_d1.png", "confusion_d2.png"} <= set(os.listdir(out))


def test_heatmaps_match_jax_and_prob_vs_distance_plots(tiny, tmp_path):
    """The per-class heat-map overlays equal JAX's on the same scores; the
    probability-vs-distance plot is written from the port's log-probs."""
    var, vae = tiny["port"]
    rng = np.random.default_rng(4)
    scores = rng.normal(size=(3, var.cfg.seq_len))
    img = rng.uniform(-1, 1, size=(16, 16, 3))
    for got, want in zip(ta.create_heatmaps_for_classes(scores, PNS, img),
                         ja.create_heatmaps_for_classes(scores, PNS, img)):
        np.testing.assert_array_equal(got, want)
    _, (lt, xt, gt) = _inputs(tiny)
    with torch.inference_mode():
        _, logp = ta.teacher_forced_log_probs(var, lt, xt, gt)
    out = str(tmp_path / "prob_vs_dist.png")
    ta.plot_prob_vs_distance(logp.numpy(), gt.numpy(), vae.quantize.embedding.weight.numpy(), out)
    assert os.path.getsize(out) > 0
