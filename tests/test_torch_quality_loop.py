"""The port's quality loop (``apps/quality_loop.py``) against the JAX
script (``scripts/quality_loop.py``), on the CPU: the grating dataset's
bytes, a smoke of the loop through the folder CLI and through ``run`` over
arrays in memory, and (slow) JAX's mini scale with its three asserts."""

import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch

from var_tpu_torch.apps import quality_loop as tql

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "reso", "train_images", "val_images", "vae_recon_first_last", "val_curve",
        "val_improved", "fid_init", "fid_trained", "fid_improved"}
SMOKE = ["--classes", "2", "--per_class", "8", "--val_per_class", "3", "--pn", "1_2",
         "--vae_steps", "2", "--epochs", "2", "--bs", "4", "--depth", "1", "--width", "64",
         "--heads", "2", "--vocab", "16", "--sample_per_class", "2", "--device", "cpu"]


def _jax_script():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import quality_loop

    return quality_loop


def test_gen_dataset_writes_jax_bytes(tmp_path):
    """The same arguments give byte-identical JPEGs, the same layout and the
    same manifest as JAX's ``gen_dataset``; a rerun with the manifest in
    place rewrites nothing."""
    args = (3, 4, 2, 24, 5)
    tql.gen_dataset(str(tmp_path / "port"), *args)
    _jax_script().gen_dataset(str(tmp_path / "jax"), *args)
    files = []
    for d, _, names in os.walk(tmp_path / "jax"):
        files += [os.path.relpath(os.path.join(d, n), tmp_path / "jax") for n in names]
    assert len(files) == 3 * (4 + 2) + 1
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "port", tmp_path / "jax", files,
                                           shallow=False)
    assert not mismatch and not errors
    first = tmp_path / "port" / "train" / "class_000" / "00000.jpg"
    mtime = os.path.getmtime(first)
    tql.gen_dataset(str(tmp_path / "port"), *args)
    assert os.path.getmtime(first) == mtime


class _Split:
    """A dataset object for ``run``: ``samples`` of (item, label)."""

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)


def _grating_splits(classes, per_class, val_per_class, reso, seed):
    """(train, val) of ``grating_images``' uint8 arrays, without files."""
    splits = {"train": [], "val": []}
    for split, c, _, arr in tql.grating_images(classes, per_class, val_per_class, reso, seed):
        splits[split].append((arr, c))
    return _Split(splits["train"]), _Split(splits["val"])


def _u8_to_pm1(item, rng):
    return item.astype(np.float32) / 255.0 * 2.0 - 1.0


def test_grating_images_are_the_generated_dataset(tmp_path):
    """``grating_images`` yields gen_dataset's images before JPEG coding, in
    the folder dataset's order and with its labels."""
    from PIL import Image

    from var_tpu_torch.data.imagenet import FolderDataset

    train, val = _grating_splits(2, 3, 1, 64, 0)
    tql.gen_dataset(str(tmp_path), 2, 3, 1, 64, 0)
    for split, ds in (("train", train), ("val", val)):
        folder = FolderDataset(str(tmp_path / split))
        assert [lbl for _, lbl in ds.samples] == [lbl for _, lbl in folder.samples]
        decoded = [np.asarray(Image.open(path).convert("RGB"), np.float32)
                   for path, _ in folder.samples]
        for i, (arr, _) in enumerate(ds.samples):
            assert arr.shape == (64, 64, 3) and arr.dtype == np.uint8
            # JPEG quality 92 at 64px: about 7 levels off on average; every
            # other grating of the split is 37 or more off
            errs = [np.abs(d - arr).mean() for d in decoded]
            assert errs[i] < 10 and int(np.argmin(errs)) == i, errs


def test_quality_loop_smoke_through_the_folder_cli(tmp_path):
    """``main`` at a tiny scale: every key of the JSON line, finite numbers,
    the sample folders and --json_out written."""
    out = tmp_path / "q"
    result = tql.main(SMOKE + ["--out_dir", str(out), "--json_out", str(tmp_path / "r.json")])
    assert set(result) == KEYS
    assert len(result["val_curve"]) == 3 and result["train_images"] == 16
    with open(tmp_path / "r.json") as f:
        assert json.load(f) == result
    assert sorted(os.listdir(out / "samples_trained")) == [f"{i:06d}.png" for i in range(4)]


def test_quality_loop_smoke_in_memory():
    """``run`` over gratings held in memory (the card smoke's route): the
    JSON line's keys, the samples and the trained modules."""
    args = tql.build_parser().parse_args(SMOKE)
    train, val = _grating_splits(2, 8, 3, 16, 0)
    result, samples, models = tql.run(args, train, val, _u8_to_pm1, _u8_to_pm1,
                                      log=lambda s: None)
    assert set(result) == KEYS
    assert all(v.shape == (4, 16, 16, 3) and v.dtype.name == "uint8" for v in samples.values())
    assert set(models) == {"vae", "init", "trained"}
    assert not any(p.requires_grad for m in models.values() for p in m.parameters())


# JAX's mini scale (tests/test_quality_loop.py:16-20)
MINI = ["--classes", "4", "--per_class", "24", "--val_per_class", "8", "--pn", "1_2_4",
        "--vae_steps", "60", "--epochs", "3", "--bs", "12", "--depth", "2", "--width", "128",
        "--heads", "2", "--vocab", "64", "--sample_per_class", "4", "--device", "cpu"]
DRAW_SEEDS = 8  # sample sets a framework draws at the loop's filter in the halves test


@pytest.mark.slow
def test_quality_loop_val_and_fid_improve(tmp_path):
    """JAX's mini scale (tests/test_quality_loop.py) on the port, with its
    three asserts."""
    result = tql.main(["--out_dir", str(tmp_path)] + MINI)
    r0, r1 = result["vae_recon_first_last"]
    assert r1 < 0.8 * r0, result
    assert result["val_improved"], result
    assert result["val_curve"][-1] < result["val_curve"][0], result
    assert result["fid_improved"], result


@pytest.mark.slow
def test_quality_loop_halves_agree_with_jax(tmp_path):
    """The mini scale's sampling and scoring halves held against JAX on the
    port's trained weights, carried across by name (JAX's ``convert_vae`` and
    ``convert_var``). Scoring: JAX's extractor gives the port's FID proxies
    on the same sample sets (rel 1e-4). Sampling: greedy (top_k 1, the
    loop's cfg) images within 1/255 of JAX's. Then each framework draws
    DRAW_SEEDS sample sets at the loop's filter from the same initial and
    trained weights (seed 7 is the loop's own draw, which the port's
    reproduces bit for bit), all scored by the port, and one JSON line
    prints their FID proxies: the spread a single draw sits in."""
    import jax
    import jax.numpy as jnp

    from var_tpu.config import VAEConfig as JVAEConfig
    from var_tpu.config import VARConfig as JVARConfig
    from var_tpu.engine.convert import convert_vae, convert_var
    from var_tpu.engine.sampler import make_sampler as jmake_sampler
    from var_tpu.metrics import fid as J
    from var_tpu.models import var as jvar
    from var_tpu_torch.config import parse_patch_nums
    from var_tpu_torch.data.imagenet import FolderDataset, make_transform
    from var_tpu_torch.engine.sampler import fold_in, make_sampler
    from var_tpu_torch.metrics import fid as F

    args = tql.build_parser().parse_args(["--out_dir", str(tmp_path)] + MINI)
    pns = parse_patch_nums(args.pn)
    vae_cfg = tql.vae_config(args)
    reso = pns[-1] * vae_cfg.downsample
    tql.gen_dataset(str(tmp_path), args.classes, args.per_class, args.val_per_class, reso,
                    args.seed)
    train_ds = FolderDataset(str(tmp_path / "train"))
    val_ds = FolderDataset(str(tmp_path / "val"), class_to_idx=train_ds.class_to_idx)
    eval_tf = make_transform(reso, train=False)
    result, samples, models = tql.run(args, train_ds, val_ds,
                                      make_transform(reso, train=True, hflip=False), eval_tf,
                                      log=lambda s: None)
    rng = np.random.default_rng(args.seed)
    ref = np.clip((np.stack([eval_tf(item, rng) for item, _ in train_ds.samples]) + 1) * 127.5,
                  0, 255).astype(np.uint8)

    jvae_cfg = JVAEConfig(vocab_size=args.vocab, z_channels=16, ch=32, ch_mult=(1, 1, 2, 2),
                          v_patch_nums=pns)
    jvar_cfg = JVARConfig(num_classes=args.classes, depth=args.depth, embed_dim=args.width,
                          num_heads=args.heads, patch_nums=pns, vocab_size=args.vocab,
                          z_channels=16, attn_l2_norm=True)
    var_cfg = models["trained"].cfg
    jvae = convert_vae(models["vae"].state_dict(), jvae_cfg)
    jvars = {tag: jvar.stack_block_params(convert_var(models[tag].state_dict(), jvar_cfg))
             for tag in ("init", "trained")}

    def fid(extractor, u8):
        return F.frechet_distance(*F.feature_stats(extractor(ref)),
                                  *F.feature_stats(extractor(u8)))

    # the scoring half
    port_ex = F.make_vae_extractor(vae=models["vae"], device="cpu")
    jax_ex = J.make_vae_extractor(vae_params=jvae, vae_cfg=jvae_cfg)
    scored = {tag: (fid(port_ex, u8), fid(jax_ex, u8)) for tag, u8 in samples.items()}
    for tag, (got, want) in scored.items():
        assert got == pytest.approx(want, rel=1e-4), (tag, scored)
    assert round(scored["init"][0], 3) == result["fid_init"]
    assert round(scored["trained"][0], 3) == result["fid_trained"]

    # the sampling half, greedy
    labels = np.repeat(np.arange(args.classes), args.sample_per_class)
    to_u8 = lambda img: np.clip(np.asarray(img) * 255, 0, 255).astype(np.uint8)  # noqa: E731
    got = to_u8(make_sampler(var_cfg, vae_cfg, cfg_scale=args.cfg, top_k=1, top_p=0.0,
                             dtype=torch.float32, device="cpu")(
        models["trained"], models["vae"], torch.Generator().manual_seed(0), labels).image)
    want = to_u8(jmake_sampler(jvar_cfg, jvae_cfg, cfg_scale=args.cfg, top_k=1, top_p=0.0,
                               dtype=jnp.float32)(
        jvars["trained"], jvae, jax.random.PRNGKey(0), jnp.asarray(labels, jnp.int32)).image)
    greedy_err = int(np.abs(got.astype(np.int16) - want).max())
    assert greedy_err <= 1

    # draws at the loop's filter from the same weights, batched and keyed as the loop
    port_sampler = make_sampler(var_cfg, vae_cfg, cfg_scale=args.cfg, top_k=tql.TOP_K,
                                top_p=tql.TOP_P, dtype=torch.float32, device="cpu")
    jax_sampler = jmake_sampler(jvar_cfg, jvae_cfg, cfg_scale=args.cfg, top_k=tql.TOP_K,
                                top_p=tql.TOP_P, dtype=jnp.float32)

    def draw(framework, tag, seed):
        out = []
        for off in range(0, len(labels), args.bs):
            lab = labels[off:off + args.bs]
            if framework == "port":
                key = fold_in(torch.Generator().manual_seed(seed), off)
                out.append(port_sampler(models[tag], models["vae"], key, lab).image)
            else:
                key = jax.random.fold_in(jax.random.PRNGKey(seed), off)
                out.append(jax_sampler(jvars[tag], jvae, key, jnp.asarray(lab, jnp.int32)).image)
        return np.concatenate([to_u8(img) for img in out])

    seeds = range(args.seed + 7, args.seed + 7 + DRAW_SEEDS)
    draws = {fw: {tag: [] for tag in ("init", "trained")} for fw in ("port", "jax")}
    for fw in draws:
        for tag in ("init", "trained"):
            for seed in seeds:
                u8 = draw(fw, tag, seed)
                if fw == "port" and seed == args.seed + 7:
                    np.testing.assert_array_equal(u8, samples[tag])
                draws[fw][tag].append(fid(port_ex, u8))
    print(json.dumps({
        "test": "quality_loop_halves_agree_with_jax", "loop": result,
        "scored_port_jax": scored, "greedy_max_abs_u8": greedy_err, "seeds": list(seeds),
        "draws": draws,
        "improved": {fw: sum(t < i for i, t in zip(d["init"], d["trained"]))
                     for fw, d in draws.items()}}))
