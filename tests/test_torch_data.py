"""The port's data pipeline (``var_tpu_torch/data``) against the JAX
package's, on the CPU.

Samplers, per-sample streams and loaders are numpy on both sides, so every
index stream and batch must be equal bit for bit; the native C++ pipeline
(the same ``native/varloader.cc``, each package building its own library)
must give the JAX build's batches exactly and PIL's within the JAX tests'
tolerance (``tests/test_data.py``).
"""

import json
import os
import shutil

import numpy as np
import pytest

from var_tpu.data import imagenet as jdata
from var_tpu.data import native_loader as jnative
from var_tpu_torch.data import imagenet as tdata
from var_tpu_torch.data import native_loader as tnative


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Three classes of four seeded images of odd sizes, JPEG and PNG."""
    from PIL import Image

    root = tmp_path_factory.mktemp("torch_data")
    rng = np.random.default_rng(0)
    for cls in ("c0", "c1", "c2"):
        (root / cls).mkdir()
        for i in range(4):
            img = Image.fromarray(rng.integers(0, 255, (80, 72, 3), dtype=np.uint8))
            img.save(root / cls / (f"{i}.jpg" if i % 2 == 0 else f"{i}.png"), quality=95)
    return str(root)


def _take(sampler, n):
    """The first ``n`` batches and the sampler's ``epoch`` right after each."""
    it = iter(sampler)
    out = []
    for _ in range(n):
        out.append((next(it), sampler.epoch))
    return out


@pytest.mark.parametrize("world_size,rank", [(1, 0), (2, 0), (2, 1), (3, 2)])
@pytest.mark.parametrize("start_ep,start_it", [(0, 0), (0, 2), (3, 1)])
@pytest.mark.parametrize("fill_last,shuffle", [(True, True), (False, True), (True, False)])
def test_sampler_streams_match_jax(world_size, rank, start_ep, start_it, fill_last, shuffle):
    """Index batches and the epoch counter over three epochs, equal to JAX's."""
    kw = dict(world_size=world_size, rank=rank, dataset_len=23, glb_batch_size=6 * world_size,
              same_seed_for_all_ranks=5, fill_last=fill_last, shuffle=shuffle,
              start_ep=start_ep, start_it=start_it)
    j, t = jdata.DistInfiniteBatchSampler(**kw), tdata.DistInfiniteBatchSampler(**kw)
    assert len(t) == len(j) and t.indices == j.indices and t.max_p == j.max_p
    assert _take(t, 3 * len(j)) == _take(j, 3 * len(j))


def test_eval_split_and_sample_rng_match_jax():
    for n, world in ((10, 3), (7, 1), (5, 4), (0, 2)):
        for r in range(world):
            assert tdata.eval_split_indices(n, world, r) == jdata.eval_split_indices(n, world, r)
    for key in ((0, 0, 0), (1, 3, 42), (7, 250, 1281166)):
        a, b = tdata.sample_rng(*key), jdata.sample_rng(*key)
        np.testing.assert_array_equal(a.random(16), b.random(16))
        np.testing.assert_array_equal(a.integers(0, 97, 8), b.integers(0, 97, 8))


def test_build_imagenet_a_dataset_maps_labels_as_jax(tmp_path):
    idx = {"0": ["n01440764", "tench"], "6": ["n01496331", "electric_ray"],
           "11": ["n01531178", "goldfinch"], "999": ["n15075141", "toilet_tissue"]}
    index_json = tmp_path / "imagenet_class_index.json"
    index_json.write_text(json.dumps(idx))
    root = tmp_path / "imagenet-a"
    for wnid in ("n15075141", "n01531178", "n01440764", "n99999999"):  # the last is unknown
        (root / wnid).mkdir(parents=True)
        for i in range(2):
            (root / wnid / f"{i}.jpg").write_bytes(b"")
    got = tdata.build_imagenet_a_dataset(str(root), str(index_json))
    want = jdata.build_imagenet_a_dataset(str(root), str(index_json))
    assert got.class_to_idx == want.class_to_idx == {
        "n01440764": 0, "n01531178": 11, "n15075141": 999}
    assert got.samples == want.samples and len(got) == 6


def _native_jax(tmp_path, monkeypatch):
    """The JAX package's native library, built into a private directory
    unless this process has loaded it already (a JAX data test in the same
    worker): two workers never write one file."""
    if jnative._lib is None:
        lib_dir = str(tmp_path / "jax_native")
        monkeypatch.setattr(jnative, "_LIB_DIR", lib_dir)
        monkeypatch.setattr(jnative, "_LIB", os.path.join(lib_dir, "libvarloader.so"))
    if not (shutil.which("g++") and tnative.available() and jnative.available()):
        pytest.skip("native toolchain unavailable")


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("native", [False, True])
def test_dataloader_batches_match_jax(folder, threads, native, tmp_path, monkeypatch):
    """Train-mode loaders (random crop, flip) over the sampler object, two and
    a half epochs, so the epoch the producer reads crosses two boundaries."""
    if native:
        _native_jax(tmp_path, monkeypatch)
    kw = dict(world_size=1, rank=0, dataset_len=12, glb_batch_size=5,
              same_seed_for_all_ranks=3, start_ep=1, start_it=1)
    batches = []
    for data, nat in ((tdata, tnative), (jdata, jnative)):
        ds = data.FolderDataset(folder)
        btf = nat.make_native_batch_transform(40, train=True, hflip=True) if native else None
        loader = data.DataLoader(ds, data.DistInfiniteBatchSampler(**kw),
                                 data.make_transform(40, train=True, hflip=True),
                                 num_threads=threads, seed=9, batch_transform=btf)
        it = iter(loader)
        batches.append([next(it) for _ in range(7)])
    for (ti, tl), (ji, jl) in zip(*batches):
        assert ti.dtype == np.float32 and tl.dtype == np.int32 and ti.shape == (5, 40, 40, 3)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_dataloader_eval_batches_and_errors(folder):
    """A finite batch list ends the loader; a failing transform raises in the
    consumer instead of hanging it."""
    ds = tdata.FolderDataset(folder)
    batches = [[0, 1, 2], [3, 4]]
    got = list(tdata.DataLoader(ds, iter(batches), tdata.make_transform(32, train=False),
                                num_threads=2))
    want = list(jdata.DataLoader(jdata.FolderDataset(folder), iter(batches),
                                 jdata.make_transform(32, train=False), num_threads=2))
    assert len(got) == len(want) == 2
    for (ti, tl), (ji, jl) in zip(got, want):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)

    def broken(path, rng):
        raise ValueError(f"cannot read {path}")

    with pytest.raises(ValueError, match="cannot read"):
        list(tdata.DataLoader(ds, iter(batches), broken, num_threads=2))


def test_native_loader_matches_jax_and_pil(folder, tmp_path, monkeypatch):
    """The port's library gives the JAX build's batch exactly (centre crops and
    random crops with flips) and PIL's within the JAX tests' tolerance."""
    _native_jax(tmp_path, monkeypatch)
    assert os.path.dirname(tnative._LIB).endswith(os.path.join("var_tpu_torch", "data", "_build"))
    ds = tdata.FolderDataset(folder)
    paths = [p for p, _ in ds.samples]
    rng = np.random.default_rng(4)
    crops = np.stack([rng.random(len(paths)), rng.random(len(paths)),
                      (rng.random(len(paths)) < 0.5)], 1).astype(np.float32)
    for c in (None, crops):
        got = tnative.load_batch(paths, 72, 64, c, num_threads=4)
        np.testing.assert_array_equal(got, jnative.load_batch(paths, 72, 64, c, num_threads=4))
        assert got.shape == (len(paths), 64, 64, 3) and np.isfinite(got).all()
    tf = tdata.make_transform(64, train=False)
    for path in paths[:4]:
        diff = np.abs(tf(path, rng) - tnative.load_image(path, round(1.125 * 64), 64))
        # PIL quantises filter coefficients to 8 bits and clips per pass
        assert diff.mean() < 0.01 and diff.max() < 0.15, (diff.mean(), diff.max())
