"""In-repo Fréchet-distance scorer with pluggable feature extractors
(counterpart of ``var_tpu/metrics/fid.py``).

One command goes PNG folder (or packed npz) -> feature statistics -> a
number, in the repository, so quality trends can be tracked across training
runs; the reference hands its npz to the external guided-diffusion
evaluator (reference ``README.md:151-157``).

Extractors (``--extractor``), run on ``device`` (``"cuda"`` unless the
caller passes ``"cpu"``):

- ``vae`` (default): the frozen VQVAE encoder's pre-quantization features
  (``models/vae.py::img_to_f``, reference ``vqvae.py:66``), spatially mean-
  and std-pooled to a 2*Cvae vector, in float32 with TF32 off. With the
  production checkpoint these are the tokenizer's own perceptual features;
  with a seeded random init they are random-projection features: a valid
  distribution distance for trend tracking, not comparable to published
  Inception-FID numbers.
- ``inception``: the standard FID InceptionV3 pool3 (2048-d) through
  ``torch.jit.load`` of the pytorch-fid TorchScript file
  (``pt_inception-2015-12-05``), when the file is on disk.
- ``pixel``: 32x32 area-downsampled RGB, flattened. An extractor-free
  sanity baseline for tests and protocol plumbing.

The vae and pixel extractors are compiled programs (``engine/compiled.py``,
the JAX extractors' jit): on CUDA the first batch of a shape runs eagerly
and captures a CUDA graph, later batches of that shape replay it; a ragged
last batch captures its own.

Statistics are the classic (mu, Sigma) in float64 on the host; the distance
is ``|mu1-mu2|^2 + tr(S1 + S2 - 2 sqrtm(S1 S2))`` with the symmetric-product
eigenvalue form of the cross term. The numpy half is a copy of the JAX
package's and gives its values bit for bit on the same features.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from var_tpu_torch.config import VAEConfig
from var_tpu_torch.device import fp32_exact, resolve_device

Extractor = Callable[[np.ndarray], np.ndarray]  # (B,H,W,3) uint8 -> (B, D) f64


# ---------------------------------------------------------------------------
# Fréchet distance


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between N(mu1, sigma1) and N(mu2, sigma2).

    tr(sqrtm(S1 S2)) is computed as sum(sqrt(eigvals(R S2 R))) with
    R = sqrtm(S1) from a symmetric eigendecomposition: S1 S2 is similar to
    the PSD matrix R S2 R, so its eigenvalues are real and non-negative and
    no complex matrix sqrt is needed.
    """
    mu1 = np.asarray(mu1, np.float64).ravel()
    mu2 = np.asarray(mu2, np.float64).ravel()
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"statistics differ in shape: mu {mu1.shape} vs {mu2.shape}, "
                         f"sigma {sigma1.shape} vs {sigma2.shape}")

    diff = mu1 - mu2
    try:
        w1, v1 = np.linalg.eigh(sigma1)
        root1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
        cross = root1 @ sigma2 @ root1
        wc = np.linalg.eigvalsh((cross + cross.T) / 2.0)
        tr_sqrt = float(np.sqrt(np.clip(wc, 0.0, None)).sum())
    except np.linalg.LinAlgError:  # pragma: no cover - eigh is robust on PSD
        import scipy.linalg

        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        tr_sqrt = float(np.trace(covmean))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_sqrt)


def feature_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu (D,), sigma (D, D))."""
    feats = np.asarray(feats, np.float64)
    if feats.ndim != 2 or feats.shape[0] < 2:
        raise ValueError(f"need (N>=2, D) features, got {feats.shape}")
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


# ---------------------------------------------------------------------------
# image sources: a folder of {i:06d}.png (fid_sample.py layout) or a packed
# OpenAI-evaluator npz (arr_0 = (N, H, W, 3) uint8)


def iter_images(path: str, batch: int = 64,
                limit: Optional[int] = None) -> Iterator[np.ndarray]:
    """Yield (b, H, W, 3) uint8 batches from a PNG folder (read with Pillow)
    or an npz (numpy alone)."""
    if os.path.isdir(path):
        from PIL import Image

        names = sorted(f for f in os.listdir(path)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
        if limit is not None:
            names = names[:limit]
        if not names:
            raise FileNotFoundError(f"no images in {path}")
        for i in range(0, len(names), batch):
            imgs = [np.asarray(Image.open(os.path.join(path, n)).convert("RGB"))
                    for n in names[i: i + batch]]
            yield np.stack(imgs)
    else:
        arr = np.load(path)["arr_0"]
        if limit is not None:
            arr = arr[:limit]
        if arr.ndim != 4 or arr.shape[-1] != 3:
            raise ValueError(f"bad npz shape {arr.shape}: want arr_0 (N, H, W, 3)")
        for i in range(0, len(arr), batch):
            yield np.asarray(arr[i: i + batch], np.uint8)


# ---------------------------------------------------------------------------
# extractors


def _to_pm1(imgs_u8: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(imgs_u8, np.float32) / 127.5 - 1.0).to(dev)


def make_vae_extractor(vae=None, vae_cfg: Optional[VAEConfig] = None, vae_ckpt: str = "",
                       seed: int = 0, device="cuda") -> Extractor:
    """Frozen-VQVAE encoder features: ``img_to_f`` -> spatial mean+std pool
    (2*Cvae dims), float32 with TF32 off, on ``device``.

    ``vae``: a ``models.vae.VQVAE`` to score with (moved to ``device``).
    Without one, ``vae_ckpt`` is loaded when the file exists; otherwise the
    tokenizer (``vae_cfg``, default the published ch160) gets a seeded random
    init (``init_vae_params``): random-projection features, trend tracking
    only. The extractor's ``feature_space`` names which: ``"vae"`` for given
    or loaded weights, ``"vae_randproj"`` for the random init. The init
    draws from a CPU generator and then moves to ``device``, so one seed
    gives the same tokenizer on every device. It is not the JAX package's
    (another framework, another stream), so ``vae_randproj`` scores compare
    across frameworks only when the same weights are carried across
    (``engine/convert.py::vae_state_dict``) and passed as ``vae``."""
    from var_tpu_torch.models import vae as vae_mod

    dev = resolve_device(device)
    real_weights = vae is not None
    if vae is None:
        vae_cfg = vae_cfg or VAEConfig()
        with torch.device("meta"):
            vae = vae_mod.VQVAE(vae_cfg)
        if vae_ckpt and os.path.exists(vae_ckpt):
            from var_tpu_torch.engine.convert import load_torch_state_dict

            vae = vae.to_empty(device=dev)
            vae.load_state_dict(load_torch_state_dict(vae_ckpt))
            real_weights = True
        else:
            vae = vae_mod.init_vae_params(vae.to_empty(device="cpu"),
                                          torch.Generator().manual_seed(seed))
    vae = vae.to(dev)

    def features(vae, x):
        f = vae_mod.img_to_f(vae, x)  # (B, h, w, Cvae)
        return torch.cat([f.mean(dim=(1, 2)), f.std(dim=(1, 2), correction=0)], dim=-1)

    def run(call):
        def extract(imgs_u8: np.ndarray) -> np.ndarray:
            with fp32_exact():  # TF32 off: part of the compiled entry's key
                return call(vae, _to_pm1(imgs_u8, dev)).double().cpu().numpy()
        return extract

    extract = _compiled_extractor(features, 1, dev, run)
    # scores from checkpoint features and from seeded random-projection
    # features live in different spaces: the label lets callers
    # (apps/fid_score.py) name the metric accordingly
    extract.feature_space = "vae" if real_weights else "vae_randproj"
    return extract


def make_pixel_extractor(size: int = 32, device="cuda") -> Extractor:
    """Area-downsampled RGB pixels, flattened (3*size*size dims), on ``device``."""
    from var_tpu_torch.ops.resize import resize_area

    dev = resolve_device(device)

    def pixels(x):
        y = resize_area(x, (size, size))
        return y.reshape(y.shape[0], -1)

    def run(call):
        def extract(imgs_u8: np.ndarray) -> np.ndarray:
            return call(_to_pm1(imgs_u8, dev)).double().cpu().numpy()
        return extract

    return _compiled_extractor(pixels, 0, dev, run)


def _compiled_extractor(body: Callable, n_modules: int, dev: torch.device, run: Callable):
    """``run(call)``'s extractor over ``body`` compiled (``engine/compiled.py``,
    the JAX extractors' jit): one entry a batch shape, so a ragged last
    batch captures its own graph. ``extract.eager`` runs the body directly;
    ``extract.program`` is the :class:`Compiled`."""
    from var_tpu_torch.engine.compiled import Compiled

    program = Compiled(body, n_modules, dev)
    extract = run(program.static)  # the host copy reads the static output before the next call
    extract.eager = run(program.eager)
    extract.program = program
    return extract


def make_inception_extractor(scriptmodule_path: str, device="cuda") -> Extractor:
    """pytorch-fid's TorchScript InceptionV3 (pool3, 2048-d) on ``device``.
    The file is the public ``pt_inception-2015-12-05-6726825d.pt``; the
    repository does not ship it, so supply it where the weights exist."""
    if not os.path.exists(scriptmodule_path):
        raise FileNotFoundError(
            f"Inception scriptmodule not found: {scriptmodule_path!r}. True "
            "Inception-FID needs the public pt_inception-2015-12-05 TorchScript "
            "file (github.com/mseitzer/pytorch-fid); otherwise use --extractor vae.")
    dev = resolve_device(device)
    model = torch.jit.load(scriptmodule_path, map_location=dev).eval()

    @torch.inference_mode()
    def extract(imgs_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(imgs_u8, np.float32) / 255.0).to(dev)
        x = x.permute(0, 3, 1, 2)  # NCHW in [0, 1]: the pytorch-fid convention
        out = model(x)
        feats = out[0] if isinstance(out, (tuple, list)) else out
        return feats.squeeze(-1).squeeze(-1).double().cpu().numpy()

    return extract


def get_extractor(name: str, device="cuda", **kw) -> Extractor:
    if name == "vae":
        return make_vae_extractor(vae=kw.get("vae"), vae_cfg=kw.get("vae_cfg"),
                                  vae_ckpt=kw.get("vae_ckpt", ""), device=device)
    if name == "pixel":
        return make_pixel_extractor(size=kw.get("size", 32), device=device)
    if name == "inception":
        return make_inception_extractor(
            kw.get("inception_pt", "pt_inception-2015-12-05-6726825d.pt"), device=device)
    raise ValueError(f"unknown extractor {name!r} (vae | pixel | inception)")


def path_stats(path: str, extractor: Extractor, batch: int = 64,
               limit: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """mu/sigma of a PNG folder, an images npz (arr_0), or a precomputed
    stats npz (mu + sigma keys, as the OpenAI reference batches ship)."""
    if not os.path.isdir(path) and path.endswith(".npz"):
        z = np.load(path)
        if "mu" in z and "sigma" in z:
            return np.asarray(z["mu"], np.float64), np.asarray(z["sigma"], np.float64)
    feats = [extractor(b) for b in iter_images(path, batch=batch, limit=limit)]
    return feature_stats(np.concatenate(feats, axis=0))


def fid_between(path_a: str, path_b: str, extractor: Extractor,
                batch: int = 64, limit: Optional[int] = None) -> float:
    mu1, s1 = path_stats(path_a, extractor, batch=batch, limit=limit)
    mu2, s2 = path_stats(path_b, extractor, batch=batch, limit=limit)
    return frechet_distance(mu1, s1, mu2, s2)
