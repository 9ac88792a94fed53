"""Each CUDA kernel of the port against its plain PyTorch version, on an
NVIDIA GPU. Every test here is marked ``cuda`` and skips without a card (a
CUDA kernel has no CPU mode). This file imports no JAX, so it runs on a GPU
machine without it (``-s`` shows the planted-fault errors):

    python -m pytest --noconftest -p no:cacheprovider -q -s tests/test_torch_cuda.py
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from var_tpu_torch.ops.attention import attention
from var_tpu_torch.ops.cuda.flash_attention import (flash_attention, flash_attention_bwd,
                                                    flash_attention_fwd,
                                                    flash_attention_paired_train, flash_decode,
                                                    flash_decode_plain, paired_train_bwd,
                                                    paired_train_fwd)

ROOT = Path(__file__).resolve().parent.parent
from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm, modulated_layernorm_plain
from var_tpu_torch.ops.cuda.gn_stats import gn_channel_stats, gn_channel_stats_plain
from var_tpu_torch.ops.cuda.select import (bound_mass_gap, topk_topp_bound,
                                           topk_topp_bound_plain)


def _ln_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    b, _, c = shape
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.standard_normal((b, c)) * 0.3).astype(np.float32)
    shift = (rng.standard_normal((b, c)) * 0.3).astype(np.float32)
    return x, scale, shift


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_modulated_layernorm_matches_plain(cuda, dtype):
    x, scale, shift = (torch.from_numpy(a).to(cuda) for a in _ln_inputs((4, 37, 1024), 1))
    p6 = torch.stack([scale, scale, scale, shift, shift, shift], 1)  # strided rows
    x = x.to(dtype)
    before = modulated_layernorm.launches
    got = modulated_layernorm(x, p6[:, 2], p6[:, 4])
    torch.cuda.synchronize()
    assert modulated_layernorm.launches == before + 1
    want = modulated_layernorm_plain(x, p6[:, 2], p6[:, 4])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1024, 1280, 1536, 1920, 2304, 1000])
@pytest.mark.parametrize("l", [1, 256])
def test_cuda_modulated_layernorm_every_width(cuda, dtype, c, l):
    """Each published width C = 64 * depth has its own instantiation (chunks
    per lane); C 1000 takes the generic one, its last chunks masked. 16 rows
    (the first stage, 2B x 1) and 4096 (the last, 2B x 256), with the
    modulation as strided rows of the (B, 6, C) AdaLN table."""
    x, scale, shift = (torch.from_numpy(a).to(cuda) for a in _ln_inputs((16, l, c), c + l))
    p6 = torch.stack([scale, scale, scale, shift, shift, shift], 1)
    x = x.to(dtype)
    got = modulated_layernorm(x, p6[:, 2], p6[:, 4])
    torch.cuda.synchronize()
    want = modulated_layernorm_plain(x, p6[:, 2], p6[:, 4])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_modulated_layernorm_unaligned_modulation_rows(cuda, dtype):
    """Modulation rows that do not start on 16-byte boundaries (row stride
    C + 1) take the kernel's one-by-one loads."""
    x, scale, shift = (torch.from_numpy(a).to(cuda) for a in _ln_inputs((3, 20, 1024), 9))
    wide = torch.zeros(3, 2, 1025, device=cuda)
    wide[:, 0, 1:], wide[:, 1, 1:] = scale, shift
    sc, sh = wide[:, 0, 1:], wide[:, 1, 1:]
    x = x.to(dtype)
    got = modulated_layernorm(x, sc, sh)
    torch.cuda.synchronize()
    want = modulated_layernorm_plain(x, sc, sh)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _select_rows(rows, v, seed, cuda):
    """Half N(0, 16) rows, half the fp16-grid rows of test_torch_kernels.py
    (about 13 distinct values: real ties at the k-th value and at the top-p
    threshold)."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((rows, v)) * 4).astype(np.float32)
    grid = (np.round(rng.standard_normal((rows, v)) * 2.0) / 2.0).astype(np.float16)
    logits[1::2] = grid[1::2].astype(np.float32)
    return torch.from_numpy(logits).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("v", [4096, 1000])
@pytest.mark.parametrize("rows", [8, 2048])
@pytest.mark.parametrize("k", [1, 900, 0])
def test_cuda_topk_topp_bound_stage_shapes(cuda, v, rows, k):
    """The first and last decode stage's row counts (each with its own
    threads per row), V 4096 and 1000 (no multiple of 16 bytes x 32: the
    scalar loads), k 1, 900 and V (``top_k`` 0), on tie-heavy rows: top-k
    bounds equal to the plain version's, top-p (0.96) bounds within the
    mass-gap rule, and two launches bit-identical."""
    logits = _select_rows(rows, v, rows + v + k, cuda)
    tk = topk_topp_bound(logits, k, 0.0)
    got = topk_topp_bound(logits, k, 0.96)
    torch.cuda.synchronize()
    torch.testing.assert_close(tk, topk_topp_bound_plain(logits, k, 0.0), rtol=0, atol=0)
    assert torch.equal(topk_topp_bound(logits, k, 0.0), tk)
    assert torch.equal(topk_topp_bound(logits, k, 0.96), got)
    gap, _ = bound_mass_gap(logits, tk, got, topk_topp_bound_plain(logits, k, 0.96), 0.96)
    assert gap <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("k,p", [(900, 0.96), (1, 0.0), (0, 0.5)])
def test_cuda_topk_topp_bound_matches_plain(cuda, k, p):
    """Top-k bounds are exact counts and must be equal; top-p bounds may
    differ only where the fp32 mass sums straddle p * M."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy((rng.standard_normal((21, 1024)) * 4).astype(np.float32)).to(cuda)
    tk = topk_topp_bound(logits, k, 0.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(tk, topk_topp_bound_plain(logits, k, 0.0), rtol=0, atol=0)
    gap, _ = bound_mass_gap(logits, tk, topk_topp_bound(logits, k, p),
                            topk_topp_bound_plain(logits, k, p), p)
    assert gap <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l2", [False, True])
def test_cuda_flash_decode_matches_plain(cuda, dtype, l2):
    """bf16 is held against the plain version in fp32 on the same bf16
    inputs, within 3 bf16 ulps of max|want|; with ``l2`` the K cache is
    L2-normalised per head, as the model writes it."""
    h, b, lmax, l, cum = 4, 3, 300, 100, 91
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(b, l, 3 * 64 * h, generator=g, device=cuda).to(dtype)
    k = torch.randn(b, lmax, 64 * h, generator=g, device=cuda)
    v = torch.randn(b, lmax, 64 * h, generator=g, device=cuda).to(dtype)
    if l2:
        kh = k.reshape(b, lmax, h, 64)
        k = (kh * torch.rsqrt((kh * kh).sum(-1, keepdim=True) + 1e-24)).reshape(b, lmax, -1)
    k = k.to(dtype)
    sm = torch.full((h,), 4.0, device=cuda) if l2 else None
    scale = 1.0 if l2 else 0.125
    got = flash_decode(qkv, k, v, cum + l, h, scale, sm).float()
    torch.cuda.synchronize()
    want = flash_decode_plain(qkv.float(), k.float(), v.float(), cum + l, h, scale, sm)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        m = float(want.abs().max())
        ulp = torch.finfo(torch.bfloat16).eps * 2.0 ** np.floor(np.log2(m))
        assert float((got - want).abs().max()) <= 3 * ulp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_cuda_flash_decode_takes_any_scale(cuda, dtype, scale):
    """Row 2's post-dot scale may be negative (the bf16 kernel negates q so
    that its softmax factor is never negative) or zero (uniform weights,
    nothing from the rows past lk), as in the plain version."""
    h, b, lmax, l, lk = 2, 2, 200, 70, 131
    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(b, l, 3 * 64 * h, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(b, lmax, 64 * h, generator=g, device=cuda).to(dtype) for _ in range(2))
    k[:, lk:], v[:, lk:] = float("nan"), float("nan")
    got = flash_decode(qkv, k, v, lk, h, scale).float()
    torch.cuda.synchronize()
    want = flash_decode_plain(qkv.float(), k.float(), v.float(), lk, h, scale)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert float((got - want).abs().max()) <= 3 * _ulp(float(want.abs().max()))


def _ulp(x: float) -> float:
    return float(torch.finfo(torch.bfloat16).eps * 2.0 ** np.floor(np.log2(x)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ends", [(1, 5, 14, 30, 55, 91, 155), None])
def test_cuda_paired_train_matches_plain(cuda, dtype, ends):
    """Forward and backward kernels against autograd through the plain
    block-causal attention in fp32 on the same inputs, L past one 64-row
    tile and not a multiple of it: fp32 within 1e-4 + 1e-4 |want|, bf16
    within 4 bf16 ulps of each tensor's max|want|."""
    b, h, l = 2, 4, 155
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn(b, l, 64 * h, generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    got_in = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = paired_train_fwd.launches, paired_train_bwd.launches
    out = flash_attention_paired_train(*got_in, h, 0.125, ends)
    out.backward(do)
    torch.cuda.synchronize()
    assert (paired_train_fwd.launches, paired_train_bwd.launches) == (f0 + 1, b0 + 1)
    want_in = [t.float().requires_grad_() for t in (q, k, v)]
    ref = attention(*(t.reshape(b, l, h, 64) for t in want_in), 0.125, ends).reshape(b, l, -1)
    ref.backward(do.float())
    for got, want in zip([out] + [t.grad for t in got_in], [ref] + [t.grad for t in want_in]):
        got, want = got.detach().float(), want.detach()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert float((got - want).abs().max()) <= 4 * _ulp(float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_paired_train_takes_head_dim_64_only(cuda):
    q = torch.zeros(1, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_paired_train(q, q, q, 2, 1.0, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 3, 5])
def test_cuda_kernels_take_an_odd_head_count(cuda, dtype, h):
    """Rows 2, 4 and 6 at an odd head count, as a model rank holds it under
    tensor parallelism (d20 at mp 4: 5 heads; d30 at mp 2: 15): each CUDA
    block takes one head, so no head pairs are needed. Each against its
    plain version in fp32 on the same inputs, at the tolerances of the
    tests above (fp32 1e-4 + 1e-4 |want|; bf16 3 ulps for decode, 4 for
    training, of max|want|)."""
    from var_tpu_torch.ops.cuda.flash_attention import (flash_decode_paired,
                                                        flash_decode_paired_plain)

    c, b, lmax, l, lk = 64 * h, 2, 160, 25, 120
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(b, l, 3 * c, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(b, lmax, c, generator=g, device=cuda).to(dtype) for _ in range(2))
    sm = torch.full((h,), 4.0, device=cuda)

    def close(got, want, ulps):
        got = got.detach().float()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert float((got - want).abs().max()) <= ulps * _ulp(float(want.abs().max()))

    kh = k.float().reshape(b, lmax, h, 64)  # row 2 as an l2 model feeds it: K normalised
    k_l2 = (kh * torch.rsqrt((kh * kh).sum(-1, keepdim=True) + 1e-24)).reshape(k.shape).to(dtype)
    f = [t.float() for t in (qkv, k, v)]
    launches = (flash_decode.launches, flash_decode_paired.launches,
                paired_train_fwd.launches, paired_train_bwd.launches)
    close(flash_decode(qkv, k_l2, v, lk, h, 1.0, sm),
          flash_decode_plain(f[0], k_l2.float(), f[2], lk, h, 1.0, sm), 3)
    close(flash_decode_paired(qkv, k, v, h, 0.125, lk=lk),
          flash_decode_paired_plain(*f, h, 0.125, lk), 3)
    ends = (1, 5, 14, 30, 55, 91, 155)
    q, kt, vt, do = (torch.randn(b, 155, c, generator=g, device=cuda).to(dtype)
                     for _ in range(4))
    got_in = [t.clone().requires_grad_() for t in (q, kt, vt)]
    out = flash_attention_paired_train(*got_in, h, 0.125, ends)
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_decode.launches, flash_decode_paired.launches, paired_train_fwd.launches,
            paired_train_bwd.launches) == tuple(n + 1 for n in launches)
    want_in = [t.float().requires_grad_() for t in (q, kt, vt)]
    ref = attention(*(t.reshape(b, 155, h, 64) for t in want_in), 0.125, ends).reshape(b, 155, -1)
    ref.backward(do.float())
    for got, want in zip([out] + [t.grad for t in got_in], [ref] + [t.grad for t in want_in]):
        close(got, want.detach(), 4)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_paired_matches_plain(cuda, dtype):
    """Row 4 against its plain version at every (Lq, Lk) of the d16 bs8
    prealloc and kv_window=2 decodes (chip_smoke.check_decode_paired: fp32
    within 1e-4 + 1e-4 |want|, bf16 within 3 bf16 ulps of max|want|)."""
    from var_tpu_torch.ops.cuda.flash_attention import flash_decode_paired

    before = flash_decode_paired.launches
    _chip_smoke().check_decode_paired(cuda, dtypes=(dtype,))
    torch.cuda.synchronize()
    assert flash_decode_paired.launches > before


def _paired_decode_card_and_cpu(cuda, l2: bool, **decode_kw):
    """A greedy fp32 decode of a tiny head_dim-64 model (``attn_l2_norm``
    = ``l2``) on the CPU and on the card, through the paired cache route:
    {device type: (tokens, f_hat, flash_decode_paired launches)}."""
    from var_tpu_torch.config import VAEConfig, VARConfig
    from var_tpu_torch.device import fp32_exact
    from var_tpu_torch.engine.sampler import decode_tokens_cfg
    from var_tpu_torch.models import vae as vae_mod
    from var_tpu_torch.models import var as var_mod
    from var_tpu_torch.ops.cuda.flash_attention import flash_decode_paired

    pns = (1, 2, 3, 4, 5, 6)
    gen = torch.Generator().manual_seed(3)
    vae = vae_mod.init_vae_params(vae_mod.VQVAE(VAEConfig(
        vocab_size=64, z_channels=8, ch=32, ch_mult=(1, 1), v_patch_nums=pns)), gen)
    var = var_mod.init_var_params(var_mod.VAR(VARConfig(
        num_classes=10, depth=2, embed_dim=128, num_heads=2, patch_nums=pns, vocab_size=64,
        z_channels=8, attn_l2_norm=l2, cond_drop_rate=0.0)), gen, init_head=2.0)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        v, q = var.to(dev).eval(), vae.to(dev).eval()
        before = flash_decode_paired.launches
        with torch.inference_mode(), fp32_exact():
            tokens, f_hat = decode_tokens_cfg(
                v, q, torch.tensor([1, 7, 3], device=dev),
                torch.Generator(device=dev).manual_seed(0), cfg_scale=1.5, top_k=1,
                dtype=torch.float32, **decode_kw)
        torch.cuda.synchronize()
        out[dev.type] = (tokens.cpu(), f_hat.cpu(), flash_decode_paired.launches - before)
    assert out["cuda"][2] == 2 * len(pns) and out["cpu"][2] == 0
    return out


@pytest.mark.cuda
def test_cuda_kv_window_decode_equals_cpu(cuda):
    """A greedy fp32 kv_window=2 decode of a head_dim-64 model on the card
    (through flash_decode_paired) gives the CPU's tokens."""
    out = _paired_decode_card_and_cpu(cuda, True, kv_window=2)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("l2", [False, True])
def test_cuda_prealloc_decode_equals_cpu(cuda, l2):
    """A greedy fp32 prealloc decode on the card, where flash_decode_paired
    reads q from the fused qkv, gives the CPU's tokens: for a model with the
    q/k L2 norm (the norm in the launch) and for one without it (raw q, the
    scale 0.25 / sqrt(d) folded in)."""
    out = _paired_decode_card_and_cpu(cuda, l2, cache_impl="prealloc")
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=0)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_matches_plain(cuda, dtype):
    """Row 5's forward and backward kernels against their plain versions at
    the d16 512px training shape, the 1024px eval shape (forward), an
    unmasked Lq 256 / Lk 680 shape and a ragged L of 1015
    (chip_smoke.check_flash: fp32 within 1e-4 + 1e-4 |want|, bf16 within 3
    bf16 ulps of each tensor's max|want|)."""
    f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    _chip_smoke().check_flash(cuda, dtypes=(dtype,))
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == f0 + 4 and flash_attention_bwd.launches == b0 + 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ends,lq,lk", [((1, 5, 14, 30, 55, 91, 155), 155, 155),
                                        (None, 100, 155)])
def test_cuda_flash_attention_autograd_matches_dense(cuda, dtype, ends, lq, lk):
    """flash_attention through autograd (scale folded into q, the kernels
    forward and backward) against autograd through the dense fp32-logit
    attention in fp32 on the same inputs: fp32 within 1e-4 + 1e-4 |want|,
    bf16 within 4 bf16 ulps of each tensor's max|want| (the input's
    rounding of q * scale, p and ds on top of the output's)."""
    from var_tpu_torch.ops.attention import attention_fp32_logits

    b, h = 2, 4
    g = torch.Generator(device=cuda).manual_seed(2)
    q, do = (torch.randn(b, lq, h, 64, generator=g, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, lk, h, 64, generator=g, device=cuda).to(dtype) for _ in range(2))
    got_in = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
    out = flash_attention(*got_in, 0.125, ends)
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == (f0 + 1, b0 + 1)
    want_in = [t.float().requires_grad_() for t in (q, k, v)]
    ref = attention_fp32_logits(*want_in, 0.125, ends)
    ref.backward(do.float())
    for got, want in zip([out] + [t.grad for t in got_in], [ref] + [t.grad for t in want_in]):
        got, want = got.detach().float(), want.detach()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert float((got - want).abs().max()) <= 4 * _ulp(float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_flash_attention_takes_head_dim_64_only(cuda):
    q = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q, 1.0, None)


def _planted_copy(tmp_path, source: str, old: str, new: str, min_count: int = 2) -> None:
    """A copy of the package in tmp_path whose ``source`` carries a planted
    fault (every occurrence of ``old``, at least ``min_count``, replaced by
    ``new``)."""
    shutil.copytree(ROOT / "var_tpu_torch", tmp_path / "var_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = tmp_path / "var_tpu_torch" / "ops" / "cuda" / "csrc" / source
    text = src.read_text()
    assert text.count(old) >= min_count
    src.write_text(text.replace(old, new))


def _run_check(tmp_path, check: str):
    """Run ``chip_smoke.<check>(cuda:0)`` against the planted copy; returns
    (exit code, last line of its errors)."""
    code = (f"import sys; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]; "
            "import torch, chip_smoke, var_tpu_torch; "
            f"assert var_tpu_torch.__file__.startswith({str(tmp_path)!r}); "
            f"chip_smoke.{check}(torch.device('cuda', 0))")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900)
    return run.returncode, (run.stderr.strip().splitlines() or [""])[-1]


@pytest.mark.cuda
def test_planted_fault_fails_the_decode_paired_check(cuda, tmp_path):
    """A copy of the bf16 decode-attention kernel that streams one K/V tile
    too few (none of the last, partial one), built in tmp_path, must fail
    chip_smoke.check_decode_paired."""
    _planted_copy(tmp_path, "flash_attention.cu", "const int ntiles = (Lk + DEC_BK - 1) / DEC_BK;",
                  "const int ntiles = max(1, (Lk - 1) / DEC_BK);", min_count=1)
    rc, last = _run_check(tmp_path, "check_decode_paired")
    print(json.dumps({"mutant": "decode_skip_last_k_tile", "rc": rc, "error": last[:3000]}))
    assert rc != 0 and "flash_decode_paired differs from its plain version" in last


# planted faults of the bf16 decode kernel's K/V ring
DECODE_MUTANTS = {
    # S reads the K tile of the next stage of the ring, not the one tile
    # ``it`` landed in (the barriers stay right: no hang)
    "wrong_stage": ("wgmma_desc_sw128(sk + kst * DEC_TILE,",
                    "wgmma_desc_sw128(sk + (kst + 1) % DEC_KSTAGES * DEC_TILE,"),
    # tensor maps one tile longer than the cache: rows >= lk come from the
    # buffer (NaN in the checks), not as zeros
    "no_zero_fill": ("kv_bs, kv_rs, B, Lk, H)", "kv_bs, kv_rs, B, Lk + DEC_BK, H)"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(DECODE_MUTANTS))
def test_planted_fault_fails_both_decode_checks(cuda, tmp_path, mutant):
    """A copy of the package whose bf16 decode kernel carries a planted
    fault in its K/V ring, built in tmp_path, must fail chip_smoke's checks
    of row 2 (check_decode) and of row 4 (check_decode_paired)."""
    _planted_copy(tmp_path, "flash_attention.cu", *DECODE_MUTANTS[mutant], min_count=1)
    for check, name in (("check_decode", "flash_decode"),
                        ("check_decode_paired", "flash_decode_paired")):
        rc, last = _run_check(tmp_path, check)
        print(json.dumps({"mutant": mutant, "check": check, "rc": rc, "error": last[:3000]}))
        assert rc != 0 and f"{name} differs from its plain version" in last


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_matches_plain_at_the_stage_shapes(cuda, dtype):
    """Row 2 against its plain version at every stage of the d16 bs8 chunked
    decode, NaN past lk (chip_smoke.check_decode: fp32 within 1e-4 + 1e-4
    |want|, bf16 within 3 bf16 ulps of max|want|)."""
    before = flash_decode.launches
    _chip_smoke().check_decode(cuda, dtypes=(dtype,))
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 2 * 10


# planted faults: textual mutations of the training-attention source
# (old text, new text, least count of the old text)
MUTANTS = {
    # the fp32 forward loop and the fp32 dQ loop skip the last key tile
    "skip_last_k_tile": ("k0 < kend;", "k0 + PT_T < kend;", 2),
    # ds = p * dp in both fp32 backward kernels (delta unused)
    "drop_delta": ("- dlt)", ")", 2),
    # the bf16 dQ loop streams one key tile too few (none of the last)
    "bf16_skip_last_k_tile": ("const int ntiles = (kend + PT_T - 1) / PT_T;",
                              "const int ntiles = max(1, (kend - 1) / PT_T);", 1),
    # the delta the bf16 dQ kernel computes in its launch is 0: ds = p * dp
    # in both bf16 kernels
    "bf16_drop_delta": ("dsum += __shfl_xor_sync(0xffffffffu, dsum, 4);", "dsum = 0.f;", 1),
    # the bf16 forward streams one key tile too few (none of the last)
    "bf16_fwd_skip_last_k_tile": ("const int nkt = (kend + PT_T - 1) / PT_T;",
                                  "const int nkt = max(1, (kend - 1) / PT_T);", 1),
}
# a planted fault of the bf16 backward's rings: S and dP (dQ) and S^T and
# dP^T (dK/dV) read the tiles of the next stage, not of the one their tile
# landed in (the barriers stay right: no hang)
RING_MUTANT = ("= ring + 2 * st * BW_TILE;", "= ring + 2 * ((st + 1) % 3) * BW_TILE;")
# a planted fault of the bf16 forward's K ring: S reads the K tile of the
# next stage, not of the one tile ``it`` landed in (the barriers stay right)
FWD_RING_MUTANT = ("wgmma_desc_sw128(sk + kst * BW_TILE,",
                   "wgmma_desc_sw128(sk + (kst + 1) % FW_KSTAGES * BW_TILE,")


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_planted_fault_fails_the_training_attention_check(cuda, tmp_path, mutant):
    """A copy of the package whose training-attention kernels carry a
    planted fault, built in tmp_path, must fail chip_smoke.check_ptrain at
    the d16 batch-32 shapes. Prints the check's error line."""
    _planted_copy(tmp_path, "flash_attention_train.cu", *MUTANTS[mutant])
    rc, last = _run_check(tmp_path, "check_ptrain")
    print(json.dumps({"mutant": mutant, "rc": rc, "error": last[:3000]}))
    assert rc != 0 and "differs from its plain version" in last


@pytest.mark.cuda
def test_planted_fault_fails_both_training_attention_checks(cuda, tmp_path):
    """A copy of the package whose bf16 backward reads the wrong stage of
    its rings (RING_MUTANT, in the dQ and the dK/dV kernel), built in
    tmp_path, must fail chip_smoke's checks of row 6 (check_ptrain) and of
    row 5 (check_flash)."""
    _planted_copy(tmp_path, "flash_attention_train.cu", *RING_MUTANT)
    for check, name in (("check_ptrain", "flash_attention_paired_train"),
                        ("check_flash", "flash_attention")):
        rc, last = _run_check(tmp_path, check)
        print(json.dumps({"mutant": "wrong_stage", "check": check, "rc": rc,
                          "error": last[:3000]}))
        assert rc != 0 and f"{name} differs from its plain version" in last


@pytest.mark.cuda
def test_planted_fault_in_the_forward_ring_fails_both_training_attention_checks(cuda, tmp_path):
    """A copy of the package whose bf16 forward reads the wrong stage of its
    K ring (FWD_RING_MUTANT), built in tmp_path, must fail chip_smoke's
    checks of row 6 (check_ptrain) and of row 5 (check_flash)."""
    _planted_copy(tmp_path, "flash_attention_train.cu", *FWD_RING_MUTANT, min_count=1)
    for check, name in (("check_ptrain", "flash_attention_paired_train"),
                        ("check_flash", "flash_attention")):
        rc, last = _run_check(tmp_path, check)
        print(json.dumps({"mutant": "fwd_wrong_stage", "check": check, "rc": rc,
                          "error": last[:3000]}))
        assert rc != 0 and f"{name} differs from its plain version" in last


@pytest.mark.cuda
def test_planted_fault_fails_the_flash_attention_check(cuda, tmp_path):
    """A copy of the package whose row-5 instantiation alone skips the last
    K tile of its fp32 forward loop and its fp32 dQ loop, built in
    tmp_path, must fail chip_smoke.check_flash."""
    _planted_copy(tmp_path, "flash_attention_train.cu", "k0 < kend;",
                  "k0 + (kRow == 5 ? PT_T : 0) < kend;")
    rc, last = _run_check(tmp_path, "check_flash")
    print(json.dumps({"mutant": "flash_skip_last_k_tile", "rc": rc, "error": last[:3000]}))
    assert rc != 0 and "flash_attention differs from its plain version" in last


@pytest.mark.cuda
def test_planted_fault_in_the_bf16_backward_fails_the_flash_attention_check(cuda, tmp_path):
    """A copy of the package whose row-5 instantiation alone skips the last
    K tile of its bf16 dQ loop, built in tmp_path, must fail
    chip_smoke.check_flash."""
    _planted_copy(tmp_path, "flash_attention_train.cu",
                  "const int ntiles = (kend + PT_T - 1) / PT_T;",
                  "const int ntiles = max(1, (kend - 1 + (kRow == 5 ? 0 : PT_T)) / PT_T);",
                  min_count=1)
    rc, last = _run_check(tmp_path, "check_flash")
    print(json.dumps({"mutant": "flash_bf16_skip_last_k_tile", "rc": rc,
                      "error": last[:3000]}))
    assert rc != 0 and "flash_attention differs from its plain version" in last


@pytest.mark.cuda
def test_planted_fault_in_the_bf16_forward_fails_the_flash_attention_check(cuda, tmp_path):
    """A copy of the package whose row-5 instantiation alone streams one key
    tile too few in its bf16 forward, built in tmp_path, must fail
    chip_smoke.check_flash."""
    _planted_copy(tmp_path, "flash_attention_train.cu",
                  "const int nkt = (kend + PT_T - 1) / PT_T;",
                  "const int nkt = max(1, (kend - 1 + (kRow == 5 ? 0 : PT_T)) / PT_T);",
                  min_count=1)
    rc, last = _run_check(tmp_path, "check_flash")
    print(json.dumps({"mutant": "flash_bf16_fwd_skip_last_k_tile", "rc": rc,
                      "error": last[:3000]}))
    assert rc != 0 and "flash_attention differs from its plain version" in last


# (name, Lq, Lk, ends) the main-path shapes do not reach: one 64-row TMA box
# not filled (L 14, --pn 1_2_3), one row, one key past a tile, and an
# unmasked Lq 64 / Lk 65
EDGE_SHAPES = [("l14", 14, 14, (1, 5, 14)), ("l1", 1, 1, (1,)),
               ("l65", 65, 65, (1, 5, 14, 30, 65)), ("unmasked", 64, 65, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("row", [6, 5])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=[s[0] for s in EDGE_SHAPES])
def test_cuda_training_attention_bf16_at_the_forward_edges(cuda, row, shape):
    """Both rows' bf16 forward and backward kernels against their plain
    versions on the same bf16 inputs (the backward of both fed the kernel's
    out and lse), with chip_smoke's tolerances: out within 3 bf16 ulps of
    max|want|, lse within 1e-4 + 1e-4 |want|; dq, dk, dv within 3 bf16 ulps
    of max(max|want|, 1) -- at L 1 dq and dk are 0 but for fp32 rounding in
    dp - delta, so the ulp is taken at no less than 1, the inputs' scale."""
    from var_tpu_torch.ops.cuda.flash_attention import (flash_attention_bwd_plain,
                                                        flash_attention_fwd_plain,
                                                        paired_train_bwd_plain,
                                                        paired_train_delta,
                                                        paired_train_fwd_plain)

    cs = _chip_smoke()
    _, lq, lk, ends = shape
    b, h = 2, 4
    g = torch.Generator(device=cuda).manual_seed(9)
    q, do = (torch.randn(b, lq, 64 * h, generator=g, device=cuda) for _ in range(2))
    k, v = (torch.randn(b, lk, 64 * h, generator=g, device=cuda) for _ in range(2))
    if ends is not None:
        q, k = cs.l2_heads(q, h) * 4.0, cs.l2_heads(k, h)
    else:
        q = q * 0.125
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    if row == 6:
        f0, b0 = paired_train_fwd.launches, paired_train_bwd.launches
        out, lse = paired_train_fwd(q, k, v, h, ends)
        grads = paired_train_bwd(q, k, v, out, lse, do, h, ends)
        want_out, want_lse = paired_train_fwd_plain(q, k, v, h, ends)
        want_grads = paired_train_bwd_plain(q, k, v, do, lse, paired_train_delta(out, do, h), h,
                                            ends)
        launches = (paired_train_fwd.launches - f0, paired_train_bwd.launches - b0)
    else:
        q4, k4, v4, do4 = (t.reshape(b, t.shape[1], h, 64) for t in (q, k, v, do))
        f0, b0 = flash_attention_fwd.launches, flash_attention_bwd.launches
        out, lse = flash_attention_fwd(q4, k4, v4, ends)
        grads = flash_attention_bwd(q4, k4, v4, out, lse, do4, ends)
        want_out, want_lse = flash_attention_fwd_plain(q4, k4, v4, ends)
        delta = paired_train_delta(out.reshape(b, lq, -1), do, h)
        want_grads = flash_attention_bwd_plain(q4, k4, v4, do4, lse, delta, ends)
        launches = (flash_attention_fwd.launches - f0, flash_attention_bwd.launches - b0)
    torch.cuda.synchronize()
    assert launches == (1, 1)
    errs = {}
    for name, got, want in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads),
                               (want_out, want_lse, *want_grads)):
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        if name == "lse":
            atol, rtol = cs.FLASH_F32_TOL
            ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
        else:
            scale = float(want.abs().max()) if name == "out" else max(float(want.abs().max()), 1.0)
            ok = err <= cs.FLASH_TRAIN_BF16_ULPS * cs.bf16_ulp(scale)
        errs[name] = err
        assert ok, (name, errs)  # NaN fails too
    print(json.dumps({"row": row, "shape": shape[0], "errors": errs}))


@pytest.mark.cuda
@pytest.mark.parametrize("row", [6, 5])
def test_cuda_training_attention_backward_is_deterministic(cuda, row):
    """Two bf16 backward calls on the same inputs give bit-identical dq, dk
    and dv (two passes, no atomics): row 6 at the d16 256px batch-32 shape,
    row 5 at the ragged L 1015 shape of chip_smoke.check_flash."""
    cs = _chip_smoke()
    if row == 6:
        q, k, v, do = cs.ptrain_inputs(cuda, torch.bfloat16, cs.TRAIN_BATCH, 6)
        ends = cs._scale_ends()
        out, lse = paired_train_fwd(q, k, v, cs.HEADS, ends)
        bwd = lambda: paired_train_bwd(q, k, v, out, lse, do, cs.HEADS, ends)  # noqa: E731
    else:
        name, b, lq, lk, ends, _ = cs.flash_shapes()[3]
        assert name == "ragged"
        q, k, v, do = cs.flash_inputs(cuda, torch.bfloat16, b, lq, lk, True, 7)
        out, lse = flash_attention_fwd(q, k, v, ends)
        bwd = lambda: flash_attention_bwd(q, k, v, out, lse, do, ends)  # noqa: E731
    first = bwd()
    second = bwd()
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert bool(torch.isfinite(a.float()).all()), name
        assert torch.equal(a, b_), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 160, 64, 64), (8, 320, 16, 16), (3, 7, 15, 15),
                                   (2, 5, 7, 5), (1, 4, 256, 256)])
def test_cuda_gn_channel_stats_matches_plain(cuda, dtype, shape):
    """Row 7's sums and sums of squares against the plain version on the
    same inputs, at even shapes and ragged ones (H * W no multiple of 16
    bytes, odd C), within 1e-5 + 1e-5 sum|x| (sum x^2); the autograd
    Function's gradient against autograd through the plain version within
    1e-5 + rtol |want| (rtol 1e-5, or one bf16 ulp)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    before = gn_channel_stats.launches
    xg = x.clone().requires_grad_()
    s, ss = gn_channel_stats(xg)
    torch.cuda.synchronize()
    assert gn_channel_stats.launches == before + 1
    xf = x.float()
    for got, want, scale in zip((s, ss), gn_channel_stats_plain(x),
                                (xf.abs().sum((2, 3)), (xf * xf).sum((2, 3)))):
        assert bool(((got.detach() - want).abs() <= 1e-5 + 1e-5 * scale).all())
    gs, gss = (torch.randn(shape[:2], generator=g, device=cuda) for _ in range(2))
    ((s * gs).sum() + (ss * gss).sum()).backward()
    xp = x.clone().requires_grad_()
    sp, ssp = gn_channel_stats_plain(xp)
    ((sp * gs).sum() + (ssp * gss).sum()).backward()
    assert xg.grad.dtype == dtype
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(xg.grad.float(), xp.grad.float(), rtol=rtol, atol=1e-5)


@pytest.mark.cuda
def test_cuda_gn_channel_stats_at_the_tokenizer_shapes(cuda):
    """chip_smoke.check_gn_stats: every GroupNorm input shape of the ch160
    tokenizer at batch 8 and the ragged shapes, fp32 and bf16, with the VJP."""
    before = gn_channel_stats.launches
    _chip_smoke().check_gn_stats(cuda)
    torch.cuda.synchronize()
    assert gn_channel_stats.launches > before


@pytest.mark.cuda
def test_cuda_gn_channel_stats_refuses_other_layouts(cuda):
    """No quiet copy: a non-contiguous, channels-last, non-4-D or float16
    tensor is refused, never made contiguous or sent to the plain version."""
    x = torch.randn(2, 8, 6, 6, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gn_channel_stats(x[:, :, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        gn_channel_stats(x.to(memory_format=torch.channels_last))
    with pytest.raises(ValueError, match="contiguous"):
        gn_channel_stats(x[0])
    with pytest.raises(TypeError):
        gn_channel_stats(x.half())


@pytest.mark.cuda
def test_cuda_tokenizer_training_step_equals_cpu(cuda):
    """One fp32 tokenizer-training forward and backward of a tiny VQVAE
    (ch 64, ch_mult (1, 2): 2 and 4 channels per group; 16x16 images) with
    gn_impl="pallas" on the card (row 7 once per GroupNorm) against the same
    step on the CPU, TF32 off: tokens equal, loss within 1e-5 relative,
    every gradient within 1e-4 of its tensor's max."""
    import copy

    from var_tpu_torch.config import VAEConfig
    from var_tpu_torch.device import fp32_exact
    from var_tpu_torch.models import build_vae_train
    from var_tpu_torch.models.vae import vae_train_forward

    cfg = VAEConfig(vocab_size=64, z_channels=8, ch=64, ch_mult=(1, 2), v_patch_nums=(1, 2, 4, 8))
    vae = build_vae_train(device="cpu", seed=3, cfg=cfg)
    img = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(5)) * 2 - 1
    n_gn = sum(isinstance(m, torch.nn.GroupNorm) for m in vae.modules())
    out = {}
    for dev in (torch.device("cpu"), cuda):
        v = copy.deepcopy(vae).to(dev)
        before = gn_channel_stats.launches
        with fp32_exact():
            res = vae_train_forward(v, img.to(dev), "pallas")
            loss = ((res.recon - img.to(dev)) ** 2).mean() + res.vq_loss
            loss.backward()
        torch.cuda.synchronize()
        out[dev.type] = (float(loss.detach()), [i.cpu() for i in res.idx_bl],
                         {n: p.grad.cpu() for n, p in v.named_parameters() if p.grad is not None},
                         gn_channel_stats.launches - before)
    assert out["cuda"][3] == n_gn and out["cpu"][3] == 0
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert torch.equal(a, b)
    assert out["cuda"][2].keys() == out["cpu"][2].keys()
    for n, want in out["cpu"][2].items():
        err = float((out["cuda"][2][n] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-12, n


@pytest.mark.cuda
def test_planted_fault_fails_the_gn_stats_check(cuda, tmp_path):
    """A copy of row 7's kernel without its scalar tail loop (only a ragged
    or unaligned row needs it), built in tmp_path, must fail
    chip_smoke.check_gn_stats."""
    _planted_copy(tmp_path, "gn_stats.cu", "i < hw; i += NT", "i < 0; i += NT", min_count=1)
    rc, last = _run_check(tmp_path, "check_gn_stats")
    print(json.dumps({"mutant": "gn_stats_drop_tail", "rc": rc, "error": last[:3000]}))
    assert rc != 0 and "gn_channel_stats differs from its plain version" in last


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_decode_at_mp2_equals_one_process(cuda, tmp_path):
    """Two ranks on the one card (gloo over CUDA tensors), heads split over
    ``model``: the greedy CFG decode through rows 1-4 at 2 heads a rank
    (C 256, 4 heads of 64) is token-equal to the same decode in one process
    on the card, chunked (row 2) and prealloc (row 4) alike."""
    from var_tpu_torch.apps import dryrun_multigpu as dry

    spec = dry.tiny_spec(2, "cuda", "gloo")
    spec.update(meshes=[[1, 2]], train=[], plant=False, cli=False,
                decode=dict(spec["decode"], cache_impls=["chunked", "prealloc"]))
    reports, _ = dry.launch(spec, 2, str(tmp_path), timeout=600, local_ranks=[0, 0]).wait()
    assert dry.failures(reports) == []
    for rep in reports:
        for impl, row in (("chunked", "flash_decode"), ("prealloc", "flash_decode_paired")):
            case = rep["meshes"]["1x2"][f"decode_{impl}"]
            print(json.dumps({"rank": rep["rank"], "impl": impl, **case}))
            assert case["tokens_differ"] == 0
            launches = case["launches"]
            assert launches[row] == 2 * 3 and launches["modulated_layernorm"] == 2 * 2 * 3
            assert launches["topk_topp_bound"] == 3


class _LinearState:
    """A training state for a compiled body: one Linear and its optimizer."""

    def __init__(self, dev, seed):
        from var_tpu_torch.engine.trainer import ClippedAdamW

        torch.manual_seed(seed)
        self.m = torch.nn.Linear(16, 16).to(dev)
        self.opt = ClippedAdamW(self.m, 1.0)

    def tensors(self):
        return [*self.m.parameters(), *self.opt.tensors()]


@pytest.mark.cuda
@pytest.mark.parametrize("planted", [False, True])
def test_cuda_training_body_captures_or_raises_at_a_host_read(cuda, planted):
    """``Compiled(train=True)`` on the card: a body that reads its loss back
    to the host runs once eagerly (the first call's warm-up), then its
    capture raises; the call raises and drops its entry, and nothing runs
    the body eagerly in the capture's place. Without the read, three calls
    (a capture, two replays) give the eager body's losses, parameters and
    moments bit for bit."""
    from var_tpu_torch.engine.compiled import Compiled

    calls = []

    def body(state, x):
        calls.append(1)
        state.opt.zero_grad()
        loss = state.m(x).square().mean()
        loss.backward()
        if planted and float(loss) > 1e30:  # the planted host read
            loss = loss * 2
        state.opt.step(1e-2, 0.1, skip_nonfinite=True)
        return loss.detach()

    prog = Compiled(body, 1, cuda, train=True)
    xs = [torch.randn(8, 16, device=cuda, generator=torch.Generator(cuda).manual_seed(i))
          for i in range(3)]
    if planted:
        stream = torch.cuda.current_stream(cuda)
        with pytest.raises(Exception):
            prog(_LinearState(cuda, 0), xs[0])
        assert prog.graphs == {} and len(calls) == 2  # the warm-up and the capture
        assert torch.cuda.current_stream(cuda) == stream  # the capture's is not left current
        return
    a, b = _LinearState(cuda, 0), _LinearState(cuda, 0)
    for x in xs:
        got, want = prog(a, x), prog.eager(b, x)
        assert torch.equal(got, want)
        for ta, tb in zip(a.tensors(), b.tensors()):
            assert torch.equal(ta, tb)
    (entry,) = prog.graphs.values()
    assert entry.graph is not None and len(calls) == 2 + 3  # warm-up, capture, 3 eager


@pytest.mark.cuda
def test_cuda_programs_sharing_a_pool_match_their_eager_bodies(cuda):
    """A training program and an inference program in one
    ``torch.cuda.MemPool``, as the training CLI's step and eval share one:
    called in turns (each first call runs eagerly in the pool, then
    captures), every call gives its eager body's outputs and state bit for
    bit, though each graph's replay writes over memory the other's freed."""
    from var_tpu_torch.engine.compiled import Compiled

    def train(state, x):
        state.opt.zero_grad()
        loss = state.m(x).square().mean()
        loss.backward()
        state.opt.step(1e-2, 0.1, skip_nonfinite=True)
        return loss.detach()

    def infer(m, x):
        return torch.relu(m(x)).sum(-1)

    pool = torch.cuda.MemPool()
    step = Compiled(train, 1, cuda, train=True, pool=pool)
    score = Compiled(infer, 1, cuda, pool=pool)
    a, b = _LinearState(cuda, 0), _LinearState(cuda, 0)
    gen = torch.Generator(cuda).manual_seed(3)
    for _ in range(3):
        x, y = (torch.randn(64, 16, device=cuda, generator=gen) for _ in range(2))
        assert torch.equal(step(a, x), step.eager(b, x))
        assert torch.equal(score(a.m, y), score.eager(b.m, y))
        for ta, tb in zip(a.tensors(), b.tensors()):
            assert torch.equal(ta, tb)
    assert len(step.graphs) == len(score.graphs) == 1
