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
from var_tpu_torch.ops.cuda.flash_attention import (flash_attention_paired_train, flash_decode,
                                                    flash_decode_plain, paired_train_bwd,
                                                    paired_train_fwd)

ROOT = Path(__file__).resolve().parent.parent
from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm, modulated_layernorm_plain
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


# planted faults: textual mutations of the training-attention source
MUTANTS = {
    "skip_last_k_tile": ("k0 < kend;", "k0 + PT_T < kend;"),  # forward and dQ loops
    "drop_delta": ("- dlt)", ")"),  # ds = p * dp in every backward kernel
}


@pytest.mark.cuda
@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_planted_fault_fails_the_training_attention_check(cuda, tmp_path, mutant):
    """A copy of the package whose training-attention kernels carry a
    planted fault, built in tmp_path, must fail chip_smoke.check_ptrain at
    the d16 batch-32 shapes. Prints the check's error line."""
    old, new = MUTANTS[mutant]
    shutil.copytree(ROOT / "var_tpu_torch", tmp_path / "var_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = tmp_path / "var_tpu_torch" / "ops" / "cuda" / "csrc" / "flash_attention_train.cu"
    text = src.read_text()
    assert text.count(old) >= 2
    src.write_text(text.replace(old, new))
    code = (f"import sys; sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]; "
            "import torch, chip_smoke, var_tpu_torch; "
            f"assert var_tpu_torch.__file__.startswith({str(tmp_path)!r}); "
            "chip_smoke.check_ptrain(torch.device('cuda', 0))")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900)
    last = (run.stderr.strip().splitlines() or [""])[-1]
    print(json.dumps({"mutant": mutant, "rc": run.returncode, "error": last[:3000]}))
    assert run.returncode != 0 and "differs from its plain version" in last
