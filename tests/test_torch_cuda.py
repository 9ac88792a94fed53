"""Each CUDA kernel of the port against its plain PyTorch version, on an
NVIDIA GPU. Every test here is marked ``cuda`` and skips without a card (a
CUDA kernel has no CPU mode). This file imports no JAX, so it runs on a GPU
machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from var_tpu_torch.ops.cuda.flash_attention import flash_decode, flash_decode_plain
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
