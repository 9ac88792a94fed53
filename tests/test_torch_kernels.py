"""The port's kernel modules vs the JAX functions they replace.

On the CPU each wrapper runs its plain PyTorch version (a CUDA kernel has no
CPU mode); the JAX side runs its Pallas kernels in interpret mode, as its
own tests do. Inputs come from numpy with fixed seeds. The CUDA kernels
themselves are held against these plain versions on the card by
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from var_tpu.ops.pallas.flash_attention import flash_decode_paired_chunks
from var_tpu.ops.pallas.fused_ln import modulated_layernorm as jax_modulated_layernorm
from var_tpu.ops.pallas.select import float_key as jax_float_key
from var_tpu.ops.pallas.select import topk_topp_bound as jax_topk_topp_bound
from var_tpu_torch.ops.cuda.flash_attention import flash_decode
from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm
from var_tpu_torch.ops.cuda.select import float_key, topk_topp_bound

torch.set_num_threads(2)


def _ln_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    b, _, c = shape
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    scale = (rng.standard_normal((b, c)) * 0.3).astype(np.float32)
    shift = (rng.standard_normal((b, c)) * 0.3).astype(np.float32)
    return x, scale, shift


@pytest.mark.parametrize("shape", [(3, 37, 128), (2, 9, 256)])
def test_modulated_layernorm_matches_jax(shape):
    x, scale, shift = _ln_inputs(shape, sum(shape))
    want = np.asarray(jax_modulated_layernorm(jnp.asarray(x), jnp.asarray(scale),
                                              jnp.asarray(shift), eps=1e-6))
    before = modulated_layernorm.launches
    got = modulated_layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(shift), eps=1e-6)
    assert modulated_layernorm.launches == before  # CPU tensors never launch
    # reduction order differs between the frameworks
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_modulated_layernorm_bf16_staging_matches_jax():
    """bf16 inputs: normalise and modulate in bf16 after fp32 statistics,
    as the JAX kernel does; one bf16 ulp of slack for rounding order."""
    x, scale, shift = _ln_inputs((2, 16, 128), 5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax_modulated_layernorm(xb, jnp.asarray(scale), jnp.asarray(shift),
                                              eps=1e-6).astype(jnp.float32))
    got = modulated_layernorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
                              torch.from_numpy(shift), eps=1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=2e-2)


def test_float_key_bit_exact():
    # normal floats only: XLA's CPU backend flushes subnormals to zero, which
    # the GPU and PyTorch do not
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * 10,
        np.array([0.0, -0.0, 1e-30, -1e-30, 1.2e-38, -1.2e-38, 3.0e38, -3.0e38, 1.0, -1.0],
                 np.float32)])
    want = np.asarray(jax_float_key(jnp.asarray(vals)))
    got = float_key(torch.from_numpy(vals)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[-9] == got[-10]  # -0.0 and +0.0 share a key


def _logits(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return (rng.standard_normal((3, 7, 1024)) * 4).astype(np.float32)
    # fp16-rounded coarse grid: real ties at the k-th value
    grid = np.round(rng.standard_normal((4, 512)) * 2.0) / 2.0
    return grid.astype(np.float16).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("k,p", [(10, 0.0), (50, 0.9), (0, 0.8), (900, 0.96), (100, 0.0)])
def test_topk_topp_bound_matches_jax(kind, k, p):
    """The (k, p) grid of test_select_kernel.py plus tie-heavy rows: the
    int32 bounds are equal, not just the candidate sets."""
    logits = _logits(kind, k + int(p * 10))
    k = min(k, logits.shape[-1])
    want = np.asarray(jax_topk_topp_bound(jnp.asarray(logits), k, p))
    before = topk_topp_bound.launches
    got = topk_topp_bound(torch.from_numpy(logits), k, p).numpy()
    assert topk_topp_bound.launches == before
    assert got.dtype == np.int32 and got.shape == logits.shape[:-1]
    np.testing.assert_array_equal(got, want)


PNS = (1, 2, 3, 4, 5, 6)


@pytest.mark.parametrize("h", [2, 4])
@pytest.mark.parametrize("si", [0, 3, 5])
@pytest.mark.parametrize("l2", [False, True])
def test_flash_decode_matches_jax_chunked_kernel(h, si, l2):
    """Port decode attention over the preallocated cache == the JAX chunked
    kernel over per-stage chunks of pyramid (1..6), q read from the fused
    qkv, with and without the in-kernel q L2 norm; fp32, head_dim 64."""
    c, b, depth, layer = 64 * h, 2, 3, 1
    rng = np.random.default_rng(100 * h + 10 * si + l2)
    lens = [pn * pn for pn in PNS]
    cum, l = sum(lens[:si]), lens[si]
    qkv = rng.standard_normal((b, l, 3 * c)).astype(np.float32)
    k_chunks = [rng.standard_normal((depth, b, n, c)).astype(np.float32) for n in lens[:si]]
    v_chunks = [rng.standard_normal((depth, b, n, c)).astype(np.float32) for n in lens[:si]]
    k_cur = rng.standard_normal((b, l, c)).astype(np.float32)
    v_cur = rng.standard_normal((b, l, c)).astype(np.float32)
    sm = np.exp(rng.standard_normal(h) * 0.3).astype(np.float32) if l2 else None
    scale = 1.0 if l2 else 0.21
    want = np.asarray(flash_decode_paired_chunks(
        jnp.asarray(qkv), [jnp.asarray(a) for a in k_chunks] + [jnp.asarray(k_cur)],
        [jnp.asarray(a) for a in v_chunks] + [jnp.asarray(v_cur)], layer, h, scale,
        q_l2_scale_mul=None if sm is None else jnp.asarray(sm)))

    kc = torch.zeros(depth, b, sum(lens), c)
    vc = torch.zeros(depth, b, sum(lens), c)
    off = 0
    for kk, vv in zip(k_chunks, v_chunks):
        kc[:, :, off:off + kk.shape[2]] = torch.from_numpy(kk)
        vc[:, :, off:off + vv.shape[2]] = torch.from_numpy(vv)
        off += kk.shape[2]
    kc[layer, :, cum:cum + l] = torch.from_numpy(k_cur)
    vc[layer, :, cum:cum + l] = torch.from_numpy(v_cur)
    got = flash_decode(torch.from_numpy(qkv), kc[layer], vc[layer], cum + l, h, scale,
                       q_l2_scale_mul=None if sm is None else torch.from_numpy(sm))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_block_causal_attention_matches_jax():
    """The dense attention's factored block-causal mask (``scale_ends``), the
    form the training slice will use, against the JAX function."""
    from var_tpu.ops.attention import attention as jax_attention
    from var_tpu_torch.ops.attention import attention

    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 14, 2, 16)).astype(np.float32) for _ in range(3))
    ends = (1, 5, 14)
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25,
                                    scale_ends=ends))
    got = attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 0.25,
                    scale_ends=ends)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_wrappers_refuse_other_devices():
    """No quiet path: a tensor that is neither on the CPU nor on a CUDA
    device is refused, never computed by the plain version."""
    x = torch.empty(2, 3, 64, device="meta")
    s = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError):
        modulated_layernorm(x, s, s)
    with pytest.raises(ValueError):
        topk_topp_bound(torch.empty(2, 64, device="meta"), 5, 0.5)
    with pytest.raises(ValueError):
        flash_decode(torch.empty(2, 3, 192, device="meta"), x, x, 3, 1)
