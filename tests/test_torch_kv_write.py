"""The decode's cache write on the CPU: the plain version of
``ops/cuda/kv_write.py`` (the CPU path and the kernel's oracle) against the
seven PyTorch steps ``models/var.py::attn_apply`` took before it, bit for
bit; the rows it leaves alone; what the wrapper refuses; the launch's
covering of every 16-byte vector; the plain writes a decode makes; and a decode
through ``make_sampler`` against one that writes its cache through those
seven steps. The kernel itself runs on the card
(``tests/test_torch_cuda.py``)."""

import math

import pytest
import torch

from var_tpu_torch.apps import dryrun_multigpu as dry
from var_tpu_torch.config import VARConfig
from var_tpu_torch.engine import sampler as tsm
from var_tpu_torch.models import var as var_mod
from var_tpu_torch.ops.cuda import kv_write as kw

torch.set_num_threads(2)

CPU = torch.device("cpu")
D = 64


def seven_steps(k, v, k_dst, v_dst, heads, l2_norm):
    """The cache write as ``attn_apply`` took it before the kernel: cast,
    square, sum, epsilon, rsqrt, a broadcasting product into the cache view,
    and the V copy."""
    b, l, c = k.shape
    if l2_norm:
        kf = k.float().reshape(b, l, heads, c // heads)
        inv = torch.rsqrt((kf * kf).sum(-1, keepdim=True) + 1e-24)
        torch.mul(kf, inv, out=k_dst.view(b, l, heads, c // heads))
    else:
        k_dst.copy_(k)
    v_dst[...] = v


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _stage(heads, dtype, b=2, l=5, lmax=12, cum=3, seed=0):
    """(qkv, k cache, v cache, cum): a (b, l, 3C) fused qkv at trained-like
    scales and (2, b, lmax, C) NaN-filled caches, layer 1 to be written at
    rows [cum, cum + l)."""
    c = heads * D
    g = torch.Generator().manual_seed(seed)
    qkv = (torch.randn(b, l, 3 * c, generator=g) * 2 + 0.3).to(dtype)
    kc = torch.full((2, b, lmax, c), float("nan"), dtype=dtype)
    return qkv, kc, kc.clone(), cum


def _views(qkv, kc, vc, cum, layer=1):
    c = qkv.shape[-1] // 3
    l = qkv.shape[1]
    return (qkv[..., c:2 * c], qkv[..., 2 * c:], kc[layer, :, cum:cum + l],
            vc[layer, :, cum:cum + l])


@pytest.mark.parametrize("heads", [16, 30, 36, 15])
@pytest.mark.parametrize("l2_norm", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_equals_the_seven_steps_bit_for_bit(dtype, l2_norm, heads):
    """The plain version writes the caches the seven steps write, bit for
    bit, at the d16, d30 and d36 head counts and an odd local count, at a
    nonzero ``cum``; every other row stays NaN."""
    qkv, kc, vc, cum = _stage(heads, dtype, seed=heads)
    want_k, want_v = kc.clone(), vc.clone()
    kw.kv_write_plain(*_views(qkv, kc, vc, cum), heads, l2_norm)
    seven_steps(*_views(qkv, want_k, want_v, cum), heads, l2_norm)
    assert torch.equal(_bits(kc), _bits(want_k)) and torch.equal(_bits(vc), _bits(want_v))
    rows = torch.zeros(kc.shape[:3], dtype=torch.bool)
    rows[1, :, cum:cum + qkv.shape[1]] = True
    for cache in (kc, vc):
        assert bool(cache[~rows].isnan().all()) and bool(cache[rows].isfinite().all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_normed_heads_have_unit_norm(dtype):
    """Each written head of K has an L2 norm of 1 within its dtype's
    rounding; V is copied as it is."""
    qkv, kc, vc, cum = _stage(36, dtype)
    kw.kv_write_plain(*_views(qkv, kc, vc, cum), 36, True)
    k_dst, v_dst = _views(qkv, kc, vc, cum)[2:]
    norms = k_dst.float().reshape(*k_dst.shape[:2], 36, D).norm(dim=-1)
    eps = torch.finfo(dtype).eps
    torch.testing.assert_close(norms, torch.ones_like(norms), rtol=0, atol=8 * eps)
    assert torch.equal(_bits(v_dst), _bits(qkv[..., 2 * 36 * D:]))


def test_a_cpu_tensor_takes_the_plain_version():
    qkv, kc, vc, cum = _stage(16, torch.bfloat16)
    want_k, want_v = kc.clone(), vc.clone()
    before = kw.kv_write.launches
    kw.kv_write(*_views(qkv, kc, vc, cum), 16, True)
    assert kw.kv_write.launches == before
    kw.kv_write_plain(*_views(qkv, want_k, want_v, cum), 16, True)
    assert torch.equal(_bits(kc), _bits(want_k)) and torch.equal(_bits(vc), _bits(want_v))


def _shape_case(name):
    """(k, v, k_dst, v_dst, heads) of a case the kernel does not take."""
    qkv, kc, vc, cum = _stage(16, torch.bfloat16)
    k, v, kd, vd = _views(qkv, kc, vc, cum)
    if name == "float64":
        return tuple(t.double() for t in (k, v, kd, vd)) + (16,)
    if name == "head_not_whole_vectors":  # D 60 in bf16: 7.5 vectors
        return k[..., :960], v[..., :960], kd[..., :960], vd[..., :960], 16
    if name == "too_wide_heads":  # one head of 1024 + 32 bf16: 132 vectors
        wide = torch.zeros(2, 5, 1056 * 3, dtype=torch.bfloat16)
        dst = torch.zeros(2, 5, 1056, dtype=torch.bfloat16)
        return wide[..., :1056], wide[..., 1056:2112], dst, dst.clone(), 1
    if name == "misaligned":  # K starting 4 bf16 (8 bytes) into a vector
        return qkv[..., 1028:2052], v, kd, vd, 16
    if name == "strides_differ":
        return k, v.contiguous(), kd, vd, 16
    if name == "channels_strided":  # every other channel of a wider buffer
        big = torch.zeros(2, 5, 2048, dtype=torch.bfloat16)
        return big[..., ::2], big[..., 1::2], kd, vd, 16
    raise AssertionError(name)


@pytest.mark.parametrize("case", ["float64", "head_not_whole_vectors", "too_wide_heads",
                                  "misaligned", "strides_differ", "channels_strided"])
def test_launch_shape_refuses_what_the_kernel_does_not_take(case):
    k, v, kd, vd, heads = _shape_case(case)
    with pytest.raises((ValueError, TypeError)):
        kw.launch_shape(k, v, kd, vd, heads)


@pytest.mark.parametrize("case", ["shapes", "heads", "dtypes"])
def test_the_wrapper_refuses_mismatched_tensors_on_any_device(case):
    qkv, kc, vc, cum = _stage(16, torch.bfloat16)
    k, v, kd, vd = _views(qkv, kc, vc, cum)
    heads = 16
    if case == "shapes":
        v = v[:, :4]
    elif case == "heads":
        heads = 12
    else:
        vd = vd.float()
    with pytest.raises(ValueError):
        kw.kv_write(k, v, kd, vd, heads, True)


def test_the_wrapper_has_no_kernel_off_cuda():
    qkv, kc, vc, cum = _stage(16, torch.bfloat16)
    meta = tuple(t.to("meta") for t in _views(qkv, kc, vc, cum))
    with pytest.raises(ValueError, match="no kernel"):
        kw.kv_write(*meta, 16, True)


@pytest.mark.parametrize("dtype,d,heads,lg_lanes", [
    (torch.bfloat16, 64, 36, 3), (torch.float16, 64, 15, 3), (torch.float32, 64, 16, 4),
    (torch.bfloat16, 48, 3, 2), (torch.float32, 512, 1, 5), (torch.bfloat16, 1024, 2, 5)])
def test_the_launch_covers_every_vector_once(dtype, d, heads, lg_lanes):
    """The kernel's thread-to-vector arithmetic, run here in Python over
    ``launch_shape``'s arguments: every 16-byte vector of every (row, head)
    of K belongs to exactly one lane, that lane's group is the head's and
    lies in one warp, and a lane holds at most ``_MAX_PER`` vectors."""
    b, l = 2, 3
    k = torch.zeros(b, l, 3 * heads * d, dtype=dtype)[..., heads * d:2 * heads * d]
    dst = torch.zeros(b, l, heads * d, dtype=dtype)
    a = kw.launch_shape(k, k, dst, dst, heads)
    assert a["lg_lanes"] == lg_lanes
    vec = 16 // k.element_size()
    lanes, nvec = 1 << a["lg_lanes"], d // vec
    per = -(-nvec // lanes)
    assert per <= kw._MAX_PER and 32 % lanes == 0
    pairs = a["rows"] * heads
    seen = {}
    for gt in range(-(-pairs * lanes // 256) * 256):
        pair, sub = gt >> a["lg_lanes"], gt & (lanes - 1)
        if pair >= pairs:
            continue
        row, h = divmod(pair, heads)
        for i in range(per):
            j = sub + i * lanes
            if j < nvec:
                key = (row, h, j)
                assert key not in seen and gt // 32 == (pair * lanes) // 32
                seen[key] = gt
    assert len(seen) == a["rows"] * heads * nvec


def _attn(heads, l2_norm, seed=0):
    cfg = VARConfig(depth=2, embed_dim=heads * D, num_heads=heads, attn_l2_norm=l2_norm)
    attn = var_mod.SelfAttention(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.5 / math.sqrt(p.shape[-1])))
    ctx = var_mod.BlockContext(None, None, torch.cat([attn.q_bias, torch.zeros_like(
        attn.q_bias), attn.v_bias]), torch.full((heads,), 4.0) if l2_norm else None)
    return cfg, attn, ctx


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("l2_norm", [True, False])
@pytest.mark.parametrize("heads", [16, 15])
def test_attn_apply_writes_what_the_seven_steps_write(monkeypatch, heads, l2_norm, paired):
    """``attn_apply`` at a nonzero ``cum`` over a paired and a chunked cache:
    its cache and its output equal those of the same call whose cache write
    is the seven steps, bit for bit; rows outside the stage stay NaN."""
    cfg, attn, ctx = _attn(heads, l2_norm, seed=heads)
    x = torch.randn(2, 4, cfg.embed_dim, generator=torch.Generator().manual_seed(1))
    out = {}
    for name in ("kernel's", "seven"):
        if name == "seven":
            monkeypatch.setattr(var_mod, "kv_write", seven_steps)
        cache = var_mod.init_prealloc_caches(cfg, 2, torch.float32, CPU, lmax=9, paired=paired)
        cache.k.fill_(float("nan"))
        cache.v.fill_(float("nan"))
        cache.k[1, :, :5] = cache.v[1, :, :5] = 0.1  # earlier stages
        cache.cum = 5
        with torch.no_grad():
            y = var_mod.attn_apply(attn, cfg, x, ctx, cache, 1)
        out[name] = (y, cache.k, cache.v)
    for got, want in zip(out["kernel's"], out["seven"]):
        assert torch.equal(_bits(got), _bits(want))
    assert bool(out["seven"][1][0].isnan().all()) and bool(out["seven"][2][0].isnan().all())


@pytest.fixture(scope="module")
def models():
    return dry.build_models(dry.tiny_spec(1, "cpu", "gloo"), CPU)  # depth 2, pn 1_2_3


@pytest.mark.parametrize("cache_impl", ["chunked", "prealloc"])
def test_a_decode_counts_depth_times_stages_plain_writes(models, cache_impl, monkeypatch):
    """On the CPU a decode writes each block's K and V once a stage through
    the plain version, and launches no kernel."""
    vae, var = models
    writes, real = [], kw.kv_write_plain
    monkeypatch.setattr(kw, "kv_write_plain", lambda *a: writes.append(a) or real(*a))
    launches = kw.kv_write.launches
    with torch.inference_mode():
        tsm.decode_cfg(var.eval(), vae, torch.tensor([1, 7]), torch.Generator().manual_seed(0),
                       top_k=4, dtype=torch.float32, cache_impl=cache_impl)
    assert (len(writes), kw.kv_write.launches - launches) == (
        var.cfg.depth * len(var.cfg.patch_nums), 0)


def test_make_sampler_tokens_equal_a_seven_step_decode(models, monkeypatch):
    """From one seed, a CPU decode through ``make_sampler`` gives the tokens
    and f_hat of the same decode whose cache writes are the seven steps."""
    vae, var = models
    out = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(var_mod, "kv_write", seven_steps)
        sampler = tsm.make_sampler(var.cfg, vae.cfg, cfg_scale=1.5, top_k=4, top_p=0.9,
                                   dtype=torch.float32, device="cpu")
        res = sampler(var.eval(), vae, torch.Generator().manual_seed(3), [1, 7])
        out.append((res.tokens.clone(), res.f_hat.clone()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
