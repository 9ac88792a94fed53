"""The channels-last GroupNorm-SiLU of the VQVAE decoder on the CPU: the
plain version (``ops/cuda/gn_silu.py``, the kernel's oracle) against
``F.group_norm`` and ``F.silu``, the launch tiling, which decodes take the
channels-last path (``models/vae.py::channels_last_decode``) and the calls
that show it, and that path's layout plumbing run here through the plain
version. The kernel itself runs on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from var_tpu_torch.config import VAEConfig
from var_tpu_torch.models import vae as tv
from var_tpu_torch.ops.cuda import gn_silu as gs

torch.set_num_threads(2)

TINY = VAEConfig(vocab_size=64, z_channels=8, ch=32, v_patch_nums=(1, 2, 4))


def _norm_params(c, seed):
    g = torch.Generator().manual_seed(seed)
    return 1 + 0.3 * torch.randn(c, generator=g), 0.3 * torch.randn(c, generator=g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu,with_bias_in", [(True, False), (True, True), (False, False)])
@pytest.mark.parametrize("c", [160, 320, 640])
def test_gn_silu_plain_equals_group_norm_then_silu(c, silu, with_bias_in, dtype):
    """The three widths of the decoder and of the encoder (5, 10 and 20
    channels a group), channels-last input in float32 (the encoder's
    instantiation) and bf16 (the decoder's): the plain version's folded
    scale and shift equal ``F.group_norm`` (then ``F.silu``) of ``x +
    bias_in`` in float32 within float32 rounding, then one rounding to x's
    dtype, and the output is channels-last in that dtype."""
    g = torch.Generator().manual_seed(c)
    x = (torch.randn(2, c, 8, 8, generator=g) * 2 + 0.5).to(dtype,
                                                             memory_format=torch.channels_last)
    w, b = _norm_params(c, c + 1)
    bias_in = torch.randn(c, generator=g) if with_bias_in else None
    xf = x.float()
    want = F.group_norm(xf if bias_in is None else xf + bias_in[:, None, None], 32, w, b, 1e-6)
    if silu:
        want = F.silu(want)
    got = gs.gn_silu_plain(x, w, b, 32, 1e-6, silu, bias_in)
    assert got.is_contiguous(memory_format=torch.channels_last) and got.dtype == dtype
    rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=1e-5)


def test_gn_silu_takes_the_plain_version_for_a_cpu_tensor():
    x = torch.randn(2, 64, 4, 4).bfloat16().to(memory_format=torch.channels_last)
    w, b = _norm_params(64, 3)
    before = gs.gn_silu.launches
    got = gs.gn_silu(x, w, b, 32, 1e-6)
    assert gs.gn_silu.launches == before
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, gs.gn_silu_plain(x, w, b, 32, 1e-6))


@pytest.mark.parametrize("b", [1, 8, 50])
@pytest.mark.parametrize("hw,c", [(16 * 16, 640), (32 * 32, 640), (32 * 32, 320),
                                  (64 * 64, 320), (128 * 128, 320), (128 * 128, 160),
                                  (256 * 256, 160)])
def test_tiling_covers_the_image_and_fills_the_card(b, hw, c):
    """At every GroupNorm shape of the ch160 decoder and batches 1, 8, 50 on
    132 SMs: the tiles cover the image with no empty tile, hold a whole
    number of the block's rows and, unless they are one row, at most
    ``_TILE_ELEMS`` elements and enough of them for four blocks on every
    SM."""
    sms = 132
    rows = max(1, gs._THREADS // (c // gs._VEC))
    tile, tiles = gs.tiling(b, hw, c, sms)
    assert tile % rows == 0
    assert (tiles - 1) * tile < hw <= tiles * tile
    if tile > rows:
        assert tile * c <= gs._TILE_ELEMS
        assert b * tiles >= gs._BLOCKS_PER_SM * sms


def _tiny_vae(seed=0):
    vae = tv.init_vae_params(tv.VQVAE(TINY), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in vae.modules():  # norms that do something
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
    return vae.eval().requires_grad_(False)


def _f_hat(dtype=torch.float32, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, 4, 4, TINY.z_channels, generator=g).to(dtype)


@pytest.fixture
def counted(monkeypatch):
    """``counted(fn)``: fn's result, and the GroupNorms it ran channels-last
    (calls of ``gn_silu`` from ``models/vae.py``) and NCHW (calls of
    ``models/vae.py::group_norm``)."""
    calls = {}

    def spy(name):
        real = getattr(tv, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(tv, name, call)

    spy("gn_silu")
    spy("group_norm")

    def run(fn):
        calls.update(gn_silu=0, group_norm=0)
        out = fn()
        return out, calls["gn_silu"], calls["group_norm"]
    return run


@pytest.fixture
def cpu_as_cuda(monkeypatch):
    """Let the CPU take the channels-last path: its GroupNorms go to
    ``gn_silu_plain``, so everything but the card's kernel runs here."""
    monkeypatch.setattr(tv, "_NHWC_DEVICES", ("cuda", "cpu"))


def test_the_decoder_has_39_group_norms():
    assert sum(isinstance(m, torch.nn.GroupNorm) for m in _tiny_vae().decoder.modules()) == 39


@pytest.mark.parametrize("dtype,impl,grad,path", [
    (torch.bfloat16, "dot", False, "nhwc"),
    (torch.bfloat16, "xla", False, "nhwc"),
    (torch.float32, "dot", False, "plain"),
    (torch.float32, "xla", False, "plain"),
    (torch.bfloat16, "pallas", False, "plain"),
    (torch.bfloat16, "dot", True, "plain"),
])
def test_which_decodes_run_channels_last(cpu_as_cuda, counted, dtype, impl, grad, path):
    """bf16 decodes without gradients under "dot" or "xla" run their 39
    GroupNorms through ``gn_silu``; float32, ``gn_impl="pallas"`` and a
    decode under autograd (trainable decoder) run them through
    ``group_norm`` and none through ``gn_silu``."""
    vae = _tiny_vae()
    if grad:
        vae.requires_grad_(True)
    with torch.set_grad_enabled(grad):
        img, nhwc, plain = counted(lambda: tv.fhat_to_img(vae, _f_hat(dtype), impl))
    assert img.shape == (2, 64, 64, 3) and img.dtype == dtype
    assert (nhwc, plain) == ((39, 0) if path == "nhwc" else (0, 39))


def test_the_cpu_decodes_plain_without_the_patch(counted):
    """On the CPU itself no decode runs channels-last: no kernel there."""
    with torch.inference_mode():
        _, nhwc, plain = counted(lambda: tv.fhat_to_img(_tiny_vae(), _f_hat(torch.bfloat16)))
    assert (nhwc, plain) == (0, 39)


def test_vae_training_forward_decodes_plain(cpu_as_cuda, counted):
    """The tokenizer-training forward runs under autograd, in bf16 too:
    the encoder's and the decoder's GroupNorms all take the plain path."""
    vae = _tiny_vae().requires_grad_(True).to(torch.bfloat16)
    img = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    n_gn = sum(isinstance(m, torch.nn.GroupNorm) for m in vae.modules())
    out, nhwc, plain = counted(lambda: tv.vae_train_forward(vae, img.bfloat16()))
    out.recon.float().sum().backward()
    assert (nhwc, plain) == (0, n_gn)


def test_channels_last_decode_matches_the_nchw_chain(cpu_as_cuda, monkeypatch):
    """The channels-last bf16 decode (channels-last weights, NHWC
    attention and upsample, ``gn_silu_plain``) against today's NCHW chain in
    bf16, both against the float32 decode: no less precise (the new path
    rounds once where the chain rounds after the norm and the SiLU), and
    within a few bf16 steps of the chain. Its memory is channels-last
    from the first convolution to the image."""
    vae = _tiny_vae()
    with torch.inference_mode():
        ref = tv.fhat_to_img(vae, _f_hat())
        new = tv.fhat_to_img(vae, _f_hat(torch.bfloat16))
        monkeypatch.setattr(tv, "_NHWC_DEVICES", ())
        old = tv.fhat_to_img(vae, _f_hat(torch.bfloat16))
    assert new.is_contiguous()  # the NHWC image, no transposed copy
    err_new = (new.float() - ref).abs()
    err_old = (old.float() - ref).abs()
    assert float(err_new.mean()) <= 1.25 * float(err_old.mean())
    assert float(err_new.max()) <= 1.25 * float(err_old.max())
    assert float((new.float() - old.float()).abs().max()) <= 4 * float(err_old.max())
