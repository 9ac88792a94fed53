"""The float32-accurate tensor-core convolution of the frozen encoder on the
CPU: the plain version (``ops/cuda/conv3xtf32.py``, the kernel's oracle)
against the modules' NCHW convolutions at every kind of launch the encoder
makes, the wrapper's own arithmetic around the kernel (the TF32 split of the
weights, conv_in's im2col), what it refuses, which encodes take the
channels-last path (``models/vae.py::channels_last_encode``) and that path's
tokens, run here through the plain versions. The kernel itself runs on the
card (``tests/test_torch_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from var_tpu_torch.config import VAEConfig
from var_tpu_torch.models import vae as tv
from var_tpu_torch.ops.cuda import conv3xtf32 as cx

torch.set_num_threads(2)

# the d16 tokenizer's channel widths (ch 160, mult 1 1 2 2 4) at 64 x 64
D16_64 = VAEConfig(v_patch_nums=(1, 2, 4))
TINY = VAEConfig(vocab_size=64, z_channels=32, ch=32, v_patch_nums=(1, 2, 4))


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _vae(cfg, seed=0):
    vae = tv.init_vae_params(tv.VQVAE(cfg), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in vae.modules():  # norms that do something
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
    return vae.eval().requires_grad_(False)


def _img(b, hw, seed=3):
    return torch.rand(b, hw, hw, 3, generator=torch.Generator().manual_seed(seed)) * 2 - 1


# (kind, Cin, Cout, k, stride, residual): every kind of launch of the encoder
LAUNCHES = [("3x3", 160, 160, 3, 1, False), ("downsample", 160, 160, 3, 2, False),
            ("1x1", 160, 320, 1, 1, False), ("conv_in", 3, 160, 3, 1, False),
            ("conv2_residual", 320, 320, 3, 1, True)]


@pytest.mark.parametrize("kind,cin,cout,k,stride,residual", LAUNCHES)
def test_plain_equals_the_nchw_conv2d(kind, cin, cout, k, stride, residual):
    """The plain version over channels-last x equals the module's NCHW
    convolution (``Downsample2x``: its (0, 1, 0, 1) pad then stride 2; a
    ResnetBlock's conv2: ``x + conv2(h)``) within float32 rounding, and
    comes out channels-last."""
    g = torch.Generator().manual_seed(cin + cout + k)
    conv = tv.Conv2d(cin, cout, k, stride=stride, padding=0 if stride == 2 else k // 2)
    tv.init_vae_params(conv, g)
    x = torch.randn(2, cin, 12, 12, generator=g)
    res = torch.randn(2, cout, 12 // stride, 12 // stride, generator=g) if residual else None
    with torch.no_grad():
        if stride == 2:
            ds = tv.Downsample2x(cin)
            ds.conv = conv
            want = tv.downsample2x(ds, x)
            pad = (0, 1, 0, 1)
        else:
            want = conv(x)
            pad = (k // 2,) * 4
        if res is not None:
            want = res + want
        got = cx.conv3xtf32_plain(_cl(x), conv.weight, conv.bias, stride, pad,
                                  None if res is None else _cl(res))
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_a_cpu_tensor_takes_the_plain_version():
    x = _cl(torch.randn(2, 32, 6, 6))
    w, b = torch.randn(32, 32, 3, 3), torch.randn(32)
    before = cx.conv3xtf32.launches
    got = cx.conv3xtf32(x, w, b)
    assert cx.conv3xtf32.launches == before
    assert torch.equal(got, cx.conv3xtf32_plain(x, w, b))


def test_the_weight_split_is_tf32_rounded_to_nearest_and_nearly_exact():
    """hi = tf32(w) and lo = tf32(w - hi), both with the low 13 bits clear
    (what the tensor cores read), hi the nearest TF32 value with ties away
    from zero, K-major (Cout, kh, kw, Cin), and hi + lo within 2^-21 of w."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 5, 3, 3, generator=g) * 10.0 ** torch.randint(-3, 3, (8, 5, 3, 3),
                                                                     generator=g)
    hi, lo = cx.split_weight(w)
    wk = w.permute(0, 2, 3, 1).reshape(8, -1)
    assert hi.shape == lo.shape == (8, 45)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    ulp = torch.ldexp(torch.ones_like(wk), torch.frexp(wk)[1] - 11)  # TF32's ulp at each |w|
    assert ((wk - hi).abs() <= ulp / 2).all()
    assert ((wk - hi - lo).abs() <= wk.abs() * 2.0 ** -21).all()
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    assert cx._tf32(ties).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("stride,pad", [(1, (1, 1, 1, 1)), (2, (0, 1, 0, 1))])
def test_conv_in_im2col_is_the_3x3_conv_as_a_1x1(stride, pad):
    """conv_in's 3 channels go to the kernel as a 32-channel im2col (the 27
    taps in (dy, dx, c) order, then zeros) and a 1x1 of the weights laid
    out the same way: that 1x1 equals the 3x3 convolution."""
    g = torch.Generator().manual_seed(stride)
    x, w, b = _cl(torch.randn(2, 3, 11, 11, generator=g)), torch.randn(16, 3, 3, 3), torch.randn(16)
    ho = (11 + pad[2] + pad[3] - 3) // stride + 1
    col = cx._im2col(x, 3, 3, stride, pad, ho, ho)
    assert col.shape == (2, 32, ho, ho) and col.is_contiguous(memory_format=torch.channels_last)
    assert not col[:, 27:].any()
    w1 = F.pad(w.permute(0, 2, 3, 1).reshape(16, 27), (0, 5)).reshape(16, 32, 1, 1)
    torch.testing.assert_close(F.conv2d(col, w1, b),
                               F.conv2d(F.pad(x, pad), w, b, stride), rtol=1e-5, atol=1e-5)


def _shape_case(case):
    x = _cl(torch.randn(2, 64, 8, 8))
    w, b, res, stride, pad = torch.randn(160, 64, 3, 3), torch.randn(160), None, 1, (1, 1, 1, 1)
    if case == "float64":
        x = x.double()
    elif case == "bf16_weight":
        w = w.bfloat16()
    elif case == "nchw":
        x = x.contiguous()
    elif case == "weight_channels":
        w = w[:, :32]
    elif case == "cout":
        w, b = w[:48], b[:48]
    elif case == "cin":
        x, w = _cl(torch.randn(2, 40, 8, 8)), torch.randn(160, 40, 3, 3)
    elif case == "stride":
        stride = 3
    elif case == "bias":
        b = b[:80]
    elif case == "residual_shape":
        res = _cl(torch.randn(2, 160, 4, 4))
    elif case == "residual_nchw":
        res = torch.randn(2, 160, 8, 8)
    elif case == "misaligned":
        x = torch.randn(2 * 8 * 8 * 64 + 1)[1:].view(2, 8, 8, 64).permute(0, 3, 1, 2)
    else:
        raise AssertionError(case)
    return x, w, b, stride, pad, res


@pytest.mark.parametrize("case", ["float64", "bf16_weight", "nchw", "weight_channels", "cout",
                                  "cin", "stride", "bias", "residual_shape", "residual_nchw",
                                  "misaligned"])
def test_launch_shape_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises((ValueError, TypeError)):
        cx.launch_shape(*_shape_case(case))


def test_launch_shape_takes_the_encoders_launches():
    x = _cl(torch.randn(2, 160, 16, 16))
    assert cx.launch_shape(x, torch.randn(320, 160, 3, 3), torch.randn(320), 2, (0, 1, 0, 1),
                           None) == (2, 160, 16, 16, 320, 3, 3, 8, 8, 160)
    assert cx.launch_shape(_cl(torch.randn(2, 3, 16, 16)), torch.randn(160, 3, 3, 3),
                           torch.randn(160), 1, (1, 1, 1, 1), None)[-1] == 160
    assert cx.launch_shape(_cl(torch.randn(2, 640, 4, 4)), torch.randn(32, 640, 3, 3),
                           torch.randn(32), 1, (1, 1, 1, 1), None)[-1] == 32


def test_the_wrapper_has_no_kernel_off_cuda():
    """No fallback: a tensor on neither the CPU nor CUDA is refused."""
    x = _cl(torch.randn(2, 32, 6, 6)).to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        cx.conv3xtf32(x, torch.randn(32, 32, 3, 3, device="meta"),
                      torch.randn(32, device="meta"))


@pytest.fixture
def cpu_as_cuda(monkeypatch):
    """Let the CPU take the channels-last path: its convolutions go to
    ``conv3xtf32_plain`` and its GroupNorms to ``gn_silu_plain``."""
    monkeypatch.setattr(tv, "_NHWC_DEVICES", ("cuda", "cpu"))


@pytest.fixture
def counted(monkeypatch):
    """``counted(fn)``: fn's result and the calls of ``conv3xtf32`` and
    ``gn_silu`` it made from ``models/vae.py``."""
    calls = {}

    def spy(name):
        real = getattr(tv, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(tv, name, call)

    spy("conv3xtf32")
    spy("gn_silu")

    def run(fn):
        calls.update(conv3xtf32=0, gn_silu=0)
        out = fn()
        return out, calls["conv3xtf32"], calls["gn_silu"]
    return run


def test_the_channels_last_encoder_gives_the_nchw_encoders_tokens(cpu_as_cuda, counted):
    """The d16 widths at 64 x 64: the channels-last encoder (39 convolution
    launches, 28 GroupNorms) gives the NCHW encoder's features within
    float32 rounding and its tokens, every one."""
    vae, img = _vae(D16_64), _img(2, 64)
    with torch.no_grad():
        (f, convs, norms) = counted(lambda: tv.img_to_f(vae, img))
        tv._NHWC_DEVICES = ("cuda",)
        want = tv.img_to_f(vae, img)
        want_idx = tv.img_to_idxBl(vae, img)
        tv._NHWC_DEVICES = ("cuda", "cpu")
        got_idx = tv.img_to_idxBl(vae, img)
    assert (convs, norms) == (39, 28)
    assert f.shape == want.shape == (2, 4, 4, 32) and f.is_contiguous()
    torch.testing.assert_close(f, want, rtol=1e-4, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got_idx, want_idx))


@pytest.mark.parametrize("dtype,impl,grad,path", [
    (torch.float32, "dot", False, "nhwc"),
    (torch.float32, "xla", False, "nhwc"),
    (torch.bfloat16, "dot", False, "nchw"),
    (torch.float32, "pallas", False, "nchw"),
    (torch.float32, "dot", True, "nchw"),
])
def test_which_encodes_run_channels_last(cpu_as_cuda, counted, dtype, impl, grad, path):
    """A float32 encode without gradients and with GroupNorm "dot" or "xla"
    runs channels-last, its convolutions through conv3xtf32; a bf16 encode
    (``vae_bf16``), ``gn_impl="pallas"`` and an encode under autograd with
    trainable parameters (tokenizer training) run the NCHW encoder."""
    vae = _vae(TINY).requires_grad_(grad)
    img = _img(2, 64).to(dtype)
    with torch.set_grad_enabled(grad):
        assert tv.channels_last_encode(vae, img, impl) == (path == "nhwc")
        if impl != "pallas":  # row 7's statistics need a card
            f, convs, _ = counted(lambda: tv.img_to_f(vae, img, impl))
            assert f.shape == (2, 4, 4, TINY.z_channels) and f.dtype == dtype
            assert convs == (39 if path == "nhwc" else 0)


def test_the_cpu_never_takes_the_kernel(counted):
    """Without the CPU let in, a float32 encode stays NCHW."""
    vae, img = _vae(TINY), _img(2, 64)
    assert not tv.channels_last_encode(vae, img, "dot")
    with torch.no_grad():
        _, convs, _ = counted(lambda: tv.img_to_f(vae, img))
    assert convs == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_decode_takes_the_kernel(cpu_as_cuda, counted, dtype):
    """A decode, float32 (NCHW) or bf16 (the channels-last render), calls
    no conv3xtf32: the decoder and the quantizer's phi convolutions keep
    their own."""
    vae = _vae(TINY)
    f_hat = torch.randn(2, 4, 4, TINY.z_channels, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        img, convs, norms = counted(lambda: tv.fhat_to_img(vae, f_hat.to(dtype)))
    assert img.shape == (2, 64, 64, 3) and convs == 0
    assert norms == (39 if dtype == torch.bfloat16 else 0)


def test_widths_the_kernel_does_not_take_keep_the_nchw_encoder(cpu_as_cuda, counted):
    """An 8-channel latent (conv_out and quant_conv 8 wide, as the tests'
    and the multi-GPU dry run's tokenizers have) keeps the NCHW encoder
    rather than raise."""
    vae = _vae(VAEConfig(vocab_size=64, z_channels=8, ch=32, v_patch_nums=(1, 2, 4)))
    img = _img(2, 64)
    assert not tv.channels_last_encode(vae, img, "dot")
    with torch.no_grad():
        f, convs, _ = counted(lambda: tv.img_to_f(vae, img))
    assert f.shape == (2, 4, 4, 8) and convs == 0


def test_a_trainable_input_keeps_the_nchw_encoder(cpu_as_cuda):
    vae = _vae(TINY)
    img = _img(2, 64).requires_grad_(True)
    assert not tv.channels_last_encode(vae, img, "dot")
    with torch.no_grad():
        assert tv.channels_last_encode(vae, img, "dot")
