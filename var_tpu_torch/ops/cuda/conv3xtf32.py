"""Float32 convolution on the tensor cores through three TF32 products a term
(``csrc/conv3xtf32.cu``): every convolution of the frozen VQVAE encoder and
its ``quant_conv`` in float32 inference, over channels-last activations.

Replaces no JAX kernel (the JAX package leaves convolutions to XLA, which
computes float32 products at HIGHEST precision in several bf16 passes) and
has no row in the kernel table. PyTorch's float32 convolution with TF32
off runs cuDNN's SIMT or FFT plans, which leave the tensor cores idle; a
one-pass TF32 convolution keeps about three decimal digits and flips the
tokenizer's nearest-code choices. The kernel splits each float32 operand
into a TF32 hi part and a TF32 lo remainder and sums lo hi + hi lo + hi hi
in float32: float32's accuracy at the tensor cores' rate over three.

The wrapper splits the weights (once a call: they are the module's own,
frozen or not) and lays them out K-major, (Cout, kh, kw, Cin); a
convolution over fewer than 32 input channels whose taps hold at most 32
values (the encoder's ``conv_in``, 3 channels) takes an im2col copy of 32
channels (the 27 taps and zeros, which add no terms) and runs as a 1x1.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from var_tpu_torch.ops.cuda import build

_BK = 32  # input channels a k-block of the kernel
_BNS = (160, 32)  # output channels a tile, the first that divides Cout


def conv3xtf32_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     stride: int = 1, pad: Sequence[int] = (1, 1, 1, 1),
                     residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version; the CPU path and the kernel's oracle: x (B,
    Cin, H, W) zero-padded by ``pad`` (left, right, top, bottom, as
    ``F.pad``), convolved in float32 with ``weight`` (Cout, Cin, kh, kw) at
    ``stride``, ``bias`` added, then ``residual + y``; channels-last."""
    y = F.conv2d(F.pad(x.float(), tuple(pad)), weight.float(), bias.float(), stride)
    if residual is not None:
        y = residual + y
    return y.contiguous(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero: ``cvt.rna.tf32.f32``, the kernel's rounding of the activations."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_weight(weight: torch.Tensor) -> tuple:
    """(hi, lo): ``weight`` (Cout, Cin, kh, kw) as (Cout, kh * kw * Cin),
    K-major, and its exact split into TF32 hi = tf32(w) and lo = tf32(w -
    hi)."""
    w = weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)
    hi = _tf32(w)
    return hi, _tf32(w - hi)


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int, pad: Sequence[int], ho: int,
            wo: int) -> torch.Tensor:
    """Channels-last (B, 32, Ho, Wo): each output pixel's kh x kw taps of x's
    channels in (dy, dx, c) order, then zeros."""
    xh = F.pad(x.permute(0, 2, 3, 1), (0, 0, *pad))  # (B, H + pt + pb, W + pl + pr, C)
    taps = [xh[:, dy:dy + (ho - 1) * stride + 1:stride, dx:dx + (wo - 1) * stride + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    zeros = xh.new_zeros(()).expand(x.shape[0], ho, wo, _BK - kh * kw * x.shape[1])
    return torch.cat(taps + [zeros], dim=-1).permute(0, 3, 1, 2)


def takes(cin: int, cout: int, kh: int, kw: int) -> bool:
    """Whether the kernel takes a convolution of these widths: Cout a
    multiple of 32; Cin a multiple of 32, or at most 32 values in a pixel's
    taps (the im2col of :func:`conv3xtf32`)."""
    return cout % _BNS[-1] == 0 and (cin % _BK == 0 or kh * kw * cin <= _BK)


def launch_shape(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int,
                 pad: Sequence[int], residual: Optional[torch.Tensor]) -> tuple:
    """(B, Cin, H, W, Cout, kh, kw, Ho, Wo, BN) of a launch over these
    tensors, on any device, or a TypeError or ValueError for what the kernel
    does not take: float32 alone; x and the residual channels-last; the
    weight's input channels x's; Cout a multiple of 32; Cin a multiple of 32
    or its taps at most 32 values (the im2col of :func:`conv3xtf32`); stride
    1 or 2; every tensor 16-byte aligned."""
    tensors = [x, weight, bias] + ([] if residual is None else [residual])
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"conv3xtf32 takes float32, got {t.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv3xtf32: x must be a channels-last (B, C, H, W) tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    b, cin, h, w = x.shape
    if weight.dim() != 4 or weight.shape[1] != cin:
        raise ValueError(f"conv3xtf32: weight {tuple(weight.shape)} for {cin} input channels")
    cout, _, kh, kw = weight.shape
    pl, pr, pt, pb = (int(p) for p in pad)
    if stride not in (1, 2) or min(pl, pr, pt, pb) < 0:
        raise ValueError(f"conv3xtf32: stride {stride} (want 1 or 2), pad {tuple(pad)}")
    ho, wo = (h + pt + pb - kh) // stride + 1, (w + pl + pr - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"conv3xtf32: no output for a {h} x {w} input, {kh} x {kw} taps")
    if not takes(cin, cout, kh, kw):
        raise ValueError(f"conv3xtf32: Cout {cout} (want a multiple of {_BNS[-1]}), {cin} "
                         f"input channels (want a multiple of {_BK}, or at most {_BK} values "
                         "a pixel's taps)")
    bn = next(n for n in _BNS if cout % n == 0)
    if tuple(bias.shape) != (cout,) or not bias.is_contiguous():
        raise ValueError(f"conv3xtf32: bias must be a contiguous ({cout},), got "
                         f"{tuple(bias.shape)}")
    if residual is not None and (tuple(residual.shape) != (b, cout, ho, wo) or
                                 not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"conv3xtf32: residual must be a channels-last {(b, cout, ho, wo)}, got "
                         f"{tuple(residual.shape)} strides {residual.stride()}")
    if any(t.data_ptr() % 16 for t in (x, bias) + (() if residual is None else (residual,))):
        raise ValueError("conv3xtf32: x, bias and residual must be 16-byte aligned")
    return b, cin, h, w, cout, kh, kw, ho, wo, bn


def conv3xtf32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stride: int = 1,
               pad: Sequence[int] = (1, 1, 1, 1),
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``residual + conv2d(pad(x), weight, bias, stride)`` in float32 (see
    :func:`conv3xtf32_plain`; ``residual`` None: nothing added). x: (B, Cin,
    H, W) float32 in channels-last memory; weight (Cout, Cin, kh, kw),
    bias (Cout,), residual (B, Cout, Ho, Wo) channels-last, all float32.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    and returns a channels-last tensor, or raises on what it does not take
    (:func:`launch_shape`)."""
    if x.device.type == "cpu":
        return conv3xtf32_plain(x, weight, bias, stride, pad, residual)
    build.require_cuda("conv3xtf32", x, weight, bias,
                       *(() if residual is None else (residual,)))
    b, cin, h, w, cout, kh, kw, ho, wo, bn = launch_shape(x, weight, bias, stride, pad,
                                                          residual)
    pl, pr, pt, pb = (int(p) for p in pad)
    if cin % _BK:
        x = _im2col(x, kh, kw, stride, (pl, pr, pt, pb), ho, wo)
        hi, lo = split_weight(F.pad(weight.permute(0, 2, 3, 1).reshape(cout, -1),
                                    (0, _BK - kh * kw * cin)).reshape(cout, _BK, 1, 1))
        b, cin, h, w = x.shape
        kh = kw = stride = 1
        pl = pt = 0
    else:
        hi, lo = split_weight(weight)
    y = torch.empty((b, cout, ho, wo), dtype=torch.float32, device=x.device,
                    memory_format=torch.channels_last)
    rc = build.lib().var_conv3xtf32(
        x.data_ptr(), hi.data_ptr(), lo.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), y.data_ptr(), b, h, w, cin, ho, wo,
        cout, kh, kw, stride, pt, pl, bn, _sms(x.device.index), x.device.index,
        build.stream_of(x))
    build.check(rc, "conv3xtf32")
    conv3xtf32.launches += 1
    return y


conv3xtf32.launches = 0
