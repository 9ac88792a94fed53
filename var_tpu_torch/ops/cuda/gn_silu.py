"""GroupNorm, then SiLU or nothing, over channels-last activations
(``csrc/gn_silu.cu``): the VQVAE decoder's norms in bf16 or fp16 inference,
and the frozen encoder's in float32 inference (``models/vae.py::
channels_last_encode``).

Replaces no JAX kernel (the JAX package leaves GroupNorm to XLA, which fuses
it with the SiLU and keeps the layout) and has no row in the kernel table.
PyTorch's ``F.group_norm`` on CUDA copies channels-last input to dense NCHW,
after which cuDNN transposes around every convolution of the decoder; these
kernels read and write NHWC, so ``models/vae.py`` keeps the decoder
channels-last from its first convolution to its last. Float32 statistics
(Welford within a thread, Chan's merges across threads, tiles and the
channels of a group), weight, bias, mean and rstd folded once into one
float32 scale and shift per (batch, channel), one rounding at the end.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from var_tpu_torch.ops.cuda import build

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # the kernels' (common.cuh)
_VEC = 8  # channels in one vector of a thread
_THREADS = 256  # most threads a block
_BLOCKS_PER_SM = 4  # blocks a launch should hand every SM, at least
_TILE_ELEMS = 1 << 17  # most elements of one tile (256 KB): more tiles are cheap to merge


def gn_silu_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                  eps: float, silu: bool = True,
                  bias_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version; the CPU path and the kernel's oracle. x: (B, C,
    H, W) in any layout; weight, bias, bias_in: (C,). The kernel's
    arithmetic in float32: ``bias_in`` added to x, mean and biased variance
    per (batch, group), scale and shift per (batch, channel), ``silu(x *
    scale + shift)``, one rounding to x's dtype, channels-last."""
    b, c = x.shape[:2]
    xf = x.float()
    if bias_in is not None:
        xf = xf + bias_in.float().reshape(1, c, 1, 1)
    var, mean = torch.var_mean(xf.reshape(b, groups, -1), dim=-1, correction=0)
    scale = weight.float().reshape(1, groups, -1) * torch.rsqrt(var + eps)[..., None]
    shift = bias.float().reshape(1, groups, -1) - mean[..., None] * scale
    y = torch.addcmul(shift.reshape(b, c, 1, 1), xf, scale.reshape(b, c, 1, 1))
    if silu:
        y = F.silu(y)
    return y.to(x.dtype, memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def tiling(b: int, hw: int, c: int, sms: int) -> tuple:
    """(pixels a tile, tiles an image) for a launch over ``b`` images of
    ``hw`` pixels of ``c`` channels on ``sms`` SMs: a whole number of the
    block's rows, at most ``_TILE_ELEMS`` elements, and fewer where that
    would leave fewer than ``_BLOCKS_PER_SM`` blocks an SM; one row at
    least."""
    rows = max(1, _THREADS // (c // _VEC))
    want = min(_TILE_ELEMS // c, hw * b // (_BLOCKS_PER_SM * sms))
    tile = max(rows, want // rows * rows)
    return tile, -(-hw // tile)


def gn_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
            eps: float, silu: bool = True,
            bias_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``silu(group_norm(x + bias_in))`` (``silu=False``: the norm alone;
    ``bias_in`` None: nothing added). x: (B, C, H, W) float32, bfloat16 or
    float16 in channels-last memory; weight, bias, bias_in: float32 (C,). A CPU tensor
    takes the plain version; a CUDA tensor launches the three kernels
    (statistics, finalize, apply) and returns a channels-last tensor, or
    raises on what they do not take."""
    if x.device.type == "cpu":
        return gn_silu_plain(x, weight, bias, groups, eps, silu, bias_in)
    vecs = {"weight": weight, "bias": bias}
    if bias_in is not None:
        vecs["bias_in"] = bias_in
    build.require_cuda("gn_silu", x, *vecs.values())
    if x.dtype not in _CODES:
        raise TypeError(f"gn_silu takes float32, bfloat16 or float16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("gn_silu: x must be a channels-last (B, C, H, W) tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    b, c, h, w = x.shape
    if c % _VEC or c % groups or c // _VEC > _THREADS or x.data_ptr() % 16:
        raise ValueError(f"gn_silu: {c} channels in {groups} groups: want C a multiple of "
                         f"{_VEC} and of the groups, at most {_VEC * _THREADS}, 16-byte aligned")
    for name, t in vecs.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"gn_silu: {name} must be a contiguous float32 ({c},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    tile, tiles = tiling(b, h * w, c, _sms(x.device.index))
    # the tiles' (count, mean, M2, -) per group, then (scale, shift) per channel
    scratch = torch.empty(b * (tiles * groups * 4 + c * 2), dtype=torch.float32,
                          device=x.device)
    ss = scratch[b * tiles * groups * 4:]
    y = torch.empty_like(x, memory_format=torch.channels_last)
    rc = build.lib().var_gn_silu(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if bias_in is None else bias_in.data_ptr(), scratch.data_ptr(), ss.data_ptr(),
        y.data_ptr(), b, h * w, c, groups, tile, tiles, float(eps), int(silu), _CODES[x.dtype],
        x.device.index, build.stream_of(x))
    build.check(rc, "gn_silu")
    gn_silu.launches += 3
    return y


gn_silu.launches = 0
