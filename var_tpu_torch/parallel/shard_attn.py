"""Tensor parallelism over heads: the mesh rules and the three bridges of a
Megatron split (counterpart of ``var_tpu/parallel/shard_attn.py``).

The JAX package hands each device whole heads through ``jax.shard_map``
(``paired_train`` :80, ``decode_paired`` :95, ``decode_paired_chunks``
:108, ``flash_blhd`` :153) and lets GSPMD put the collectives around the
matmuls. The port's kernels already take local tensors, so each of those
bridges is the kernel called with ``h_local = H // mp`` heads on this
rank's C/mp lanes (``models/var.py``), and the collectives are explicit,
as ``torch.autograd.Function``s:

* :func:`copy_to_model`: identity forward, all-reduce of the gradient over
  the model group backward; at the input of the column-split matmuls (qkv,
  fc1, the head), whose input is replicated;
* :func:`reduce_from_model`: all-reduce forward, identity backward; after
  the row-split matmuls (proj, fc2), whose partial sums it adds;
* :func:`gather_from_model`: the head's V/mp logit columns gathered along
  V forward, this rank's slice of the gradient backward.

Geometry (:func:`paired_mesh_ok`, :func:`flash_mesh_ok`): JAX's rules, kept
with its answers. In the JAX package the paired kernels want an even head
count a device and a mesh without one goes to XLA. The port's kernels take
one head a CUDA block, so the model runs them on any ``H // mp`` heads and
asks only that mp divide H (:func:`local_heads`); each rank holds its own
rows of the batch, so dp need not divide anything there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from var_tpu_torch.parallel.mesh import Mesh, all_gather_cat


def axis_sizes(mesh: Optional[Mesh]):
    """(dp, mp) -- sizes of the data/model axes (1 if absent)."""
    return (1, 1) if mesh is None else (mesh.dp, mesh.mp)


def mesh_is_trivial(mesh: Optional[Mesh]) -> bool:
    if mesh is None:
        return True
    dp, mp = axis_sizes(mesh)
    return dp * mp == 1


def paired_mesh_ok(mesh: Optional[Mesh], num_heads: int, batch: int) -> bool:
    """Can the paired (head-pair, merged-lane) kernels run under this mesh?"""
    if mesh is None:
        return False
    dp, mp = axis_sizes(mesh)
    if num_heads % mp or (num_heads // mp) % 2:
        return False  # per-rank head count must be even (pairs)
    return batch % dp == 0


def flash_mesh_ok(mesh: Optional[Mesh], num_heads: int, batch: int) -> bool:
    """Geometry check for the BLHD streaming kernel (any positive per-rank
    head count works)."""
    if mesh is None:
        return False
    dp, mp = axis_sizes(mesh)
    return num_heads % mp == 0 and batch % dp == 0


def local_heads(num_heads: int, mesh: Optional[Mesh]) -> int:
    """This rank's head count, H // mp."""
    _, mp = axis_sizes(mesh)
    if num_heads % mp:
        raise ValueError(f"{num_heads} heads do not split over mp={mp}")
    return num_heads // mp


def _model_group(mesh: Optional[Mesh]):
    return None if mesh is None else mesh.model_group


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.size = dist.get_rank(group), dist.get_world_size(group)
        return all_gather_cat(x, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.size, dim=-1)[ctx.rank].contiguous(), None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    group = _model_group(mesh)
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    group = _model_group(mesh)
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    group = _model_group(mesh)
    return x if group is None else _GatherFromModel.apply(x, group)
