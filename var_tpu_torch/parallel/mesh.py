"""Process groups and tensor-parallel sharding over ``torch.distributed``
(counterpart of ``var_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a (data, model) device mesh and
XLA inserts the collectives. The port runs one process per GPU (torchrun)
and makes them explicit:

* data parallelism: the batch is split over the ``data`` axis and every
  data rank holds the same model; the trainer averages the gradients with
  one flat all-reduce over its data group (``engine/trainer.py``), where
  XLA inserts its gradient all-reduce;
* tensor parallelism over heads: the ``model`` axis holds a Megatron split
  of each block (:func:`var_param_sharding_rules`), with the bridges of
  ``shard_attn.py`` around the sharded matmuls;
* master-only: global rank 0; barrier: ``dist.barrier``.

The ranks form a (dp, mp) grid, rank = d * mp + m: a model group is mp
consecutive ranks (the cards of one node under torchrun, where mp divides
them), a data group strides by mp. An axis of size 1 has no process group
and runs no collective, so a trivial mesh (dp * mp = 1) creates none.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

def initialize_distributed(backend: Optional[str] = None, init_method: str = "env://") -> None:
    """Join the process group that torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); a
    no-op without ``WORLD_SIZE`` or when already joined, as the reference's
    single-process fallback (``dist.py:25-29``). ``backend``: ``nccl`` on a
    machine with a GPU and ``gloo`` without, unless named (gloo also takes
    CUDA tensors, staged through host memory: two ranks on one card, which
    NCCL refuses). With a GPU, this process's current device becomes
    ``cuda:LOCAL_RANK``, so the entry points' default ``"cuda"`` is the
    rank's own card; a ``LOCAL_RANK`` beyond the cards present raises,
    unless the caller names gloo, which may share a card between ranks."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return
    if torch.cuda.is_available():
        local, cards = int(os.environ.get("LOCAL_RANK", 0)), torch.cuda.device_count()
        if local >= cards and backend != "gloo":
            raise RuntimeError(f"LOCAL_RANK {local} but {cards} GPU(s): start at most one "
                               "process a card, or name the gloo backend to share one")
        torch.cuda.set_device(local % cards)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the (data, model) grid: the axis sizes, its
    coordinates, and its data and model process groups (None for an axis of
    size 1)."""

    dp: int = 1
    mp: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None


def make_mesh(model_parallel: int = 1) -> Mesh:
    """(data, model) mesh over every process of the group; ``model_parallel``
    1 is pure data parallelism. Every rank creates every group, in one order,
    as ``dist.new_group`` requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} processes not divisible by mp={model_parallel}")
    dp, mp = world // model_parallel, model_parallel
    if world == 1:
        return Mesh()
    d, m = divmod(dist.get_rank(), mp)
    data_group = model_group = None
    if dp > 1:
        for mi in range(mp):
            g = dist.new_group([di * mp + mi for di in range(dp)])
            if mi == m:
                data_group = g
    if mp > 1:
        for di in range(dp):
            g = dist.new_group([di * mp + mi for mi in range(mp)])
            if di == d:
                model_group = g
    return Mesh(dp, mp, d, m, data_group, model_group)


def capturable(mesh: Optional[Mesh]) -> bool:
    """Whether programs under ``mesh`` can be CUDA graphs: without a mesh,
    and when every process group it has (an axis of size 1 has none) is
    NCCL's, whose collectives a graph holds as kernels. A gloo group's
    collectives run on the host, so its programs run eagerly. It reads the
    groups' backends and nothing else."""
    groups = () if mesh is None else (mesh.data_group, mesh.model_group)
    return all(dist.get_backend(g) == "nccl" for g in groups if g is not None)


def process_is_master() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# collectives over one axis (no-ops where the axis has one rank)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group``; None: nothing to do."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``t`` (same shape) along ``dim``, in group
    rank order; None: ``t``."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def gather_data(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """The data-sharded batch ``t`` (rows of this data rank) made whole on
    every rank."""
    return t if mesh is None else all_gather_cat(t, mesh.data_group, 0)


def data_rows(mesh: Optional[Mesh], batch: int) -> Tuple[int, int]:
    """(first row, global batch) of this data rank's ``batch`` rows."""
    if mesh is None:
        return 0, batch
    return mesh.data_rank * batch, mesh.dp * batch


def broadcast_from_data_root(mesh: Optional[Mesh], tensors) -> None:
    """Overwrite ``tensors`` in place with data rank 0's (the same model
    rank's), as DDP does with the parameters at start."""
    if mesh is None or mesh.data_group is None:
        return
    src = mesh.model_rank  # global rank of (d 0, m)
    for t in tensors:
        dist.broadcast(t.data, src, group=mesh.data_group)


def gather_diff_shape(x: torch.Tensor, group=None, max_len: Optional[int] = None):
    """All-gather tensors whose leading dim differs per rank (reference
    ``dist.allgather_diff_shape``, dist.py:122-146): pad to the longest,
    all-gather, return (stacked (n, max_len, ...) padded tensor, (n,)
    lengths). ``max_len`` None: the longest of this call's."""
    n = torch.tensor([x.shape[0]], device=x.device)
    lengths = all_gather_cat(n, group)
    if max_len is None:
        max_len = int(lengths.max())
    padded = x.new_zeros((max_len,) + tuple(x.shape[1:]))
    padded[:x.shape[0]] = x
    return all_gather_cat(padded[None], group), lengths


# ---------------------------------------------------------------------------
# tensor-parallel layout of the VAR parameters (reference state-dict names)


def var_param_sharding_rules() -> Dict[str, Tuple[int, str]]:
    """{parameter name within a block, or at top level: (dim, how)} of the
    tensors split over ``model``, the same for every mesh; everything else
    is replicated.

    The JAX rules (``mesh.py:108-124``, kernels (in, out)) shard the qkv and
    fc1 kernels' output dim, the proj and fc2 kernels' input dim and the
    head's vocabulary; in (out, in) torch weights that is dim 0 for qkv, fc1
    and head, dim 1 for proj and fc2. The port also splits what a manual
    split needs and GSPMD reshards by itself: q_bias, v_bias and
    scale_mul_1H11 with their heads, fc1's bias with its rows. proj's and
    fc2's biases stay whole: they are added once, after the all-reduce.
    ``"qkv"``: the fused (3C, C) weight splits each of its three C-row
    blocks (q | k | v) by head, since JAX's contiguous 3C/mp chunk
    straddles the segments (``shard_attn.py:111-114``)."""
    return {
        "attn.mat_qkv.weight": (0, "qkv"),
        "attn.q_bias": (0, "split"),
        "attn.v_bias": (0, "split"),
        "attn.scale_mul_1H11": (1, "split"),
        "attn.proj.weight": (1, "split"),
        "ffn.fc1.weight": (0, "split"),
        "ffn.fc1.bias": (0, "split"),
        "ffn.fc2.weight": (1, "split"),
        "head.weight": (0, "split"),
        "head.bias": (0, "split"),
    }


def _rule(name: str) -> Optional[Tuple[int, str]]:
    """The rule of a state-dict name ("blocks.<i>." stripped), or None."""
    if name.startswith("blocks."):
        name = name.split(".", 2)[2]
    return var_param_sharding_rules().get(name)


def is_sharded(name: str) -> bool:
    return _rule(name) is not None


def _shard(t: torch.Tensor, dim: int, how: str, mp: int, m: int) -> torch.Tensor:
    if t.shape[dim] % (3 * mp if how == "qkv" else mp):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {mp} ways")
    if how == "qkv":
        blocks = t.reshape(3, t.shape[0] // 3, *t.shape[1:])
        return blocks.chunk(mp, 1)[m].reshape(-1, *t.shape[1:]).clone()
    return t.chunk(mp, dim)[m].clone()


def shard_state_dict(sd: Dict[str, torch.Tensor], mp: int, model_rank: int
                     ) -> Dict[str, torch.Tensor]:
    """Model rank ``model_rank``'s local tensors of the full reference-named
    state dict ``sd``: the sharded ones sliced (copies), the rest as they
    are."""
    out = {}
    for name, t in sd.items():
        rule = _rule(name)
        out[name] = t if rule is None or mp == 1 else _shard(t, *rule, mp, model_rank)
    return out


def unshard_state_dicts(locals_: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The full state dict from every model rank's local one, in rank order:
    the inverse of :func:`shard_state_dict`."""
    out = {}
    for name, t in locals_[0].items():
        rule = _rule(name)
        if rule is None or len(locals_) == 1:
            out[name] = t
            continue
        dim, how = rule
        parts = [sd[name] for sd in locals_]
        if how == "qkv":
            blocks = [p.reshape(3, p.shape[0] // 3, *p.shape[1:]) for p in parts]
            out[name] = torch.cat(blocks, 1).reshape(-1, *t.shape[1:])
        else:
            out[name] = torch.cat(parts, dim)
    return out


def shard_var_params(mesh: Optional[Mesh], var: nn.Module) -> nn.Module:
    """Replace ``var``'s sharded parameters, in place, by this model rank's
    slices (new ``nn.Parameter``s; make the optimizer after this). Every
    other parameter stays whole. A mesh without a model axis changes
    nothing."""
    if mesh is None or mesh.mp == 1:
        return var
    for name, p in list(var.named_parameters()):
        rule = _rule(name)
        if rule is None:
            continue
        owner, leaf = name.rsplit(".", 1)
        local = _shard(p.detach(), *rule, mesh.mp, mesh.model_rank)
        setattr(var.get_submodule(owner), leaf, nn.Parameter(local, p.requires_grad))
    return var


def gather_state_dict(mesh: Optional[Mesh], sd: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The full reference-named tensors of a dict of local ones (a sharded
    model's state dict, or its gradients by parameter name), on every rank
    of the model group."""
    if mesh is None or mesh.mp == 1:
        return dict(sd)
    per_rank: List[Dict[str, torch.Tensor]] = [dict(sd) for _ in range(mesh.mp)]
    for name, t in sd.items():
        if _rule(name) is None:
            continue
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.mp)]
        dist.all_gather(parts, t, group=mesh.model_group)
        for r in range(mesh.mp):
            per_rank[r][name] = parts[r]
    return unshard_state_dicts(per_rank)


def gather_var_state_dict(mesh: Optional[Mesh], var: nn.Module) -> Dict[str, torch.Tensor]:
    """The full reference-named state dict of a model sharded by
    :func:`shard_var_params`, on every rank of its model group."""
    return gather_state_dict(mesh, {k: v.detach() for k, v in var.state_dict().items()})
