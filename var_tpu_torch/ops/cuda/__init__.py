"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper routes by device: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. ``launches`` on each wrapper counts
kernel launches and nothing else; :func:`wrapper_of` names the wrapper a
profiler's kernel event belongs to.
"""

from __future__ import annotations

from typing import Optional

# (a piece of the kernel's name, its wrapper) for the kernels whose name
# alone names the wrapper; gn_silu's three kernels share one wrapper
_KERNEL_WRAPPERS = (("modulated_ln_kernel", "modulated_layernorm"),
                    ("topk_topp_bound_kernel", "topk_topp_bound"),
                    ("gn_silu_", "gn_silu"),
                    ("gn_stats_kernel", "gn_channel_stats"),
                    ("kv_write_kernel", "kv_write"),
                    ("conv3xtf32_wgmma_kernel", "conv3xtf32"))


def counted_wrappers() -> tuple:
    """Every kernel wrapper with a ``launches`` counter, in kernel-table order,
    then ``gn_silu``, ``kv_write`` and ``conv3xtf32``, which have no row
    there (imported here, not at import of the package)."""
    from var_tpu_torch.ops.cuda.conv3xtf32 import conv3xtf32
    from var_tpu_torch.ops.cuda.flash_attention import (flash_attention_bwd,
                                                        flash_attention_fwd, flash_decode,
                                                        flash_decode_paired, paired_train_bwd,
                                                        paired_train_fwd)
    from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm
    from var_tpu_torch.ops.cuda.gn_silu import gn_silu
    from var_tpu_torch.ops.cuda.gn_stats import gn_channel_stats
    from var_tpu_torch.ops.cuda.kv_write import kv_write
    from var_tpu_torch.ops.cuda.select import topk_topp_bound

    return (modulated_layernorm, flash_decode, topk_topp_bound, flash_decode_paired,
            flash_attention_fwd, flash_attention_bwd, paired_train_fwd, paired_train_bwd,
            gn_channel_stats, gn_silu, kv_write, conv3xtf32)


def wrapper_of(event_name: str) -> Optional[str]:
    """The name of the counted wrapper (:func:`counted_wrappers`) whose
    kernel a profiler's device event is, from the kernel's name as the
    profiler (demangled) or ``cuobjdump`` (mangled) prints it; None for
    every other kernel: the fp32 backward's ``train_delta_f32_kernel``,
    the span stamp, cuBLAS, cuDNN and PyTorch's own.

    Rows 2 and 4 are the ``kPaired`` false / true instantiations of the
    decode-attention kernels; rows 5 and 6 the ``kRow`` 5 / 6
    instantiations of the training-attention kernels, whose forward is
    ``ptrain_fwd_*`` and backward ``ptrain_dq_*`` then ``ptrain_dkv_*``."""
    n = event_name.lower()
    if "decode_attention" in n:
        if "<true" in n or "ilb1e" in n:
            return "flash_decode_paired"
        return "flash_decode" if "<false" in n or "ilb0e" in n else None
    if any(k in n for k in ("ptrain_fwd", "ptrain_dq", "ptrain_dkv")):
        if "<5>" in n or "ili5e" in n:
            row = "flash_attention"
        elif "<6>" in n or "ili6e" in n:
            row = "paired_train"
        else:
            return None
        return f"{row}_fwd" if "ptrain_fwd" in n else f"{row}_bwd"
    for piece, wrapper in _KERNEL_WRAPPERS:
        if piece in n:
            return wrapper
    return None
