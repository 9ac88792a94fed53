"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper routes by device: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. ``launches`` on each wrapper counts
kernel launches and nothing else.
"""


def counted_wrappers() -> tuple:
    """Every kernel wrapper with a ``launches`` counter, in kernel-table order,
    then ``gn_silu`` and ``kv_write``, which have no row there (imported
    here, not at import of the package)."""
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
            gn_channel_stats, gn_silu, kv_write)
