"""Model configuration dataclasses (counterpart of ``var_tpu/config.py``).

Derived rules kept from the reference builder (``models/__init__.py:19-21``):
width = 64 * depth, heads = depth, drop_path = 0.1 * depth / 24; patch-num
presets 256/512/1024 (``arg_util.py:244-249``). Training arguments
(``TrainArgs``/``parse_cli``) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

PATCH_NUM_PRESETS = {
    "256": (1, 2, 3, 4, 5, 6, 8, 10, 13, 16),
    "512": (1, 2, 3, 4, 6, 9, 13, 18, 24, 32),
    "1024": (1, 2, 3, 4, 5, 7, 9, 12, 16, 21, 27, 36, 48, 64),
}


def parse_patch_nums(pn: str) -> Tuple[int, ...]:
    if pn in PATCH_NUM_PRESETS:
        return PATCH_NUM_PRESETS[pn]
    return tuple(int(p) for p in pn.replace("-", "_").split("_"))


@dataclass(frozen=True)
class VAEConfig:
    """VQVAE tokenizer config (reference ``models/vqvae.py:17-49``)."""

    vocab_size: int = 4096
    z_channels: int = 32  # Cvae
    ch: int = 160
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    dropout: float = 0.0
    beta: float = 0.25
    using_znorm: bool = False
    quant_conv_ks: int = 3
    quant_resi: float = 0.5
    share_quant_resi: int = 4  # partially-shared phi convs
    v_patch_nums: Tuple[int, ...] = PATCH_NUM_PRESETS["256"]
    using_sa: bool = True
    using_mid_sa: bool = True

    @property
    def downsample(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


@dataclass(frozen=True)
class VARConfig:
    """VAR transformer config (reference ``models/var.py:22-47``)."""

    num_classes: int = 1000
    depth: int = 16
    embed_dim: int = 1024
    num_heads: int = 16
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.0
    norm_eps: float = 1e-6
    shared_aln: bool = False
    cond_drop_rate: float = 0.1
    attn_l2_norm: bool = False
    patch_nums: Tuple[int, ...] = PATCH_NUM_PRESETS["256"]
    vocab_size: int = 4096
    z_channels: int = 32

    @classmethod
    def from_depth(cls, depth: int, **kw) -> "VARConfig":
        kw.setdefault("embed_dim", depth * 64)
        kw.setdefault("num_heads", depth)
        kw.setdefault("drop_path_rate", 0.1 * depth / 24)
        return cls(depth=depth, **kw)

    @property
    def seq_len(self) -> int:
        return sum(pn * pn for pn in self.patch_nums)

    @property
    def first_l(self) -> int:
        return self.patch_nums[0] ** 2

    @property
    def begin_ends(self) -> Tuple[Tuple[int, int], ...]:
        out, cur = [], 0
        for pn in self.patch_nums:
            out.append((cur, cur + pn * pn))
            cur += pn * pn
        return tuple(out)

    @property
    def num_stages_minus_1(self) -> int:
        return len(self.patch_nums) - 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads
