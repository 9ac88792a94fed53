"""Model configuration dataclasses (counterpart of ``var_tpu/config.py``).

Derived rules kept from the reference builder (``models/__init__.py:19-21``):
width = 64 * depth, heads = depth, drop_path = 0.1 * depth / 24; patch-num
presets 256/512/1024 (``arg_util.py:244-249``). ``TrainArgs``/``parse_cli``
carry the reference training flags with the JAX package's ``finalize``
rules (lr = ac * tblr * global_bs / 256, warmup ep / 50, progressive
``pgwp`` and ``sche``), plus ``device``. ``attn`` picks the training
attention (``resolve_attn``): ``paired`` the paired-head training kernel
(row 6 of PERF.md's kernel table), ``pallas`` the streaming flash-attention
kernel forward and backward (row 5), ``hybrid`` row 5's forward with the
dense backward, ``xla`` the dense path; ``auto`` is ``paired`` on the GPU and
``xla`` on the CPU, as the JAX entry point resolves it (``train.py:187-198``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

PATCH_NUM_PRESETS = {
    "256": (1, 2, 3, 4, 5, 6, 8, 10, 13, 16),
    "512": (1, 2, 3, 4, 6, 9, 13, 18, 24, 32),
    "1024": (1, 2, 3, 4, 5, 7, 9, 12, 16, 21, 27, 36, 48, 64),
}


ATTN_IMPLS = ("auto", "xla", "pallas", "hybrid", "paired")


def resolve_attn(attn: str, device) -> str:
    """The training attention impl for ``attn`` on ``device``: ``auto`` is
    ``paired`` on a GPU and ``xla`` on the CPU; an unknown name raises."""
    if attn not in ATTN_IMPLS:
        raise ValueError(f"--attn={attn!r}: want {'|'.join(ATTN_IMPLS)}")
    if attn == "auto":
        return "xla" if str(device).startswith("cpu") else "paired"
    return attn


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


@dataclass
class TrainArgs:
    """Training hyper-parameters; names mirror ``utils/arg_util.py:25-111``
    (``var_tpu/config.py:116-249``)."""

    data_path: str = "/path/to/imagenet"
    exp_name: str = "text"
    device: str = "cuda"  # "cpu" runs the plain PyTorch path
    # model
    depth: int = 16
    saln: bool = False
    anorm: bool = True
    # init
    ini: float = -1.0
    hd: float = 0.02
    aln: float = 0.5
    alng: float = 1e-5
    # optimization
    fp16: int = 0  # 0: fp32; 1: bf16 compute, skip steps with non-finite grads; 2: bf16
    dscale: int = 0  # with fp16=1: dynamic loss scaling (GradScaler parity)
    tblr: float = 1e-4
    tlr: Optional[float] = None
    twd: float = 0.05
    twde: float = 0.0
    tclip: float = 2.0
    ls: float = 0.0  # label smoothing
    bs: int = 768  # global batch size
    batch_size: int = 0  # per-device, derived
    glb_batch_size: int = 0  # derived
    ac: int = 1  # gradient accumulation
    ep: int = 250
    wp: float = 0.0
    wp0: float = 0.005
    wpe: float = 0.01
    sche: str = "lin0"
    opt: str = "adamw"
    # data
    pn: str = "1_2_3_4_5_6_8_10_13_16"
    patch_size: int = 16
    patch_nums: Tuple[int, ...] = ()
    resos: Tuple[int, ...] = ()
    data_load_reso: int = 0
    mid_reso: float = 1.125
    hflip: bool = False
    workers: int = 0
    # progressive training
    pg: float = 0.0
    pg0: int = 4
    pgwp: float = 0.0
    # misc
    seed: Optional[int] = None
    remat: int = 0  # 0 off; 1 whole-block recompute; 2 attention core + LN + FFN hidden
    vae_bf16: int = 0  # tokenize in bf16 (the quantizer stays fp32)
    tokenize_chunk: int = 0  # >0: tokenize in batch chunks of this size (same tokens)
    attn: str = "auto"  # training attention: auto | xla | pallas | hybrid | paired (resolve_attn)
    dbg_nan: bool = False  # autograd anomaly detection (arg_util.py:137)
    allow_random_vae: bool = False  # train without a tokenizer checkpoint
    local_out_dir_path: str = "local_output"
    tb_log_dir_path: str = ""
    log_txt_path: str = ""
    last_ckpt_path: str = ""
    local_debug: bool = False
    val_freq_ep: int = 10
    ckpt_iters: int = 0  # mid-epoch ckpt every N optimizer steps (0 = off)

    def finalize(self, world_size: int = 1) -> "TrainArgs":
        """Derive dependent fields (``arg_util.py:207-284``)."""
        if self.local_debug:
            self.pn = "1_2_3"
            self.seed = 1
            self.aln = 1e-2
            self.alng = 1e-5
            self.saln = False
            self.pg = 0.8
            self.pg0 = 1
        self.patch_nums = parse_patch_nums(self.pn)
        self.resos = tuple(p * self.patch_size for p in self.patch_nums)
        self.data_load_reso = max(self.resos)
        bs_per_dev = max(1, round(self.bs / self.ac / world_size))
        self.batch_size = bs_per_dev
        self.bs = self.glb_batch_size = bs_per_dev * world_size
        self.tlr = self.ac * self.tblr * self.glb_batch_size / 256
        self.twde = self.twde or self.twd
        if self.wp == 0:
            self.wp = self.ep / 50
        if self.pgwp == 0:
            self.pgwp = self.ep / 300
        if self.pg > 0:
            self.sche = f"lin{self.pg:g}"
        self.log_txt_path = os.path.join(self.local_out_dir_path, "log.txt")
        self.last_ckpt_path = os.path.join(self.local_out_dir_path, "ar-ckpt-last.pth")
        self.tb_log_dir_path = os.path.join(
            self.local_out_dir_path,
            f"tb-VARd{self.depth}__pn{self.pn}__b{self.bs}ep{self.ep}{self.opt[:4]}"
            f"lr{self.tblr:g}wd{self.twd:g}",
        )
        return self

    def var_config(self) -> VARConfig:
        return VARConfig.from_depth(self.depth, shared_aln=self.saln, attn_l2_norm=self.anorm,
                                    patch_nums=parse_patch_nums(self.pn))

    def vae_config(self) -> VAEConfig:
        return VAEConfig(v_patch_nums=parse_patch_nums(self.pn))

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            if hasattr(self, k):
                if isinstance(getattr(self, k), tuple) and isinstance(v, list):
                    v = tuple(v)
                setattr(self, k, v)

    def dump_json(self) -> str:
        return json.dumps(self.state_dict(), default=str)


def parse_cli(argv=None) -> TrainArgs:
    """Minimal typed CLI over TrainArgs: ``--flag=value`` / ``--flag value``
    (``var_tpu/config.py:252``); unknown flags are reported and ignored."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args = TrainArgs()
    fields = {f.name: f for f in dataclasses.fields(TrainArgs)}
    i = 0
    extra = []
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            extra.append(tok)
            i += 1
            continue
        key, eq, val = tok[2:].partition("=")
        key = key.replace("-", "_")
        if not eq:
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                val = argv[i + 1]
                i += 1
            else:
                val = "1"  # bare boolean flag
        i += 1
        if key not in fields:
            extra.append(tok)
            continue
        cur = getattr(args, key)
        if fields[key].type in ("bool", bool) or isinstance(cur, bool):
            setattr(args, key, val.lower() in ("1", "true", "yes"))
        elif isinstance(cur, int):
            setattr(args, key, int(float(val)))
        elif isinstance(cur, float) or key == "tlr":
            setattr(args, key, float(val))
        elif key == "seed":
            setattr(args, key, int(float(val)))
        else:
            setattr(args, key, val)
    if extra:
        print(f"[parse_cli] WARNING: unexpected extra args: {extra}")
    return args
