"""Operations a step needs, from a configuration's shapes alone, never from
what the program launches: the same count whatever implements the work.
A multiply-add is two operations. Recomputation (remat) is not counted."""

from __future__ import annotations

from benchmark.reference.models import Sizes


def _matmul_macs_per_token(s: Sizes) -> float:
    """QKV, projection and the two FFN products of one layer, one row."""
    c = s.embed_dim
    return 3 * c * c + c * c + 2 * c * round(c * s.mlp_ratio)


def useful_pairs(s: Sizes) -> int:
    """(query, key) pairs the block-causal mask leaves visible, per head:
    each scale's queries see every key up to the end of their scale."""
    return sum(pn * pn * e for pn, e in zip(s.patch_nums, s.ends))


def _resnet_macs(cin: int, cout: int, hw: int) -> float:
    return hw * hw * (9 * cin * cout + 9 * cout * cout + (cin * cout if cin != cout else 0))


def _attn_macs(c: int, hw: int) -> float:
    n = hw * hw
    return n * (3 * c * c + c * c) + 2 * n * n * c


def encoder_macs(s: Sizes) -> float:
    """The tokenizer's encoder and quant_conv, one image."""
    n, res = len(s.ch_mult), s.reso
    in_mult = (1,) + s.ch_mult
    macs = res * res * 9 * 3 * s.ch
    for i in range(n):
        cin, cout = s.ch * in_mult[i], s.ch * s.ch_mult[i]
        for _ in range(s.num_res_blocks):
            macs += _resnet_macs(cin, cout, res)
            cin = cout
            if i == n - 1 and s.using_sa:
                macs += _attn_macs(cout, res)
        if i != n - 1:
            res //= 2
            macs += res * res * 9 * cout * cout
    cm = s.ch * s.ch_mult[-1]
    macs += 2 * _resnet_macs(cm, cm, res) + (_attn_macs(cm, res) if s.using_mid_sa else 0)
    macs += res * res * 9 * (cm * s.z_channels + s.z_channels * s.z_channels)
    return macs


def decoder_macs(s: Sizes) -> float:
    """post_quant_conv and the decoder, one image."""
    n, res, z = len(s.ch_mult), s.patch_nums[-1], s.z_channels
    cin = s.ch * s.ch_mult[-1]
    macs = res * res * 9 * (z * z + z * cin)
    macs += 2 * _resnet_macs(cin, cin, res) + (_attn_macs(cin, res) if s.using_mid_sa else 0)
    for i in reversed(range(n)):
        cout = s.ch * s.ch_mult[i]
        for _ in range(s.num_res_blocks + 1):
            macs += _resnet_macs(cin, cout, res)
            cin = cout
            if i == n - 1 and s.using_sa:
                macs += _attn_macs(cout, res)
        if i != 0:
            res *= 2
            macs += res * res * 9 * cout * cout
    return macs + res * res * 9 * cin * 3


def sample_flops_per_image(s: Sizes) -> float:
    """One image of a classifier-free-guided decode: every layer's products
    and attention over the cache for the conditional and the unconditional
    row, their AdaLN once a decode, the next-scale embedding and the head
    once (guidance mixes before the head), and the render."""
    c, L = s.embed_dim, s.seq_len
    layer = L * _matmul_macs_per_token(s) + 2 * useful_pairs(s) * c + 6 * c * c
    macs = 2 * s.depth * layer + 2 * 2 * c * c + L * (c * s.vocab_size)
    macs += (L - s.patch_nums[0] ** 2) * s.z_channels * c + decoder_macs(s)
    return 2.0 * macs


def train_flops_per_image(s: Sizes) -> float:
    """One image of a training step: the teacher-forced forward (products,
    the mask's useful pairs, AdaLN, embedding, head) three times for forward
    and backward, and the frozen tokenizer's forward once."""
    c, L = s.embed_dim, s.seq_len
    layer = L * _matmul_macs_per_token(s) + 2 * useful_pairs(s) * c + 6 * c * c
    fwd = s.depth * layer + 2 * c * c + L * c * s.vocab_size
    fwd += (L - s.patch_nums[0] ** 2) * s.z_channels * c
    return 2.0 * (3 * fwd + encoder_macs(s))
