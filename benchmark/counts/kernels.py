"""Bounds of the program's hand-written kernels (``PERF.md``'s kernel table,
rows 1-6) at a cell's shapes: the least time each launch could take on the
card, from the bytes it must move (each input read once, each output
written once) and the operations it must do. The arithmetic of the table's
rows, kept here so that the yardstick does not move with the program.

Each function returns {row: (launches, bound seconds summed over them)}
for one call of the cell's entry.
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.counts import peaks
from benchmark.counts.model import useful_pairs
from benchmark.reference.models import Sizes

Rows = Dict[str, Tuple[int, float]]


def _ln(rows: int, l: int, c: int) -> float:
    """Row 1, modulated LayerNorm of (rows, l, c) bf16 with float32 scale and
    shift rows: reads x, writes y, reads two (rows, c) float32 vectors; a
    minimal pass does 8 operations an element in float32."""
    n = rows * l * c
    return peaks.bound_s(2 * n * 2 + 2 * rows * c * 4, 8.0 * n, peaks.FP32_FLOPS)


def _decode(rows: int, l: int, lk: int, c: int) -> float:
    """Rows 2 and 4, attention of l queries over lk cached keys, bf16:
    reads q, K, V, writes out; 4 operations a (query, key) pair a channel."""
    return peaks.bound_s(2 * (2 * rows * l * c + 2 * rows * lk * c), 4.0 * rows * l * lk * c,
                         peaks.BF16_FLOPS)


def _select(rows: int, v: int) -> float:
    """Row 3, the top-k/top-p bound of (rows, v) float32 logits: reads each
    logit once, writes one int32 a row; a key, an exp, a mass add and one
    histogram count in each of 2 x 4 radix-256 passes a logit."""
    return peaks.bound_s(rows * v * 4 + rows * 4, rows * v * (3 + 2 * 4), peaks.FP32_FLOPS)


def sample_rows(s: Sizes, batch: int) -> Rows:
    """One chunked-cache CFG decode of ``batch`` images: per scale and
    block two LayerNorms and one decode attention over the 2B rows, per
    scale one selection over the B guided rows."""
    c, out = s.embed_dim, {"row1": [0, 0.0], "row2": [0, 0.0], "row3": [0, 0.0]}
    for pn, end in zip(s.patch_nums, s.ends):
        l = pn * pn
        out["row1"][0] += 2 * s.depth
        out["row1"][1] += 2 * s.depth * _ln(2 * batch, l, c)
        out["row2"][0] += s.depth
        out["row2"][1] += s.depth * _decode(2 * batch, l, end, c)
        out["row3"][0] += 1
        out["row3"][1] += _select(batch * l, s.vocab_size)
    return {k: (n, t) for k, (n, t) in out.items()}


def train_rows(s: Sizes, batch: int, remat: int = 2) -> Rows:
    """One training step through row 6 (the paired block-causal attention):
    a forward a layer, again in the backward under remat 2, and one
    backward (its dQ and dK/dV kernels together) a layer."""
    c, L, pairs = s.embed_dim, s.seq_len, useful_pairs(s)
    n, stats = batch * L * c, batch * s.num_heads * L * 4
    fwd = peaks.bound_s(4 * n * 2 + stats, 4.0 * batch * c * pairs, peaks.BF16_FLOPS)
    bwd = peaks.bound_s(8 * n * 2 + stats, 10.0 * batch * c * pairs, peaks.BF16_FLOPS)
    n_fwd = s.depth * (2 if remat == 2 else 1)
    return {"row6_fwd": (n_fwd, n_fwd * fwd), "row6_bwd": (s.depth, s.depth * bwd)}
