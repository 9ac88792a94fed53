"""Arithmetic that several per-layer readers share: device time of a kind
of kernel per image, a roofline share over the program's kernel rows, a
share of the card's peak."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from benchmark.counts import peaks


def ms_per_image(run, *kinds: str) -> Optional[float]:
    """Device ms an image of the traced calls in kernels of ``kinds``; None
    when the trace holds none of them."""
    tr = run.trace
    if tr is None or not any(k in tr.kind_n for k in kinds):
        return None
    return sum(tr.kind_s.get(k, 0.0) for k in kinds) / tr.images * 1e3


def roofline_pct(run, rows: Dict[str, Tuple[int, float]], parts: Dict[str, Tuple[str, ...]]
                 ) -> Optional[float]:
    """100 x the rows' summed bounds over their summed device time. ``rows``:
    {row: (launches a call, bound seconds a call)}; ``parts``: {row: the
    kinds of the trace that make up its launches} (the first kind counts
    the launches). A row whose launches in the trace are not the calls'
    count is left out, so a row taken off the path leaves the share to the
    others; with none left it is None."""
    tr = run.trace
    if tr is None:
        return None
    bound = spent = 0.0
    for row, (n, b) in rows.items():
        kinds = parts[row]
        if tr.kind_n.get(kinds[0], 0) != n * tr.calls:
            continue
        bound += b * tr.calls
        spent += sum(tr.kind_s.get(k, 0.0) for k in kinds)
    return 100.0 * bound / spent if spent > 0 else None


def peak_pct(run, flops_per_image: float) -> Optional[float]:
    """100 x the operations of the images the traced card ran over the
    traced window's time and the dense bf16 peak: on several cards, rank
    0's share of the whole, which is the whole over the cards."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * flops_per_image * tr.images / tr.window_s / peaks.BF16_FLOPS


def idle_pct(run) -> Optional[float]:
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
