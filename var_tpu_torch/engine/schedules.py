"""LR / weight-decay annealing schedules (counterpart of
``var_tpu/engine/schedules.py``, reference ``utils/lr_control.py:10-65``).

Linear warmup from ``wp0`` to 1 over ``wp_it`` iterations, then one of
{cos, lin, lin0, lin00, lin<T>, exp} decaying to ``wpe``; weight decay
follows a half cosine from ``wd`` to ``wd_end`` over the whole run. Plain
float functions of the iteration: the trainer sets each step's lr and wd on
the optimizer from the host.
"""

from __future__ import annotations

import math


def lr_factor(sche: str, cur_it: int, wp_it: float, max_it: float, wp0: float = 0.005,
              wpe: float = 0.001) -> float:
    """Multiplier on the peak lr at iteration ``cur_it``."""
    if sche not in ("cos", "exp") and not sche.startswith("lin"):
        raise NotImplementedError(f"unknown sche_type {sche}")
    t = float(cur_it)
    wp_it = round(wp_it)
    if t < wp_it:
        return wp0 + (1.0 - wp0) * t / max(wp_it, 1)
    pasd = (t - wp_it) / (max_it - 1 - wp_it)
    rest = 1.0 - pasd
    if sche == "cos":
        return wpe + (1 - wpe) * (0.5 + 0.5 * math.cos(math.pi * pasd))
    if sche in ("lin", "lin0"):
        T = 0.15 if sche == "lin" else 0.05
        return 1.0 if pasd < T else wpe + (1 - wpe) * rest / (1 - T)
    if sche == "lin00":
        return wpe + (1 - wpe) * rest
    if sche.startswith("lin"):
        T = float(sche[3:])
        max_rest = 1 - T
        wpe_mid = (1 + wpe + (1 - wpe) * max_rest) / 2
        if pasd < T:
            return 1 + (wpe_mid - 1) * pasd / T
        return wpe + (wpe_mid - wpe) * rest / max_rest
    T = 0.15  # exp
    return 1.0 if pasd < T else math.exp((pasd - T) / (1 - T) * math.log(wpe))


def wd_value(cur_it: int, max_it: float, wd: float, wd_end: float) -> float:
    """Half-cosine weight-decay anneal (``lr_control.py:47-48``)."""
    pasd = float(cur_it) / (max_it - 1)
    return wd_end + (wd - wd_end) * (0.5 + 0.5 * math.cos(math.pi * pasd))
