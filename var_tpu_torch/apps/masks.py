"""Token masks for inpainting, outpainting and box editing (a copy
of ``var_tpu/apps/masks.py``, numpy only).

Reference semantics (``inpainting.py:48-100``, ``utils_clf.py:6-58``):
a flat boolean mask over the L-token pyramid; True = keep ground truth.
Patches are specified at one ``target_layer``; earlier scales are fully
kept, the target scale masks exactly the listed patches, later scales mask
the spatially-corresponding (floor/ceil-scaled) regions. ``reverse=True``
flips keep/regenerate (outpainting / keep-only-patch editing).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def generate_inpainting_mask(
    patch_nums: Sequence[int],
    target_layer: int,
    patch_coord_list: List[Tuple[int, int]],
    reverse: bool = False,
) -> np.ndarray:
    """(L,) bool mask; True = keep. See module docstring."""
    masks = []
    for s, pn in enumerate(patch_nums):
        layer = np.full(pn * pn, not reverse, dtype=bool)
        if s < target_layer:
            masks.append(layer)
            continue
        for (i_t, j_t) in patch_coord_list:
            if s == target_layer:
                layer[i_t * pn + j_t] = reverse
            else:
                ratio = pn / patch_nums[target_layer]
                x0, x1 = math.floor(i_t * ratio), math.ceil((i_t + 1) * ratio)
                y0, y1 = math.floor(j_t * ratio), math.ceil((j_t + 1) * ratio)
                for x in range(x0, x1):
                    for y in range(y0, y1):
                        layer[x * pn + y] = reverse
        masks.append(layer)
    return np.concatenate(masks)


def keep_scales_mask(patch_nums: Sequence[int], keep_through: int) -> np.ndarray:
    """Keep all tokens of scales <= keep_through, regenerate the rest — the
    fork's default inpainting recipe (``inpainting.py:347-348`` keeps scales
    0-6 of 10)."""
    masks = [np.full(pn * pn, s <= keep_through, dtype=bool)
             for s, pn in enumerate(patch_nums)]
    return np.concatenate(masks)


def get_edit_mask(
    patch_nums: Sequence[int],
    y0: float, x0: float, y1: float, x1: float,
    inpainting: bool = True,
) -> np.ndarray:
    """(ph, pw) binary edit mask at the final-scale grid — 1 keeps the
    ground-truth embedding, 0 lets VAR generate (notebook ``get_edit_mask``).
    ``inpainting=True``: the box is regenerated; False (outpainting): only
    the box is kept."""
    ph = pw = patch_nums[-1]
    m = np.zeros((ph, pw), np.float32)
    m[round(y0 * ph): round(y1 * ph), round(x0 * pw): round(x1 * pw)] = 1.0
    return (1.0 - m) if inpainting else m
