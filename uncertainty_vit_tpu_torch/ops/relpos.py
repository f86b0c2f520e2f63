"""Relative position bias index construction.

Semantics follow the BEiT relative position bias of the reference
(modeling_finetune.py:106-134 per-block, :328-364 shared): a learned table of
shape [(2H-1)(2W-1) + 3, num_heads] indexed by a static [N+1, N+1] index map,
with three dedicated slots for cls→token, token→cls, and cls→cls.

The index map is a constant, computed once in numpy (a copy of
uncertainty_vit_tpu/ops/relpos.py); the model holds it as a non-persistent
buffer and gathers the [H, N, N] bias from the table once per forward.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


def num_relative_distance(window_size: Tuple[int, int]) -> int:
    return (2 * window_size[0] - 1) * (2 * window_size[1] - 1) + 3


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size: Tuple[int, int]) -> np.ndarray:
    """Static [H*W+1, H*W+1] int32 index into the relative-position table."""
    h, w = window_size
    nrd = num_relative_distance(window_size)

    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    coords_flat = coords.reshape(2, -1)  # [2, H*W]
    rel = coords_flat[:, :, None] - coords_flat[:, None, :]  # [2, N, N]
    rel = rel.transpose(1, 2, 0).astype(np.int64)  # [N, N, 2]
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1

    index = np.zeros((h * w + 1, h * w + 1), dtype=np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = nrd - 3
    index[0:, 0] = nrd - 2
    index[0, 0] = nrd - 1
    return index.astype(np.int32)
