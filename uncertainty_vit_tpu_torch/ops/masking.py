"""Blockwise masking of patch tokens (the data2vec / BEiT mask generator).

Counterpart of uncertainty_vit_tpu/ops/masking.py (``blockwise_mask``
:28-98, ``batched_blockwise_mask`` :101-118), after the reference's
masking_generator.py:29-92: blocks of area ~ U(min_num_patches, remaining)
and log-uniform aspect ratio in [0.3, 1/0.3] are proposed and
accepted when they add 0 < delta ≤ remaining new patches, until
``num_masking_patches`` are set. Defaults follow the cyclical recipe: a
14×14 grid, 120 patches, blocks of at least 16.

The JAX function's documented divergence from the reference is kept: a
fixed budget of ``max_attempts`` proposals (10 per expected block), none
skipped once the target is reached (a proposal then is rejected), and no
early stop after 10 failures in a row.

The draws are taken apart from the op: ``draw_blockwise`` returns each
sample's and each attempt's four raw uniforms [B, attempts, 4] (area,
aspect, top, left) from an explicit ``torch.Generator``; ``blockwise_masks``
applies given draws. The op runs on the host, in numpy, as the reference
makes its masks in its CPU loader workers (datasets.py:110-118): its
attempts depend on each other through the running count, so it is some
2,500 small operations a batch of 128, which numpy takes in a few ms where
launches on the card would cost as many kernels a step. The cyclical driver
makes a batch's masks a batch ahead of its step, from the step's CPU
generator, and copies them to the card with the batch
(``cli/pretrain_cyclical.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


MIN_ASPECT = 0.3  # the blocks' aspect ratio lies in [0.3, 1/0.3]


def default_attempts(num_masking_patches: int = 120, min_num_patches: int = 16) -> int:
    """~10 proposals per expected block (the reference's retry budget)."""
    return 10 * max(num_masking_patches // max(min_num_patches, 1), 1)


def draw_blockwise(generator: torch.Generator, b: int, attempts: int) -> torch.Tensor:
    """[b, attempts, 4] raw uniforms in [0, 1) on the generator's device."""
    return torch.rand((b, attempts, 4), generator=generator, device=generator.device)


def blockwise_masks(draws, window_size: Tuple[int, int] = (14, 14),
                    num_masking_patches: int = 120, min_num_patches: int = 16,
                    max_num_patches: Optional[int] = None) -> np.ndarray:
    """[B, H·W] float32 {0, 1} masks from ``draws`` [B, attempts, 4] (a CPU
    tensor or an array). Each attempt is the JAX loop body's, in f32, over
    the whole batch: the area min + (max_mask − min)·u, the aspect
    exp(log a + (log 1/a − log a)·u) (a = MIN_ASPECT), h = round(sqrt(area·aspect)),
    w = round(sqrt(area/aspect)) (half to even), the inclusive top
    floor(u·(H − h + 1)) clipped to [0, max(H − h, 0)] and the left
    likewise; accepted where w < W, h < H and 0 < delta ≤ max_mask (which
    implies count < target). Rows (h, top) and columns (w, left) are
    computed as the two rows of one array."""
    f32 = np.float32
    height, width = window_size
    max_num = num_masking_patches if max_num_patches is None else max_num_patches
    u = np.asarray(draws, dtype=f32)
    b, attempts, _ = u.shape
    log_l, log_u = np.log(f32(MIN_ASPECT)), np.log(f32(1.0 / MIN_ASPECT))
    aspect = np.exp(log_l + (log_u - log_l) * u[..., 1])  # [B, A]: no running count in it
    lim = np.array([[height], [width]], f32)
    idx = np.arange(max(height, width), dtype=f32)
    mask = np.zeros((b, height, width), f32)
    count = np.zeros((b,), f32)  # exact: at most H·W
    for i in range(attempts):
        max_mask = np.minimum(f32(num_masking_patches) - count, f32(max_num))
        area = f32(min_num_patches) + (max_mask - f32(min_num_patches)) * u[:, i, 0]
        hw = np.round(np.sqrt(np.stack((area * aspect[:, i], area / aspect[:, i]))))
        valid = (hw < lim).all(axis=0)
        start = np.floor(u[:, i, 2:].T * (lim + f32(1) - hw))
        start = np.minimum(np.maximum(start, f32(0)), np.maximum(lim - hw, f32(0)))
        ind = (idx >= start[..., None]) & (idx < (start + hw)[..., None])  # [2, B, L]
        region = ind[0, :, :height, None] & ind[1, :, None, :width]
        delta = hw[0] * hw[1] - (mask * region).sum(axis=(1, 2), dtype=f32)
        accept = valid & (delta > 0) & (delta <= max_mask)
        mask[accept[:, None, None] & region] = 1.0
        count += np.where(accept, delta, f32(0))
    return mask.reshape(b, height * width)


def make_blockwise_masks(generator: torch.Generator, b: int,
                         window_size: Tuple[int, int] = (14, 14),
                         num_masking_patches: int = 120, min_num_patches: int = 16,
                         max_num_patches: Optional[int] = None) -> np.ndarray:
    """A batch of masks: the draws of ``default_attempts`` proposals from
    ``generator`` (a CPU generator), then ``blockwise_masks``."""
    draws = draw_blockwise(generator, b, default_attempts(num_masking_patches, min_num_patches))
    return blockwise_masks(draws, window_size, num_masking_patches, min_num_patches,
                           max_num_patches)
