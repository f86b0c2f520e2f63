"""Device → host logits collection for the eval loops.

Counterpart of ``collect_logits`` in uncertainty_vit_tpu/evals/collect.py
(:47-64), as a plain loop: each batch's logits are read back to the host as
they come (the readback is the loop's synchronization point).
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def collect_logits(
    forward: Callable[[torch.Tensor], torch.Tensor], batches: Iterable,
    allow_empty: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run ``forward`` over (images, ..., labels) batches; returns the
    concatenated (f32 logits, labels) on the host. allow_empty=True returns
    zero-length arrays instead of raising."""
    logits, labels = [], []
    for batch in batches:
        logits.append(_host(forward(batch[0]).float()))
        labels.append(_host(batch[-1]))
    if not logits:
        if allow_empty:
            return np.zeros((0, 0), np.float32), np.zeros((0,), np.int64)
        raise ValueError("collect_logits got an empty batch stream")
    return np.concatenate(logits), np.concatenate(labels)
