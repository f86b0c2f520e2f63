"""Deterministic evaluation loop.

Counterpart of ``make_eval_forward`` / ``evaluate`` in uncertainty_vit_tpu/
evals/classification.py (:33-77): batches stream through one forward, logits
accumulate on the host, and every metric is computed once, globally, on the
model's device. A torch model holds its own parameters, so ``evaluate``
takes no separate variables. MC-dropout and ensemble evaluation are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
import torch.nn as nn

from uncertainty_vit_tpu_torch.evals import metrics as M
from uncertainty_vit_tpu_torch.evals.collect import collect_logits


def make_eval_forward(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """images → logits with the model in eval mode, under inference_mode.
    Build once and reuse across epochs."""

    def forward(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(images)

    return forward


def evaluate(
    model: nn.Module,
    batches: Iterable,
    forward: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Dict[str, float]:
    """Deterministic eval: acc1/5 + the full calibration suite on the global
    logits. ``batches`` yields (images, ..., labels) with images already on
    the model's device; pass ``forward`` from make_eval_forward to reuse it."""
    fwd = forward if forward is not None else make_eval_forward(model)
    logits, labels = collect_logits(fwd, batches)
    device = next(model.parameters()).device
    out = M.classification_metrics(
        torch.from_numpy(logits).to(device), torch.from_numpy(labels).to(device)
    )
    out["loss"] = out["nll"]  # CE == NLL for hard labels
    return {k: float(v) for k, v in out.items()}
