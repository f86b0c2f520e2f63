"""Evaluation loops: deterministic, MC-dropout and ensemble classification.

Counterpart of uncertainty_vit_tpu/evals/classification.py (:33-134):
batches stream through one forward, logits accumulate on the host behind a
readback window, and every metric is computed once, globally, on the
model's device. A torch model holds its own parameters, so ``evaluate`` and
``evaluate_mc_dropout`` take no separate variables. The heteroscedastic
head's branch (``het=True``) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from uncertainty_vit_tpu_torch.evals import metrics as M
from uncertainty_vit_tpu_torch.evals.collect import (
    collect_logits, per_call_generator, pipelined_pairs,
)
from uncertainty_vit_tpu_torch.evals.ensembles import ensemble_mean_logits, make_ensemble_forward
from uncertainty_vit_tpu_torch.evals.mc_dropout import make_mc_dropout_mean_forward


def make_eval_forward(model: nn.Module, het: bool = False
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """images → logits with the model in eval mode, under inference_mode.
    Build once and reuse across epochs."""
    if het:
        raise NotImplementedError("the heteroscedastic head's eval forward is not ported yet")

    def forward(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(images)

    return forward


def evaluate(
    model: nn.Module,
    batches: Iterable,
    forward: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    het: bool = False,
) -> Dict[str, float]:
    """Deterministic eval: acc1/5 + the full calibration suite on the global
    logits. ``batches`` yields (images, ..., labels) with images already on
    the model's device; pass ``forward`` from make_eval_forward to reuse it."""
    fwd = forward if forward is not None else make_eval_forward(model, het=het)
    logits, labels = collect_logits(fwd, batches)
    out = _metrics(model, logits, labels)
    out["loss"] = out["nll"]  # CE == NLL for hard labels
    return out


def _metrics(model: nn.Module, logits: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """The metric suite of host logits and labels, computed on the model's
    device."""
    device = next(model.parameters()).device
    out = M.classification_metrics(
        torch.from_numpy(logits).to(device), torch.from_numpy(labels).to(device)
    )
    return {k: float(v) for k, v in out.items()}


def evaluate_mc_dropout(
    model: nn.Module,
    batches: Iterable,
    num_samples: int = 8,
    seed: int = 0,
    split_at: int = 0,
) -> Dict[str, float]:
    """K-sample MC-dropout eval on the mean logits
    (uncertainty_evaluations.py:41-89).

    ``model`` must be built with drop_path_rate=0 and the finetuned dropout
    rates (see evals/mc_dropout.py). split_at > 0 shares the first blocks
    across the samples: exact when model.cfg.dropout_from_block ≥ split_at,
    a last-layers approximation otherwise. Every batch draws its masks from
    a fresh generator of the stream that ``seed`` starts, so a run is
    reproducible from it."""
    mean_fwd = make_mc_dropout_mean_forward(model, num_samples, split_at=split_at)
    fresh = per_call_generator(seed, next(model.parameters()).device)
    pairs = ((mean_fwd(batch[0], fresh()), batch[-1]) for batch in batches)
    outs = list(pipelined_pairs(pairs))
    return _metrics(model, np.concatenate([o[0] for o in outs]),
                    np.concatenate([o[1] for o in outs]))


def evaluate_ensemble(
    model: nn.Module,
    stacked_params: Mapping[str, torch.Tensor],
    batches: Iterable,
) -> Dict[str, Any]:
    """Per-member metrics and the mean-logit ensemble's metrics
    (engine_for_finetuning.py:224-343). ``stacked_params`` comes from
    ``ensembles.stack_params``, on the model's device."""
    fwd = make_ensemble_forward(model)
    pairs = ((fwd(stacked_params, b[0]), b[-1]) for b in batches)  # [M, B, C]
    outs = list(pipelined_pairs(pairs))
    member_logits = np.concatenate([o[0] for o in outs], axis=1)
    labels = np.concatenate([o[1] for o in outs])
    return {
        "members": [_metrics(model, m, labels) for m in member_logits],
        "ensemble": _metrics(
            model, ensemble_mean_logits(torch.from_numpy(member_logits)).numpy(), labels),
    }
