"""Evaluation loops: deterministic, MC-dropout and ensemble classification.

Counterpart of uncertainty_vit_tpu/evals/classification.py (:33-134):
batches stream through one forward, logits accumulate on the host behind a
readback window, and every metric is computed once, globally, on the
model's device. A torch model holds its own parameters, so ``evaluate`` and
``evaluate_mc_dropout`` take no separate variables. With ``het=True`` (the
heteroscedastic head) every batch draws the head's MC noise from a fresh
generator of the stream ``evaluate``'s seed starts (JAX :33-77: a fresh
'mc' key per call, as the reference resamples its noise in every forward,
modeling_finetune.py:1145-1146). A gumbel or dual_sto model
(``core.config.draws_gumbel``) draws its noise in the same way, from the
same per-batch generator, as F.gumbel_softmax draws on every forward of the
reference. ``evaluate_dist`` is the dist
(mean+covariance) model's evaluation, the metrics of its logits (the JAX
driver's ``dist_eval``, cli/finetune.py:509-518).

On a mesh's data axis (``shards``, an ``evals.collect.DataShards``) each
rank's forwards take its shard's batches, drawing what one process draws
for the global batch (``models.layers.batch_shard``), and the metrics are
computed on every rank from the union of the ranks' logits, each sample
once.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from uncertainty_vit_tpu_torch.core.config import draws_gumbel
from uncertainty_vit_tpu_torch.evals import metrics as M
from uncertainty_vit_tpu_torch.evals.collect import (
    DataShards, collect_logits, per_call_generator, pipelined_pairs,
)
from uncertainty_vit_tpu_torch.evals.ensembles import ensemble_mean_logits, make_ensemble_forward
from uncertainty_vit_tpu_torch.evals.mc_dropout import make_mc_dropout_mean_forward


def draws_in_eval(model: nn.Module, het: bool = False) -> bool:
    """Whether the model's evaluation forward draws: the heteroscedastic
    head's noise (``het``) or a gumbel / dual_sto attention's."""
    return het or draws_gumbel(getattr(model, "cfg", None))


def make_eval_forward(model: nn.Module, het: bool = False) -> Callable[..., torch.Tensor]:
    """images → logits with the model in eval mode, under inference_mode.
    When it draws (``draws_in_eval``): (images, generator) → logits, the
    heteroscedastic head's noise (het=True) and the Gumbel attention's
    drawn from ``generator`` (on the images' device). Build once and reuse
    across epochs."""
    if draws_in_eval(model, het):
        gumbel = draws_gumbel(model.cfg)

        def drawing_forward(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
            model.eval()
            with torch.inference_mode():
                return model(images, mc_generator=generator if het else None,
                             gumbel_generator=generator if gumbel else None)

        return drawing_forward

    def forward(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(images)

    return forward


def make_dist_eval_forward(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """images → the dist model's logits, output [2] of its forward, in eval
    mode under inference_mode (engine_for_finetuning_dist.dist_evaluate
    :441-495; JAX engine_finetune_dist.py:150-157)."""

    def forward(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model(images)[2]

    return forward


def evaluate_dist(model: nn.Module, batches: Iterable,
                  forward: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                  shards: Optional[DataShards] = None) -> Dict[str, float]:
    """The dist model's evaluation: ``metrics.classification_metrics`` of its
    logits over ``batches`` (no "loss" key, as the JAX driver's dict has
    none; the union of the data ranks' logits with ``shards``). ``forward``:
    one from ``make_dist_eval_forward``, to reuse it."""
    logits, labels = _union(shards, *collect_logits(forward or make_dist_eval_forward(model),
                                                    batches))
    return _metrics(model, logits, labels)


def evaluate(
    model: nn.Module,
    batches: Iterable,
    forward: Optional[Callable[..., torch.Tensor]] = None,
    het: bool = False,
    seed: int = 0,
    shards: Optional[DataShards] = None,
) -> Dict[str, float]:
    """Deterministic eval: acc1/5 + the full calibration suite on the global
    logits (the union of the data ranks' with ``shards``). ``batches`` yields (images, ..., labels) with images already on
    the model's device; pass ``forward`` from make_eval_forward (built with
    the same ``het``) to reuse it. A forward that draws
    (``draws_in_eval``) gets a fresh generator for each batch, of the stream
    ``seed`` starts (the JAX package's ``rng``)."""
    fwd = forward if forward is not None else make_eval_forward(model, het=het)
    if draws_in_eval(model, het):
        fresh = per_call_generator(seed, next(model.parameters()).device)
        call, fwd = fwd, lambda images: call(images, fresh())
    logits, labels = _union(shards, *collect_logits(fwd, batches))
    out = _metrics(model, logits, labels)
    out["loss"] = out["nll"]  # CE == NLL for hard labels
    return out


def _union(shards: Optional[DataShards], logits: np.ndarray, labels: np.ndarray, axis: int = 0):
    """(logits, labels) of every data rank in the split's order (rows along
    ``axis`` of the logits), or as they are without ``shards``."""
    if shards is None:
        return logits, labels
    return shards.union(logits, axis), shards.union(labels)


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
    shards: Optional[DataShards] = None,
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
    return _metrics(model, *_union(shards, np.concatenate([o[0] for o in outs]),
                                   np.concatenate([o[1] for o in outs])))


def evaluate_ensemble(
    model: nn.Module,
    stacked_params: Mapping[str, torch.Tensor],
    batches: Iterable,
    seed: int = 0,
    shards: Optional[DataShards] = None,
) -> Dict[str, Any]:
    """Per-member metrics and the mean-logit ensemble's metrics
    (engine_for_finetuning.py:224-343). ``stacked_params`` comes from
    ``ensembles.stack_params``, on the model's device. A gumbel or dual_sto
    model draws each batch's noise from a fresh generator of the stream
    ``seed`` starts."""
    fwd = make_ensemble_forward(model)
    if draws_gumbel(model.cfg):
        fresh = per_call_generator(seed, next(model.parameters()).device)
        call, fwd = fwd, lambda stacked, images: call(stacked, images, fresh())
    pairs = ((fwd(stacked_params, b[0]), b[-1]) for b in batches)  # [M, B, C]
    outs = list(pipelined_pairs(pairs))
    member_logits, labels = _union(shards, np.concatenate([o[0] for o in outs], axis=1),
                                   np.concatenate([o[1] for o in outs]), axis=1)
    return {
        "members": [_metrics(model, m, labels) for m in member_logits],
        "ensemble": _metrics(
            model, ensemble_mean_logits(torch.from_numpy(member_logits)).numpy(), labels),
    }
