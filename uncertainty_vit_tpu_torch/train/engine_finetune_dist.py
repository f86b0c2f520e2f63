"""Stochastic (dist) finetune engine: triplet batches, soft-target CE plus
the contrastive Wasserstein loss.

Counterpart of uncertainty_vit_tpu/train/engine_finetune_dist.py:26-165
(engine_for_finetuning_dist.dist_train_one_epoch :286-438 of the
reference): optionally the anchor's train transform and the pos / neg eval
transform of a uint8 triplet on the device (``aug_fn`` and ``prep_fn``,
given together) → mixup / cutmix of the anchor → the anchor's forward with
drop-path and dropout drawn from the step's generator → pos and neg each
through a deterministic forward of the same weights under
``torch.no_grad()`` (the reference deep-copies the model every step for
them, :296-299; the JAX package stops their gradient) → soft-target CE
plus ``wasserstein_finetune_loss`` in f32 → backward → AdamW with layer
decay, accumulating ``update_freq`` mini-steps an update. Nothing in the
step reads a value back to the host.

A model built on a ``parallel.mesh.Mesh`` (``model.mesh``: data and model
axes) takes this rank's rows of the global triplet batch: mixup as the
finetune step's, the cross-entropy over the global batch, the Wasserstein
maxima over every data rank (an all-reduce MAX, its gradient to the ranks
that hold it), and the gradient shares summed by the optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from uncertainty_vit_tpu_torch.ops import losses as L
from uncertainty_vit_tpu_torch.ops.mixup import mixup_cutmix, one_hot_smooth
from uncertainty_vit_tpu_torch.train.engine_finetune import (
    FinetuneState, global_accuracy, hessian_context, refuse_hessian_when_sharded,
)
from uncertainty_vit_tpu_torch.train.optim import Optimizer, StepReplay
from uncertainty_vit_tpu_torch.train.schedules import Schedule, constant_schedule


@dataclasses.dataclass(frozen=True)
class DistFinetuneHParams:
    num_classes: int = 100
    mixup_active: bool = True
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    mixup_prob: float = 1.0
    mixup_switch_prob: float = 0.5
    label_smoothing: float = 0.1
    mixup_mode: str = "batch"
    cutmix_minmax: Optional[Tuple[float, float]] = None
    lambda_finetuning: float = 1e-4  # run_class_finetuning.py:240
    lambda_pvn: float = 1e-4  # run_class_finetuning.py:241
    # gradient accumulation: the optimizer's; the reported lr counts updates
    update_freq: int = 1


def make_dist_finetune_train_step(
    model: nn.Module,
    optimizer: Optimizer,
    hp: DistFinetuneHParams,
    lr_schedule: Schedule,
    wd_schedule: Optional[Schedule] = None,
    aug_fn: Optional[Callable[..., torch.Tensor]] = None,
    prep_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    use_hessian: bool = False,
) -> Callable[..., Dict[str, object]]:
    """Returns step(state, images, pos, neg, labels, generator,
    mix_generator=None, aug_generator=None, hessian_generator=None) →
    metrics {"loss", "ce_loss", "wasserstein_loss", "class_acc",
    "grad_norm", "lr"}; the state
    (``train.engine_finetune.FinetuneState``: model, optimizer, step) is
    updated in place.

    Without hooks images / pos / neg are normalized [B, H, W, C] (the
    anchor augmented, pos / neg eval-transformed). With them the step takes
    the raw uint8 triplet on the device: aug_fn(aug_generator, images,
    None) makes the anchor and prep_fn(x) each of pos and neg. ``generator``
    (on the model's device) draws the anchor's drop-path and dropout masks,
    ``mix_generator`` (CPU) mixup's scalars. lr and wd are read at the
    update index, step // update_freq. ``model`` is a
    ``models.dist_vit.DistVisionTransformer``, ``state.model``.
    ``use_hessian`` (adahessian; JAX :57, 124-126) runs the AdaHessian pass
    after the backward on the anchor's draws, the pos / neg embeddings held
    as the step computed them, its z from ``hessian_generator``."""
    if (aug_fn is None) != (prep_fn is None):
        raise ValueError("aug_fn and prep_fn must be provided together: the fused step takes "
                         "raw uint8 for all three triplet streams (anchor aug + pos/neg eval "
                         "prep)")
    if hp.update_freq != optimizer.update_freq:
        raise ValueError(f"update_freq {hp.update_freq} is not the optimizer's "
                         f"{optimizer.update_freq}")
    refuse_hessian_when_sharded(model, use_hessian)
    wd_schedule = wd_schedule or constant_schedule(optimizer.weight_decay)
    mesh = getattr(model, "mesh", None)

    def step(state: FinetuneState, images: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
             labels: torch.Tensor, generator: torch.Generator,
             mix_generator: Optional[torch.Generator] = None,
             aug_generator: Optional[torch.Generator] = None,
             hessian_generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        if aug_fn is not None:
            if aug_generator is None:
                raise ValueError("the train augmentation draws from an explicit aug_generator")
            images, pos, neg = aug_fn(aug_generator, images, None), prep_fn(pos), prep_fn(neg)
        if hp.mixup_active:
            if mix_generator is None:
                raise ValueError("mixup draws from an explicit mix_generator")
            images, targets = mixup_cutmix(
                mix_generator, images, labels, hp.num_classes, hp.mixup_alpha, hp.cutmix_alpha,
                hp.mixup_prob, hp.mixup_switch_prob, hp.label_smoothing, mode=hp.mixup_mode,
                cutmix_minmax=hp.cutmix_minmax, mesh=mesh)
        else:
            targets = one_hot_smooth(labels, hp.num_classes, hp.label_smoothing)
        model.train()
        # the pos / neg embeddings: the same weights, deterministic, no gradient
        with torch.no_grad():
            pos_mean, pos_cov, _ = model(pos, deterministic=True)
            neg_mean, neg_cov, _ = model(neg, deterministic=True)

        def loss_of():
            mean, cov, logits = model(images, generator=generator)
            ce = L.soft_target_cross_entropy(logits, targets, mesh)
            w_loss = L.wasserstein_finetune_loss(
                mean.float(), cov.float(), pos_mean.float(), pos_cov.float(), neg_mean.float(),
                neg_cov.float(), hp.lambda_finetuning, hp.lambda_pvn, mesh)
            return ce + w_loss, ce, w_loss, logits

        replay = StepReplay(model) if use_hessian else None
        with hessian_context(replay):
            loss, ce, w_loss, logits = loss_of()
        optimizer.zero_grad()
        loss.backward()
        hessian = None
        if replay is not None:
            hessian = replay.hessian_diag(lambda: loss_of()[0], optimizer.params,
                                          hessian_generator)
        update = state.step // hp.update_freq
        lr = lr_schedule(update)
        grad_norm = optimizer.step(lr, wd_schedule(update), hessian=hessian)
        state.step += 1
        acc = global_accuracy(logits, targets, mesh)
        return {"loss": loss.detach(), "ce_loss": ce.detach(), "wasserstein_loss": w_loss.detach(),
                "class_acc": acc, "grad_norm": grad_norm, "lr": lr}

    return step

