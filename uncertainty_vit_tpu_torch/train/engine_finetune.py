"""Supervised finetune engine: the train step and the eval step.

Counterpart of uncertainty_vit_tpu/train/engine_finetune.py:25-182
(engine_for_finetuning.py:46-220 of the reference) for the linear head:
mixup/cutmix on the device → a bf16 forward on f32 parameters in train mode
→ soft-target CE in f32 → backward (through the attention kernels K1/K2 on
the card) → AdamW with layer decay → optional EMA. Every random draw comes
from a generator the caller passes. Gradient accumulation, token masking
and the SNGP / heteroscedastic heads are not ported yet (they raise).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.evals.classification import make_eval_forward
from uncertainty_vit_tpu_torch.ops import losses as L
from uncertainty_vit_tpu_torch.ops.mixup import mixup_cutmix, one_hot_smooth
from uncertainty_vit_tpu_torch.parallel import seq
from uncertainty_vit_tpu_torch.train.ema import ema_on_update_boundary, ema_update
from uncertainty_vit_tpu_torch.train.optim import LayerDecayAdamW
from uncertainty_vit_tpu_torch.train.schedules import Schedule, constant_schedule


@dataclasses.dataclass(frozen=True)
class FinetuneHParams:
    num_classes: int = 1000
    # mixup/cutmix (run_class_finetuning.py:339-346)
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    mixup_prob: float = 1.0
    mixup_switch_prob: float = 0.5
    label_smoothing: float = 0.1
    mixup_active: bool = True
    mixup_mode: str = "batch"
    cutmix_minmax: Optional[Tuple[float, float]] = None
    # criterion when mixup is off: 'smooth' | 'ce'
    criterion: str = "smooth"
    masked_position_prob: float = 0.0
    model_ema_decay: float = 0.9999
    head_type: str = "linear"
    update_freq: int = 1


@dataclasses.dataclass
class FinetuneState:
    """The model (f32 parameters), its optimizer, the number of updates
    taken, and an optional EMA copy of the parameters."""

    model: nn.Module
    optimizer: LayerDecayAdamW
    step: int = 0
    model_ema: Optional[Dict[str, torch.Tensor]] = None


def init_finetune_state(model: nn.Module, optimizer: LayerDecayAdamW,
                        use_model_ema: bool = False) -> FinetuneState:
    ema = ({k: p.detach().clone() for k, p in model.named_parameters()}
           if use_model_ema else None)
    return FinetuneState(model=model, optimizer=optimizer, model_ema=ema)


def _targets(hp: FinetuneHParams, images: torch.Tensor, labels: torch.Tensor,
             mix_generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images, soft targets) as the train step feeds them to the model."""
    if hp.mixup_active:
        if mix_generator is None:
            raise ValueError("mixup draws from an explicit mix_generator")
        return mixup_cutmix(
            mix_generator, images, labels, hp.num_classes, hp.mixup_alpha, hp.cutmix_alpha,
            hp.mixup_prob, hp.mixup_switch_prob, hp.label_smoothing,
            mode=hp.mixup_mode, cutmix_minmax=hp.cutmix_minmax,
        )
    if hp.label_smoothing > 0 and hp.criterion == "smooth":
        return images, one_hot_smooth(labels, hp.num_classes, hp.label_smoothing)
    return images, F.one_hot(labels, hp.num_classes).float()


def make_finetune_train_step(
    model: nn.Module,
    optimizer: LayerDecayAdamW,
    hp: FinetuneHParams,
    lr_schedule: Schedule,
    wd_schedule: Optional[Schedule] = None,
) -> Callable[..., Dict[str, object]]:
    """Returns step(state, images, labels, generator, mix_generator=None) →
    metrics {"loss", "class_acc", "grad_norm", "lr"}; the state (model,
    optimizer, EMA, step) is updated in place.

    ``generator`` lies on the model's device and draws the drop-path and
    dropout masks; ``mix_generator`` (a CPU generator keeps its six scalar
    draws free of device syncs) draws mixup. lr and wd are read at the
    update index, as the optax schedules count updates. ``wd_schedule``
    defaults to the optimizer's constant weight decay.

    A model built with a ``seq_group`` holds each image's tokens split over
    the group's ranks: every rank calls the step on the same batch with
    generators of the same seeds, and after the backward the gradients of
    ``model.token_parameters()`` are summed over the group before the
    optimizer reads them, what GSPMD does for the reference's step
    (tests/test_seq_parallel.py:58-92)."""
    if hp.update_freq != 1:
        raise NotImplementedError("gradient accumulation (update_freq > 1) is not ported yet")
    if hp.masked_position_prob > 0:
        raise NotImplementedError("on-the-fly token masking is not ported yet")
    if hp.head_type != "linear":
        raise NotImplementedError(f"head_type {hp.head_type!r} is not ported yet")
    wd_schedule = wd_schedule or constant_schedule(optimizer.weight_decay)

    def step(state: FinetuneState, images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator, mix_generator: Optional[torch.Generator] = None
             ) -> Dict[str, object]:
        images, targets = _targets(hp, images, labels, mix_generator)
        model.train()
        logits = model(images, generator=generator)
        loss = L.soft_target_cross_entropy(logits, targets)
        optimizer.zero_grad()
        loss.backward()
        if getattr(model, "seq_group", None) is not None:
            seq.all_reduce_grads(model.token_parameters(), model.seq_group)
        lr = lr_schedule(state.step)
        grad_norm = optimizer.step(lr, wd_schedule(state.step))
        if state.model_ema is not None:
            state.model_ema = ema_on_update_boundary(
                lambda: ema_update(state.model_ema, dict(model.named_parameters()),
                                   hp.model_ema_decay),
                state.model_ema, state.step, hp.update_freq,
            )
        state.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == targets.argmax(-1)).float().mean()
        return {"loss": loss.detach(), "class_acc": acc, "grad_norm": grad_norm, "lr": lr}

    return step


def make_eval_step(model: nn.Module, head_type: str = "linear"
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Deterministic eval forward: images → logits."""
    if head_type != "linear":
        raise NotImplementedError(f"head_type {head_type!r} is not ported yet")
    return make_eval_forward(model)
