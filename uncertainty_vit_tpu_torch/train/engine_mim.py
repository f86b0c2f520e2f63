"""BEiT MIM and joint cyclical+BEiT pretraining engines: the train steps.

Counterpart of uncertainty_vit_tpu/train/engine_mim.py (``MIMState`` :24-28,
``make_mim_train_step`` :31-80, ``JointHParams`` :83-89,
``make_joint_train_step`` :92-167), which replace the reference's
engine_for_pretraining.train_one_epoch (:22-112) and
engine_for_cyclical_joint.train_one_epoch (:24-146).

A MIM step: optionally the two-view transform of a uint8 batch on the
device (``aug_fn``, ``ops.augment.make_pretrain_two_view``) → the frozen
tokenizer's argmax over the second view, without gradient (in float32,
``models.dvae.f32_scope``) → the masked student forward
through ``lm_head`` over the codebook vocabulary, drop-path and dropout
drawn from the step's generator → the masked cross-entropy and MLM accuracy
→ backward → AdamW with the clip, ``update_freq`` mini-steps an update.

A joint step adds the EMA teacher (the cyclical engine's machinery: a
second ``JointViT`` on the EMA tensors, not in the optimizer,
deterministic, unmasked, every layer; ``build_targets``;
``cyclical_ema_step`` on the update boundaries),
the smooth-L1 regression of the two-layer ``lm_head`` onto the targets, the
``beit_head``'s cross-entropy, and their mix loss_cyc·(1 − w) + loss_beit·w
with w = max(1 − epoch / vae_loss_weight_anneal_epochs, 0) in f32, the epoch
passed in as a number. Nothing in either step reads a value back to the
host. A gumbel or dual_sto trunk draws its noise from the step's
``gumbel_generator`` (the joint teacher first). ``use_hessian``
(adahessian; JAX :39, 67-69, 98, 136-138) runs the AdaHessian pass after
the backward, as the finetune step does (``engine_finetune``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from uncertainty_vit_tpu_torch.ops import losses as L
from uncertainty_vit_tpu_torch.train.ema import cyclical_ema_step, ema_on_update_boundary
from uncertainty_vit_tpu_torch.train.engine_cyclical import (
    CyclicalHParams, CyclicalState, build_targets,
)
from uncertainty_vit_tpu_torch.train.engine_finetune import FinetuneState, hessian_context
from uncertainty_vit_tpu_torch.train.optim import Optimizer, StepReplay
from uncertainty_vit_tpu_torch.train.schedules import Schedule, constant_schedule


# the MIM state (JAX :24-28) is the finetune one without an EMA: the student,
# its optimizer and the mini-steps taken ("model_ema" None in a checkpoint)
MIMState = FinetuneState


@dataclasses.dataclass(frozen=True)
class JointHParams(CyclicalHParams):
    """The joint step's knobs: the cyclical ones and the annealing horizon
    of the BEiT loss's weight (engine_for_cyclical_joint.py:84-85)."""

    vae_loss_weight_anneal_epochs: float = 100.0


def beit_weight(epoch: float, anneal_epochs: float) -> float:
    """max(1 − epoch / anneal_epochs, 0), computed in f32 as the JAX step
    computes it."""
    w = np.float32(1.0) - np.float32(epoch) / np.float32(anneal_epochs)
    return float(np.maximum(w, np.float32(0.0)))


def _views(aug_fn, images, aug_generator, valid_hw) -> Tuple[torch.Tensor, torch.Tensor]:
    if aug_fn is None:
        return images
    if aug_generator is None:
        raise ValueError("the two-view transform draws from an explicit aug_generator")
    return aug_fn(aug_generator, images, valid_hw)


def _tokens(tokenizer: nn.Module, vae_images: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return tokenizer.get_codebook_indices(vae_images)


def make_mim_train_step(
    model: nn.Module,
    tokenizer: nn.Module,
    optimizer: Optimizer,
    lr_schedule: Schedule,
    wd_schedule: Optional[Schedule] = None,
    aug_fn: Optional[Callable[..., Tuple[torch.Tensor, torch.Tensor]]] = None,
    use_hessian: bool = False,
) -> Callable[..., Dict[str, object]]:
    """Returns step(state, images, bool_masked_pos, generator,
    aug_generator=None, valid_hw=None, gumbel_generator=None,
    hessian_generator=None) → metrics {"loss", "mlm_acc",
    "grad_norm", "lr"}; the state is updated in place.

    images: the pair (normalized student view [B, H, W, C], tokenizer view
    [B, S, S, C]), or with ``aug_fn`` the raw uint8 batch, which
    aug_fn(aug_generator, images, valid_hw) makes into that pair.
    bool_masked_pos: [B, num_patches] in {0, 1} on the images' device.
    ``generator`` draws the student's drop-path and dropout (and the int8
    trunk's rounding seeds). lr and wd are read at the update index, step
    // update_freq. ``model`` is ``state.model``; ``tokenizer`` is frozen."""
    wd_schedule = wd_schedule or constant_schedule(optimizer.weight_decay)
    tokenizer.requires_grad_(False)

    def step(state: MIMState, images, bool_masked_pos: torch.Tensor,
             generator: torch.Generator, aug_generator: Optional[torch.Generator] = None,
             valid_hw: Optional[torch.Tensor] = None,
             gumbel_generator: Optional[torch.Generator] = None,
             hessian_generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        images, vae_images = _views(aug_fn, images, aug_generator, valid_hw)
        mask = bool_masked_pos.float()
        token_ids = _tokens(tokenizer, vae_images)
        model.train()

        def loss_of():
            logits = model(images, mask, generator=generator, gumbel_generator=gumbel_generator)
            return L.masked_mim_cross_entropy(logits, token_ids, mask)

        replay = StepReplay(model, (gumbel_generator,)) if use_hessian else None
        with hessian_context(replay):
            loss, mlm_acc = loss_of()
        optimizer.zero_grad()
        loss.backward()
        hessian = None
        if replay is not None:
            hessian = replay.hessian_diag(lambda: loss_of()[0], optimizer.params,
                                          hessian_generator)
        update = state.step // optimizer.update_freq
        lr = lr_schedule(update)
        grad_norm = optimizer.step(lr, wd_schedule(update), hessian=hessian)
        state.step += 1
        return {"loss": loss.detach(), "mlm_acc": mlm_acc.detach(), "grad_norm": grad_norm,
                "lr": lr}

    return step


def make_joint_train_step(
    model: nn.Module,
    tokenizer: nn.Module,
    optimizer: Optimizer,
    hp: JointHParams,
    lr_schedule: Schedule,
    wd_schedule: Optional[Schedule] = None,
    aug_fn: Optional[Callable[..., Tuple[torch.Tensor, torch.Tensor]]] = None,
    use_hessian: bool = False,
) -> Callable[..., Dict[str, object]]:
    """Returns step(state, images, bool_masked_pos, epoch, generator,
    aug_generator=None, valid_hw=None, gumbel_generator=None,
    hessian_generator=None) → metrics {"loss", "loss_cyc",
    "loss_beit", "mlm_acc", "beit_weight", "grad_norm", "lr"}; the state
    (``train.engine_cyclical.CyclicalState``: student, optimizer, teacher,
    step) is updated in place. images, bool_masked_pos and ``generator`` as
    ``make_mim_train_step``'s; ``epoch`` (a number) sets the BEiT loss's
    weight. The teacher runs on ``hp.layer_results`` ("end" when empty);
    the EMA runs where an update ends, at the update index."""
    if hp.update_freq != optimizer.update_freq:
        raise ValueError(f"update_freq {hp.update_freq} is not the optimizer's "
                         f"{optimizer.update_freq}")
    wd_schedule = wd_schedule or constant_schedule(optimizer.weight_decay)
    tokenizer.requires_grad_(False)

    def step(state: CyclicalState, images, bool_masked_pos: torch.Tensor, epoch: float,
             generator: torch.Generator, aug_generator: Optional[torch.Generator] = None,
             valid_hw: Optional[torch.Tensor] = None,
             gumbel_generator: Optional[torch.Generator] = None,
             hessian_generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        images, vae_images = _views(aug_fn, images, aug_generator, valid_hw)
        mask = bool_masked_pos.float()
        token_ids = _tokens(tokenizer, vae_images)
        with torch.no_grad():
            targets = build_targets(state.teacher(images, None, deterministic=True,
                                                  layer_results=hp.layer_results or "end",
                                                  gumbel_generator=gumbel_generator), hp)
        w = beit_weight(epoch, hp.vae_loss_weight_anneal_epochs)
        model.train()

        def loss_of():
            lm_out, beit_out = model(images, mask, generator=generator,
                                     gumbel_generator=gumbel_generator)
            loss_cyc = L.masked_regression_loss(lm_out.float(), targets, mask, beta=hp.l1_beta,
                                                l2=hp.l2_loss)
            loss_beit, mlm_acc = L.masked_mim_cross_entropy(beit_out, token_ids, mask)
            loss = loss_cyc * float(np.float32(1.0) - np.float32(w)) + loss_beit * w
            return loss, loss_cyc, loss_beit, mlm_acc

        replay = StepReplay(model, (gumbel_generator,)) if use_hessian else None
        with hessian_context(replay):
            loss, loss_cyc, loss_beit, mlm_acc = loss_of()
        optimizer.zero_grad()
        loss.backward()
        hessian = None
        if replay is not None:
            hessian = replay.hessian_diag(lambda: loss_of()[0], optimizer.params,
                                          hessian_generator)
        update = state.step // hp.update_freq
        lr = lr_schedule(update)
        grad_norm = optimizer.step(lr, wd_schedule(update), hessian=hessian)
        teacher = state.model_ema
        ema_on_update_boundary(
            lambda: cyclical_ema_step(teacher, dict(model.named_parameters()), update,
                                      hp.ema_decay, hp.ema_decay_init, hp.ema_start_at,
                                      hp.start_lr_decay_at_step),
            teacher, state.step, hp.update_freq)
        state.step += 1
        return {"loss": loss.detach(), "loss_cyc": loss_cyc.detach(),
                "loss_beit": loss_beit.detach(), "mlm_acc": mlm_acc.detach(),
                "beit_weight": w, "grad_norm": grad_norm, "lr": lr}

    return step
