"""Supervised finetune engine: the train step.

Counterpart of uncertainty_vit_tpu/train/engine_finetune.py:25-182
(engine_for_finetuning.py:46-220 of the reference):
optionally the train augmentation of a uint8 batch on the device (``aug_fn``)
→ mixup/cutmix on the device → a bf16 forward on f32 parameters in train
mode, optionally with on-the-fly token masking → soft-target CE in f32 →
backward (through the attention kernels on the card) → AdamW with layer
decay, optionally accumulating ``update_freq`` mini-steps' gradients per
update (optax.MultiSteps) → optional EMA on the update boundaries. Every
random draw comes from a generator the caller passes; ``step_generators``
makes them from (seed, step), as the JAX step folds the step into its key,
so that a resumed run draws what an uninterrupted one draws.

Every head type runs (JAX :84-158): the SNGP head's step updates its
precision matrix, and the spectral fc_norm's (u, v), inside the forward,
once per mini-step; the heteroscedastic head draws its MC noise from a
fourth generator (``StepGenerators.mc``, made for that head only). The EMA
covers the parameters
only, not those buffers (JAX :143-148). A gumbel or dual_sto attention
draws its noise from a fifth (``StepGenerators.gumbel``).

``use_hessian`` (``optim.needs_hessian``, adahessian; JAX :71-76, 138-140):
after the step's backward, which keeps the kernels, the Hessian pass
recomputes the loss on the step's own draws inside
``flash_attention.plain_only()`` (``optim.StepReplay``) and hands the
Hutchinson estimate, from a sixth generator (``StepGenerators.hessian``),
to the optimizer.

A model built on a ``parallel.mesh.Mesh`` (``model.mesh``) takes this
rank's rows of the global batch (the data axis) and generators of the same
seeds on every rank: mixup draws for the global batch and exchanges the
partners over the data axis, the masking draws for the global batch, the
loss and the accuracy are the global batch's, and the optimizer sums the
gradient shares (``parallel.mesh.grad_reducer``) before it reads them.
The AdaHessian pass runs on a mesh's data and seq axes: z is the same on
every rank (replicated parameters, a generator of one seed), and each
rank's share of D is summed over the groups as its gradient is (``optim``
takes the sums); under a model axis it raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.core.config import HEAD_TYPES
from uncertainty_vit_tpu_torch.ops import losses as L
from uncertainty_vit_tpu_torch.ops.mixup import mixup_cutmix, one_hot_smooth
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
from uncertainty_vit_tpu_torch.train.ema import ema_on_update_boundary, ema_update
from uncertainty_vit_tpu_torch.train.optim import Optimizer, StepReplay
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
    # on-the-fly token masking (engine_for_finetuning.py:80-82)
    masked_position_prob: float = 0.0
    model_ema_decay: float = 0.9999
    head_type: str = "linear"
    # gradient accumulation: the optimizer's; the EMA and the schedules count
    # updates (engine_for_finetuning.py:66, 110-127)
    update_freq: int = 1


@dataclasses.dataclass
class FinetuneState:
    """The model (f32 parameters), its optimizer, the number of mini-steps
    taken (updates × update_freq), and an optional EMA copy of the
    parameters."""

    model: nn.Module
    optimizer: Optimizer
    step: int = 0
    model_ema: Optional[Dict[str, torch.Tensor]] = None


def init_finetune_state(model: nn.Module, optimizer: Optimizer,
                        use_model_ema: bool = False) -> FinetuneState:
    ema = ({k: p.detach().clone() for k, p in model.named_parameters()}
           if use_model_ema else None)
    return FinetuneState(model=model, optimizer=optimizer, model_ema=ema)


def _targets(hp: FinetuneHParams, images: torch.Tensor, labels: torch.Tensor,
             mix_generator: Optional[torch.Generator], mesh=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images, soft targets) as the train step feeds them to the model."""
    if hp.mixup_active:
        if mix_generator is None:
            raise ValueError("mixup draws from an explicit mix_generator")
        return mixup_cutmix(
            mix_generator, images, labels, hp.num_classes, hp.mixup_alpha, hp.cutmix_alpha,
            hp.mixup_prob, hp.mixup_switch_prob, hp.label_smoothing,
            mode=hp.mixup_mode, cutmix_minmax=hp.cutmix_minmax, mesh=mesh,
        )
    if hp.label_smoothing > 0 and hp.criterion == "smooth":
        return images, one_hot_smooth(labels, hp.num_classes, hp.label_smoothing)
    return images, F.one_hot(labels, hp.num_classes).float()


@dataclasses.dataclass
class StepGenerators:
    """One train step's generators: the model's draws (drop-path, dropout,
    int8 rounding) and the augmentation's on the device, mixup's six scalars
    on the CPU (drawn there without a device sync), and on the device, where
    the run needs them: the heteroscedastic head's MC noise (the JAX step's
    r_mc), the Gumbel noise of a gumbel or dual_sto attention, and the
    AdaHessian pass's draws."""

    model: torch.Generator
    augment: torch.Generator
    mix: torch.Generator
    mc: Optional[torch.Generator] = None
    gumbel: Optional[torch.Generator] = None
    hessian: Optional[torch.Generator] = None


def step_seeds(seed: int, step: int) -> list:
    """Six generator seeds of train step ``step`` of a run seeded with
    ``seed``: a function of (seed, step) only (the JAX step's
    fold_in(rng, step)). ``generate_state`` is prefix-stable, so the first
    four are those of the four-seed stream before the Gumbel and Hessian
    seeds were added."""
    seeds = np.random.SeedSequence([seed, step]).generate_state(6, np.uint64)
    return [int(s) & (2**63 - 1) for s in seeds]


def step_generators(seed: int, step: int, device, het: bool = False, gumbel: bool = False,
                    hessian: bool = False) -> StepGenerators:
    """The generators of train step ``step`` of a run seeded with ``seed``
    (``step_seeds``), with ``mc`` for a heteroscedastic head (``het``),
    ``gumbel`` for a model that draws Gumbel noise and ``hessian`` for the
    AdaHessian pass. The first three seeds are those of the three-generator
    stream before the others were added, so the other draws of a step did
    not change."""
    seeds = step_seeds(seed, step)
    device = torch.device(device)

    def on_device(i: int, wanted: bool = True) -> Optional[torch.Generator]:
        return torch.Generator(device=device).manual_seed(seeds[i]) if wanted else None

    return StepGenerators(on_device(0), on_device(1), torch.Generator().manual_seed(seeds[2]),
                          on_device(3, het), on_device(4, gumbel), on_device(5, hessian))


def optional_streams(gens) -> Dict[str, torch.Generator]:
    """A step's keyword generators that the run draws from, of a
    ``StepGenerators`` or the cyclical engine's: ``gumbel_generator`` and
    ``hessian_generator`` where they are made."""
    return {f"{k}_generator": g for k, g in (("gumbel", gens.gumbel), ("hessian", gens.hessian))
            if g is not None}


def hessian_context(replay: Optional[StepReplay]):
    """The recording of a step's forward for its Hessian pass, or nothing."""
    return contextlib.nullcontext() if replay is None else replay.recording()


def refuse_hessian_when_sharded(model: nn.Module, use_hessian: bool, mesh_ok: bool = False
                                ) -> None:
    """The AdaHessian pass raises on a sharded model; with ``mesh_ok`` (the
    finetune and dist engines) a mesh's data and seq axes run it (every
    collective of their losses is twice differentiable) and a model axis
    raises."""
    if not use_hessian:
        return
    mesh = getattr(model, "mesh", None)
    sharded = (meshlib.active(mesh, meshlib.MODEL_AXIS) if mesh_ok
               else getattr(model, "seq_group", None) is not None or mesh is not None)
    if sharded:
        what = "a mesh's model axis" if mesh_ok else "a seq group or a mesh"
        raise NotImplementedError(f"the AdaHessian pass under {what} is not ported "
                                  "(ROADMAP.md item 21)")


def global_accuracy(logits: torch.Tensor, targets: torch.Tensor, mesh=None) -> torch.Tensor:
    """argmax(logits) == argmax(targets), the mean over the global batch."""
    with torch.no_grad():
        hits = (logits.argmax(-1) == targets.argmax(-1)).float()
        if mesh is None:
            return hits.mean()
        return meshlib.reduce_value(hits.sum(), mesh) / (
            hits.numel() * mesh.size(meshlib.DATA_AXIS))


def make_finetune_train_step(
    model: nn.Module,
    optimizer: Optimizer,
    hp: FinetuneHParams,
    lr_schedule: Schedule,
    wd_schedule: Optional[Schedule] = None,
    aug_fn: Optional[Callable[..., torch.Tensor]] = None,
    use_hessian: bool = False,
) -> Callable[..., Dict[str, object]]:
    """Returns step(state, images, labels, generator, mix_generator=None,
    aug_generator=None, valid_hw=None, mc_generator=None,
    gumbel_generator=None, hessian_generator=None) → metrics
    {"loss", "class_acc", "grad_norm", "lr"}; the state (model, optimizer,
    EMA, step) is updated in place.

    ``generator`` lies on the model's device and draws the drop-path and
    dropout masks; ``mix_generator`` (a CPU generator keeps its six scalar
    draws free of device syncs) draws mixup. With ``aug_fn`` the images are
    the raw uint8 batch on the device, and aug_fn(aug_generator, images,
    valid_hw) makes the normalized f32 images first (JAX :88-90; valid_hw:
    the letterboxed extents, [B, 2], or None). With
    ``hp.masked_position_prob`` > 0 the step draws a Bernoulli mask
    [B, num_patches] from ``generator`` after mixup (JAX :105-109) and the
    model blends its mask token into those patches. With ``hp.update_freq``
    k > 1 (the optimizer's own) the parameters move on every k-th call only,
    from the mean of the k calls' gradients; each call reports its own
    gradient's norm (a model on a mesh's data axis: the window mean's on
    the k-th call, None on the others; see ``optim.LayerDecayAdamW``). lr
    and wd are read at the update index, step // k, as the optax schedules
    count updates. ``wd_schedule`` defaults to the optimizer's constant
    weight decay. Nothing in the step reads a value back to the host.

    A model built with a ``seq_group`` holds each image's tokens split over
    the group's ranks: every rank calls the step on the same batch with
    generators of the same seeds, and the optimizer sums the gradients of
    ``model.token_parameters()`` over the group before it reads them
    (``parallel.mesh.grad_reducer``), what GSPMD does for the reference's step
    (tests/test_seq_parallel.py:58-92).

    ``hp.head_type`` "sngp": the forward runs with ``update_sngp_cov``, so
    the precision matrix and the spectral fc_norm's (u, v) move once per
    call. "het": the head's noise comes from ``mc_generator`` (required),
    at its test sample count, as the JAX step passes
    ``training=update_sngp_cov`` (False for this head) to it.

    A gumbel or dual_sto attention draws from ``gumbel_generator``. With
    ``use_hessian`` the step runs the AdaHessian pass (see the module's
    docstring), its z and attention-dropout masks from
    ``hessian_generator`` (required); on a mesh's data and seq axes too (the
    same z on every rank), not under its model axis.

    A model built on a mesh takes this rank's rows of the global batch
    (see the module's docstring)."""
    refuse_hessian_when_sharded(model, use_hessian, mesh_ok=True)
    if hp.update_freq != optimizer.update_freq:
        raise ValueError(f"update_freq {hp.update_freq} is not the optimizer's "
                         f"{optimizer.update_freq}")
    if hp.masked_position_prob > 0 and getattr(model, "mask_token", None) is None:
        raise ValueError("masked_position_prob > 0 needs a model with cfg.has_masking")
    if hp.head_type not in HEAD_TYPES:
        raise ValueError(f"unknown head_type: {hp.head_type}")
    use_sngp = hp.head_type == "sngp"
    wd_schedule = wd_schedule or constant_schedule(optimizer.weight_decay)
    mesh = getattr(model, "mesh", None)

    def step(state: FinetuneState, images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator, mix_generator: Optional[torch.Generator] = None,
             aug_generator: Optional[torch.Generator] = None,
             valid_hw: Optional[torch.Tensor] = None,
             mc_generator: Optional[torch.Generator] = None,
             gumbel_generator: Optional[torch.Generator] = None,
             hessian_generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        if aug_fn is not None:
            if aug_generator is None:
                raise ValueError("the train augmentation draws from an explicit aug_generator")
            images = aug_fn(aug_generator, images, valid_hw)
        images, targets = _targets(hp, images, labels, mix_generator, mesh)
        bool_masked_pos = None
        if hp.masked_position_prob > 0:
            shape = (images.shape[0], model.cfg.num_patches)
            bool_masked_pos = (meshlib.rand_rows(shape, generator, images.device,
                                                 meshlib.data_rows(mesh, shape[0]))
                               < hp.masked_position_prob).float()
        model.train()

        def loss_of():
            logits = model(images, generator=generator, bool_masked_pos=bool_masked_pos,
                           update_sngp_cov=use_sngp, mc_generator=mc_generator,
                           gumbel_generator=gumbel_generator)
            return L.soft_target_cross_entropy(logits, targets, mesh), logits

        replay = StepReplay(model, (gumbel_generator, mc_generator)) if use_hessian else None
        with hessian_context(replay):
            loss, logits = loss_of()
        optimizer.zero_grad()
        loss.backward()
        hessian = None
        if replay is not None:
            hessian = replay.hessian_diag(lambda: loss_of()[0], optimizer.params,
                                          hessian_generator)
        update = state.step // hp.update_freq
        lr = lr_schedule(update)
        grad_norm = optimizer.step(lr, wd_schedule(update), hessian=hessian)
        if state.model_ema is not None:
            state.model_ema = ema_on_update_boundary(
                lambda: ema_update(state.model_ema, dict(model.named_parameters()),
                                   hp.model_ema_decay),
                state.model_ema, state.step, hp.update_freq,
            )
        state.step += 1
        acc = global_accuracy(logits, targets, mesh)
        return {"loss": loss.detach(), "class_acc": acc, "grad_norm": grad_norm, "lr": lr}

    return step
