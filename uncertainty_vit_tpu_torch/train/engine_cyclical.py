"""Cyclical (data2vec) pretraining engine: the train step.

Counterpart of uncertainty_vit_tpu/train/engine_cyclical.py
(``CyclicalHParams`` :38-71, ``build_targets`` :97-122,
``make_cyclical_train_step`` :125-271; engine_for_cyclical.py:45-219 of
the reference): optionally the pretrain transform of a uint8 batch on the
device (``aug_fn``) → the teacher's forward on the EMA weights (no
gradient, deterministic, unmasked, every layer) → the target pipeline in
f32 → mask dropout → the masked student forward through ``lm_head``, with
drop-path and (attention) dropout drawn from the step's generator →
smooth-L1 (or squared error) at the masked positions, plus var_w0 times
the variance hinge, times loss_scale → backward (through the attention
kernels on the card) → AdamW with the clip, accumulating ``update_freq``
mini-steps an update → the EMA teacher on the update boundaries, at the
update index. With ``gp_layer`` the student's forward updates its SNGP
precision matrix once a mini-step.

The teacher is a second ``CyclicalViT`` whose parameters are the EMA
tensors: it is not in the optimizer, its parameters need no gradient, and
it holds none of the student's storage. Nothing in the step reads a value
back to the host.

``stochastic`` is the dist variant (JAX :61-63, 167-183, 200-224): student
and teacher are ``models.dist_vit.DistCyclicalViT``; the teacher's mean
layers make the targets through the whole pipeline, its cov layers the cov
targets through the layer-norm stages only (no batch or instance norm);
the loss adds λ_pretraining × ``wasserstein_pretrain_loss`` over the
flattened rows at the masked positions, before ``loss_scale``.

A gumbel or dual_sto trunk draws its noise (teacher first, then student)
from the step's ``gumbel_generator``. ``use_hessian`` (adahessian; JAX
:132, 233-235) runs the AdaHessian pass after the backward, as the
finetune step does (``engine_finetune``): the student's loss again on the
step's draws, inside ``flash_attention.plain_only()``.

A student built on a ``parallel.mesh.Mesh`` (``model.mesh``; the teacher
is its copy and sharded alike) takes this rank's rows of the global batch
and its masks, and generators of the same seeds on every rank: the mask
dropout draws for the global batch, the targets' batch norm takes its
statistics over the global (B, T) and the instance norms over all of T,
the losses divide by the global mask count, and the optimizer sums the
gradient shares before it reads them. Under the mesh's seq axis each
rank holds its token rows of the outputs, targets and masks.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from uncertainty_vit_tpu_torch.ops import losses as L
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
from uncertainty_vit_tpu_torch.train.ema import cyclical_ema_step, ema_on_update_boundary
from uncertainty_vit_tpu_torch.train.engine_finetune import (
    hessian_context, refuse_hessian_when_sharded, step_seeds,
)
from uncertainty_vit_tpu_torch.train.optim import Optimizer, StepReplay
from uncertainty_vit_tpu_torch.train.schedules import Schedule, constant_schedule


@dataclasses.dataclass(frozen=True)
class CyclicalHParams:
    """Knobs of engine_for_cyclical.train_one_epoch (engine_for_cyclical.py:24-32)."""

    target_layers: Tuple[int, ...] = (6, 7, 8, 9, 10, 11)
    layer_results: str = "end"  # 'end' | 'fc'
    l1_beta: float = 2.0
    l2_loss: bool = False
    var_w0: float = 0.0
    var_margin0: float = 0.5
    loss_scale: float = -1.0
    mask_dropout_prob: float = -1.0
    # the target normalization ladder (engine_for_cyclical.py:94-118)
    target_layer_norm_last: bool = True
    target_batch_norm: bool = False
    target_instance_norm: bool = False
    post_target_instance_norm: bool = False
    post_target_layer_norm: bool = False
    # the EMA teacher (the recipe: decay 0.9998, init 0.999, start 0)
    ema_decay: float = 0.9998
    ema_decay_init: float = 0.999
    ema_start_at: int = 0
    start_lr_decay_at_step: int = -1
    # the stochastic (dist) variant
    stochastic: bool = False
    lambda_pretraining: float = 1e-5
    # the SNGP lm_head (--gp_layer, modeling_cyclical.py:133)
    gp_layer: bool = False
    # gradient accumulation: the optimizer's; the EMA's warm-up, its
    # cadence and the reported lr count updates
    update_freq: int = 1


def _normalized(x: torch.Tensor, dims: Sequence[int], eps: float = 1e-5, mesh=None,
                axes: Sequence[str] = ()) -> torch.Tensor:
    """(x − mean) / sqrt(var + eps) over ``dims``, the variance biased, in
    f32; over the rows of every rank of ``axes`` of ``mesh`` (no gradient)."""
    x = x.float()
    axes = [a for a in axes if meshlib.active(mesh, a)]
    if not axes:
        var, mean = torch.var_mean(x, dim=tuple(dims), correction=0, keepdim=True)
        return (x - mean) / torch.sqrt(var + eps)
    count = 1
    for d in dims:
        count *= x.shape[d]
    n = meshlib.reduce_value(x.new_full((), count), mesh, axes)
    mean = meshlib.reduce_value(x.sum(dim=tuple(dims), keepdim=True), mesh, axes) / n
    var = meshlib.reduce_value(((x - mean) ** 2).sum(dim=tuple(dims), keepdim=True), mesh,
                               axes) / n
    return (x - mean) / torch.sqrt(var + eps)


def build_targets(layer_outputs: Sequence[torch.Tensor], hp: CyclicalHParams, mesh=None,
                  token_sharded: bool = False) -> torch.Tensor:
    """The teacher's targets (engine_for_cyclical.py:90-118): the chosen
    layers [B, T, C] in f32; each batch-normed (over B and T a channel,
    F.batch_norm in [B, C, T] in training without running stats) and/or
    instance-normed (over T, F.instance_norm in [B, C, T]); each
    layer-normed over C (no affine, eps 1e-5); their mean; then optionally
    instance- and layer-normed again. Returns [B, T, C] f32. Under ``mesh``
    B is this rank's rows of the batch and, ``token_sharded``, T its token
    rows: the statistics are the global (B, T)'s and all of T's."""
    over_t = ("seq",) if token_sharded else ()
    over_bt = ("data",) + over_t
    vals = [layer_outputs[i].float() for i in hp.target_layers]
    if hp.target_batch_norm:
        vals = [_normalized(v, (0, 1), mesh=mesh, axes=over_bt) for v in vals]
    if hp.target_instance_norm:
        vals = [_normalized(v, (1,), mesh=mesh, axes=over_t) for v in vals]
    if hp.target_layer_norm_last:
        vals = [_normalized(v, (-1,)) for v in vals]
    targets = sum(vals) / len(hp.target_layers)
    if hp.post_target_instance_norm:
        targets = _normalized(targets, (1,), mesh=mesh, axes=over_t)
    if hp.post_target_layer_norm:
        targets = _normalized(targets, (-1,))
    return targets


@dataclasses.dataclass
class CyclicalState:
    """The student (f32 parameters), its optimizer, the EMA teacher and the
    number of mini-steps taken (updates × update_freq). ``model_ema`` is the
    teacher's parameters by name: a checkpoint's "model_ema" (reading it
    gives the teacher's tensors, assigning it copies values into them)."""

    model: nn.Module
    optimizer: Optimizer
    teacher: nn.Module
    step: int = 0

    @property
    def model_ema(self) -> Dict[str, torch.Tensor]:
        return dict(self.teacher.named_parameters())

    @model_ema.setter
    def model_ema(self, tensors: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for name, p in self.teacher.named_parameters():
                p.copy_(tensors[name])


def init_cyclical_state(model: nn.Module, optimizer: Optimizer) -> CyclicalState:
    """The state whose teacher starts as a copy of the student's weights
    (timm ModelEmaV2 at run_cyclical.py:503)."""
    teacher = copy.deepcopy(model).requires_grad_(False)
    return CyclicalState(model=model, optimizer=optimizer, teacher=teacher)


@dataclasses.dataclass
class CyclicalGenerators:
    """One train step's generators: the student's draws (drop-path, dropout
    and attention-dropout seeds) and the mask dropout on the device, the
    pretrain transform's on the device, and the blockwise masks' on the CPU
    (``ops.masking``, made on the host); where the run needs them, the
    Gumbel noise's and the AdaHessian pass's on the device."""

    model: torch.Generator
    augment: torch.Generator
    mask: torch.Generator
    gumbel: Optional[torch.Generator] = None
    hessian: Optional[torch.Generator] = None


def mask_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s blockwise masks."""
    return torch.Generator().manual_seed(step_seeds(seed, step)[2])


def step_generators(seed: int, step: int, device, gumbel: bool = False,
                    hessian: bool = False) -> CyclicalGenerators:
    """The generators of train step ``step`` of a run seeded with ``seed``, a
    function of (seed, step) only (``train.engine_finetune.step_seeds``), so
    that a resumed run draws what an uninterrupted one draws; ``gumbel`` and
    ``hessian`` add those streams (seeds 4 and 5, as the finetune step's)."""
    seeds = step_seeds(seed, step)
    device = torch.device(device)

    def on_device(i: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(seeds[i])

    return CyclicalGenerators(on_device(0), on_device(1), mask_generator(seed, step),
                              on_device(4) if gumbel else None,
                              on_device(5) if hessian else None)


def make_cyclical_train_step(
    model: nn.Module,
    optimizer: Optimizer,
    hp: CyclicalHParams,
    lr_schedule: Schedule,
    wd_schedule: Optional[Schedule] = None,
    aug_fn: Optional[Callable[..., torch.Tensor]] = None,
    use_hessian: bool = False,
) -> Callable[..., Dict[str, object]]:
    """Returns step(state, images, bool_masked_pos, generator,
    aug_generator=None, valid_hw=None, gumbel_generator=None,
    hessian_generator=None) → metrics {"loss", "loss_cyc",
    "loss_var0", "grad_norm", "mask_count", "lr"}; the state (student,
    optimizer, teacher, step) is updated in place.

    images: normalized [B, H, W, C], or with ``aug_fn`` the raw uint8 batch,
    which aug_fn(aug_generator, images, valid_hw) makes into images first.
    bool_masked_pos: [B, num_patches] in {0, 1} on the images' device.
    ``generator`` (on the model's device) draws the mask dropout's
    Bernoulli keep mask [B, num_patches] (kept where u < 1 − p), then the
    student's drop-path and dropout masks and attention-dropout seeds. lr,
    wd and the EMA's decay are read at the update index, step //
    update_freq; the EMA runs where an update ends. ``model`` is
    ``state.model``."""
    if hp.stochastic and hp.gp_layer:
        raise ValueError("the dist cyclical model has no SNGP lm_head (gp_layer)")
    if hp.update_freq != optimizer.update_freq:
        raise ValueError(f"update_freq {hp.update_freq} is not the optimizer's "
                         f"{optimizer.update_freq}")
    refuse_hessian_when_sharded(model, use_hessian)
    wd_schedule = wd_schedule or constant_schedule(optimizer.weight_decay)
    mesh = getattr(model, "mesh", None)
    shard = getattr(model, "seq_shard", None)
    # the losses' rows: the batch's over data, and the tokens' over seq
    axes = ("data", "seq") if shard is not None else ("data",)

    def step(state: CyclicalState, images: torch.Tensor, bool_masked_pos: torch.Tensor,
             generator: torch.Generator, aug_generator: Optional[torch.Generator] = None,
             valid_hw: Optional[torch.Tensor] = None,
             gumbel_generator: Optional[torch.Generator] = None,
             hessian_generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        if aug_fn is not None:
            if aug_generator is None:
                raise ValueError("the pretrain transform draws from an explicit aug_generator")
            images = aug_fn(aug_generator, images, valid_hw)
        mask = bool_masked_pos.float()
        if hp.mask_dropout_prob > 0:
            keep = meshlib.rand_rows(mask.shape, generator, mask.device,
                                     meshlib.data_rows(mesh, mask.shape[0]))
            mask = (keep < 1.0 - hp.mask_dropout_prob).float() * mask
        # the mask of this rank's patch rows (tokens [start, stop) hold
        # patches [start − 1, stop − 1) past the cls token)
        rows = mask if shard is None else mask[:, max(shard.start, 1) - 1:shard.stop - 1]
        # a Gumbel trunk's noise (the dist model has no variant and takes none)
        gkw = {} if gumbel_generator is None else {"gumbel_generator": gumbel_generator}
        # the teacher: EMA weights, all tokens, all layers, no gradient
        # (engine_for_cyclical.py:68-88)
        with torch.no_grad():
            teacher_out = state.teacher(images, None, deterministic=True,
                                        layer_results=hp.layer_results, **gkw)
            if hp.stochastic:
                mean_layers, cov_layers = teacher_out
                targets = build_targets(mean_layers, hp, mesh)
                # the cov targets take only the layer-norm stages
                # (engine_for_cyclical.py:73-86)
                cov_targets = build_targets(cov_layers, dataclasses.replace(
                    hp, target_batch_norm=False, target_instance_norm=False,
                    post_target_instance_norm=False))
            else:
                targets = build_targets(teacher_out, hp, mesh, shard is not None)
        model.train()

        def loss_of():
            if hp.stochastic:
                out, cov_out = (t.float() for t in model(images, mask, generator=generator))
            else:
                out = model(images, mask, generator=generator, update_sngp_cov=hp.gp_layer,
                            **gkw).float()
            loss_cyc = L.masked_regression_loss(out, targets, rows, beta=hp.l1_beta,
                                                l2=hp.l2_loss, mesh=mesh, axes=axes)
            loss_var0 = (L.masked_variance_hinge(out, rows, hp.var_margin0, mesh=mesh, axes=axes)
                         if hp.var_w0 > 0 else torch.zeros((), device=out.device))
            loss = loss_cyc + loss_var0 * hp.var_w0
            if hp.stochastic:
                c = out.shape[-1]
                loss = loss + L.wasserstein_pretrain_loss(
                    out.reshape(-1, c), cov_out.reshape(-1, c), targets.reshape(-1, c),
                    cov_targets.reshape(-1, c), hp.lambda_pretraining, mask=rows, mesh=mesh)
            if hp.loss_scale != -1:
                loss = loss * hp.loss_scale
            return loss, loss_cyc, loss_var0

        replay = StepReplay(model, (gumbel_generator,)) if use_hessian else None
        with hessian_context(replay):
            loss, loss_cyc, loss_var0 = loss_of()
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
                "loss_var0": loss_var0.detach(), "grad_norm": grad_norm,
                "mask_count": meshlib.reduce_value(mask.sum(), mesh) / (
                    mask.shape[0] * (1 if mesh is None else mesh.size("data"))), "lr": lr}

    return step
