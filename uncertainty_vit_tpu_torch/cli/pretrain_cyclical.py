"""Cyclical (data2vec) pretraining driver: counterpart of
uncertainty_vit_tpu/cli/pretrain_cyclical.py (:38-244), which replaces the
reference's run_cyclical.py.

    python -m uncertainty_vit_tpu_torch.cli.pretrain_cyclical \
        --model beit_base_patch16_224 --data_set CIFAR100 --data_path DIR \
        --batch_size 128 --lr 2e-3 --num_mask_patches 120 --clip_grad 3.0 \
        --drop_path 0.25 --attn_drop_rate 0.05 --output_dir OUT [--stochastic] ...

The recipe (README.md:11-25 of the reference): ViT-B, 800 epochs, global
batch 2048 (16 × 128), lr 2e-3, mask 120, EMA 0.9998 from 0.999, clip 3.0,
drop-path 0.25, attention dropout 0.05, target layers 6-11.

The train split's uint8 batches go to the card a batch ahead of their step
(``device_prefetch``), each with its blockwise masks, made on the host from
the step's CPU generator (``ops.masking``); the step
(``train.engine_cyclical``) runs the pretrain transform on the card, the
EMA teacher, the masked student, AdamW with the clip and the EMA update.
The softmax of the attention is the exact max-subtracted one: the driver
sets ``BOUNDED_SCORES`` off (``cli.common.setup``), whatever another
driver in the same process set. ``--seed_model`` (an alias of
``--finetune``) seeds student and teacher from a ``.pth`` before any resume,
as the reference does (run_cyclical.py:332-460 before its auto_load_model
at :563-570). ``--auto_resume`` / ``--resume`` / ``--start_epoch`` restore
student, optimizer, step and teacher from ``checkpoint-N.pth``; log.txt
gets a record an epoch under the JAX driver's keys; ``checkpoint-N.pth``
is written every ``--save_ckpt_freq`` epochs and at the end. ``main``
takes ``device`` (the card by default; the tests pass "cpu").

``--stochastic`` pretrains the dist (mean+covariance) model (JAX :94-101,
``models.dist_vit.DistCyclicalViT``, student and teacher) with the
Wasserstein term weighted by ``--lambda_pretraining``; with it
``--gp_layer`` raises ``ValueError`` (JAX's words), and so do the flags the
dist model does not read, which the JAX driver ignores there
(``DIST_UNREAD``: ``--quant int8``, ``--abs_pos_emb``,
``--per_block_rel_pos_bias``, ``--dropout_from_block``, ``--sngp``,
``--het_layer``, the attention variants, ``--layer_results fc``).

Every --opt of the JAX make_optimizer runs; adahessian with its Hessian
pass in the step (``use_hessian``, JAX :194). A gumbel or dual_sto trunk
draws from the step's Gumbel stream.
"""

from __future__ import annotations

import argparse
import ast
import collections
from typing import Callable, Dict, Iterator

import torch

from uncertainty_vit_tpu_torch.cli import builders as B
from uncertainty_vit_tpu_torch.cli.common import setup
from uncertainty_vit_tpu_torch.cli.finetune import (
    _finish_metrics, _require_pth, _start_metrics_readback,
)
from uncertainty_vit_tpu_torch.core.config import draws_gumbel
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.data.pipeline import device_prefetch
from uncertainty_vit_tpu_torch.models.cyclical import CyclicalViT
from uncertainty_vit_tpu_torch.models.dist_vit import DistCyclicalViT
from uncertainty_vit_tpu_torch.ops import masking as M
from uncertainty_vit_tpu_torch.ops.augment import make_pretrain_augment
from uncertainty_vit_tpu_torch.train.engine_cyclical import (
    CyclicalHParams, init_cyclical_state, make_cyclical_train_step, mask_generator,
    step_generators,
)
from uncertainty_vit_tpu_torch.train.engine_finetune import optional_streams
from uncertainty_vit_tpu_torch.train.optim import needs_hessian
from uncertainty_vit_tpu_torch.utils import checkpoint as C
from uncertainty_vit_tpu_torch.utils.logging import JsonlLogger, MetricLogger, TensorboardLogger


def get_args_parser():
    p = argparse.ArgumentParser("cyclical pretraining", add_help=True)
    B.add_model_args(p)
    B.add_opt_args(p, lr=2e-3)
    B.add_data_args(p)
    B.add_mask_args(p)
    B.add_io_args(p)
    g = p.add_argument_group("cyclical")
    g.add_argument("--target_layers", type=str, default="[6,7,8,9,10,11]")
    g.add_argument("--layer_results", type=str, default="end", choices=["end", "fc"])
    g.add_argument("--l1_beta", type=float, default=2.0)
    g.add_argument("--seed_model", type=str, default="",
                   help="alias of --finetune for the pretrainer (run_cyclical.py:332)")
    g.add_argument("--l2_loss", action="store_true")
    g.add_argument("--var_w0", type=float, default=0.0)
    g.add_argument("--var_margin0", type=float, default=0.5)
    # parsed for the recipe's sake: the w1 hinge term is commented out in the
    # reference itself (engine_for_cyclical.py:142, 160)
    g.add_argument("--var_w1", type=float, default=0.0)
    g.add_argument("--var_margin1", type=float, default=0.5)
    g.add_argument("--loss_scale", type=float, default=-1.0)
    g.add_argument("--ema_decay", type=float, default=0.9998)
    g.add_argument("--ema_decay_init", type=float, default=0.999)
    g.add_argument("--ema_start_at", type=int, default=0)
    g.add_argument("--ema_annealing_till_end", action="store_true",
                   help="anneal the EMA decay over the whole run (run_cyclical.py:580-582)")
    g.add_argument("--start_lr_decay_at_step", type=int, default=-1)
    g.add_argument("--skip_ema_during_lr_decay_for_tri", action="store_true",
                   help="freeze the EMA teacher once the tri-phase decay starts "
                        "(run_cyclical.py:537-539)")
    g.add_argument("--target_layer_norm_last", default=True, type=ast.literal_eval)
    g.add_argument("--no_target_layer_norm_last", action="store_false",
                   dest="target_layer_norm_last")
    g.add_argument("--target_batch_norm", action="store_true")
    g.add_argument("--target_instance_norm", action="store_true")
    g.add_argument("--post_target_instance_norm", action="store_true")
    g.add_argument("--post_target_layer_norm", action="store_true")
    # the weight of the dist (--stochastic) model's Wasserstein term
    g.add_argument("--lambda_pretraining", type=float, default=1e-5)
    return p


# what the dist model does not read, beside builders.DIST_UNREAD: its
# teacher keeps no post-MLP residuals (the JAX model returns the block
# outputs for "fc")
DIST_UNREAD = {**B.DIST_UNREAD, "layer_results": lambda a: a.layer_results != "end"}


def build_model(args, device=None):
    """(student, config) of the flags: ``CyclicalViT`` with ``head_type``
    "none", an SNGP ``lm_head`` under --gp_layer, or under --stochastic
    ``DistCyclicalViT``; its parameters drawn from a generator seeded with
    --seed on ``device``."""
    if args.stochastic:
        if args.gp_layer:
            raise ValueError(
                "--gp_layer is only supported by the non-stochastic cyclical model "
                "(modeling_cyclical.py:133); the dist variant has no SNGP lm_head in the "
                "reference (modeling_cyclical_dist.py).")
        B.refuse_unread(args, DIST_UNREAD)
    cfg = B.model_config_from_args(args, num_classes=0).replace(head_type="none")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.stochastic:
        return DistCyclicalViT(cfg, B.compute_dtype(args), device=device, generator=gen), cfg
    model = CyclicalViT(cfg, B.compute_dtype(args), gp_layer=args.gp_layer, device=device,
                        generator=gen)
    return model, cfg


def hparams(args, steps_per_epoch: int) -> CyclicalHParams:
    """The step's knobs from the flags. The thresholds of
    --skip_ema_during_lr_decay_for_tri and --ema_annealing_till_end are
    counted in mini-steps, as the JAX driver counts them (:107-119); the
    EMA rule compares them with the update index (ROADMAP.md §3)."""
    start_lr_decay_at_step = args.start_lr_decay_at_step
    if args.tri_phase_schedule and args.skip_ema_during_lr_decay_for_tri:
        _, decay_perc = ast.literal_eval(args.tri_phase_schedule)
        start_lr_decay_at_step = int((1 - decay_perc) * args.epochs * steps_per_epoch)
        print(f"ema will be skipped after {start_lr_decay_at_step} updates", flush=True)
    ema_start_at = args.ema_start_at
    if args.ema_annealing_till_end:
        ema_start_at = args.epochs * steps_per_epoch
        print("EMA annealing till the end activated", flush=True)
    return CyclicalHParams(
        target_layers=tuple(ast.literal_eval(args.target_layers)),
        layer_results=args.layer_results, l1_beta=args.l1_beta, l2_loss=args.l2_loss,
        var_w0=args.var_w0, var_margin0=args.var_margin0, loss_scale=args.loss_scale,
        mask_dropout_prob=args.mask_dropout_prob,
        target_layer_norm_last=args.target_layer_norm_last,
        target_batch_norm=args.target_batch_norm,
        target_instance_norm=args.target_instance_norm,
        post_target_instance_norm=args.post_target_instance_norm,
        post_target_layer_norm=args.post_target_layer_norm,
        ema_decay=args.ema_decay, ema_decay_init=args.ema_decay_init, ema_start_at=ema_start_at,
        start_lr_decay_at_step=start_lr_decay_at_step, stochastic=args.stochastic,
        lambda_pretraining=args.lambda_pretraining, gp_layer=args.gp_layer,
        update_freq=max(1, args.update_freq),
    )


def seed_from_pth(args, model: CyclicalViT) -> None:
    """--finetune / --seed_model: a reference or port ``.pth`` into the
    student (``utils.checkpoint.import_torch_state_dict``'s rules). Any
    other path raises: the JAX pretrainers read a ``.pth`` there and
    silently ignore anything else (uncertainty_vit_tpu/cli/
    pretrain_cyclical.py:165, pretrain_joint.py:80; ROADMAP.md §3)."""
    if not args.finetune.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"--finetune / --seed_model {args.finetune!r}: the pretrainers seed from a .pth only "
            "(the JAX pretrainers ignore any other path); tools/torch_port_orbax_to_pth.py "
            "turns an orbax checkpoint of the JAX package into one")
    state, missing, unused = C.import_torch_state_dict(C.load_torch_state_dict(args.finetune),
                                                       model.state_dict())
    model.load_state_dict(state, strict=True)
    params = dict(model.named_parameters())
    missing = [k for k in missing if k in params]
    print(f"seeded from {args.finetune}: {len(missing)} missing, {len(unused)} unused",
          flush=True)


class MaskedBatches:
    """The loader's host batches, each with its blockwise masks [B,
    num_patches] (numpy f32) appended, made from the CPU generator of its
    step, first_step + i. Keeps the loader's ``len``."""

    def __init__(self, loader, args, first_step: int, grid):
        self.loader, self.args, self.first_step, self.grid = loader, args, first_step, grid

    def __len__(self):
        return len(self.loader)

    def __iter__(self) -> Iterator[tuple]:
        a = self.args
        for i, batch in enumerate(self.loader):
            masks = M.make_blockwise_masks(mask_generator(a.seed, self.first_step + i),
                                           len(batch[0]), self.grid, a.num_mask_patches,
                                           a.min_mask_patches_per_block,
                                           a.max_mask_patches_per_block)
            yield (*batch, masks)


def train_epochs(args, state, loader, steps_per_epoch: int, grid, device, start_epoch: int,
                 run_step: Callable[..., Dict[str, object]], tb_heads: Dict[str, tuple],
                 log_prefix: str = "") -> None:
    """The epochs of a pretraining driver (this one's, the BEiT ones' and
    the dVAE trainer's): each step's uint8 batch, with its host masks
    (``MaskedBatches``) over the patch grid ``grid`` unless that is None,
    through ``run_step(epoch, state, images_u8, masks, generators,
    valid_hw)`` (masks None without a grid), its metrics read back 2 steps
    behind (the JAX driver's 2-deep window; a NaN stops the run within two
    steps, reported at its global step), a log.txt record an epoch (its
    metric names after ``log_prefix``), checkpoints. ``tb_heads``:
    TensorBoard head → metric names; none, and no TensorBoard writer."""
    tb = TensorboardLogger((args.log_dir or args.output_dir) if tb_heads else None)
    jsonl = JsonlLogger(args.output_dir)
    masked = grid is not None
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        logger = MetricLogger()
        pending: "collections.deque" = collections.deque()
        step_base = state.step

        def drain_one():
            m, global_step = pending.popleft()
            m = _finish_metrics(m)
            B.check_finite_or_die(m["loss"], global_step)
            logger.update(**m)
            for head, names in tb_heads.items():
                tb.update(head=head, **{k: m[k] for k in names})
            tb.set_step()

        batches = device_prefetch(
            MaskedBatches(loader, args, step_base, grid) if masked else loader, device)
        for step, batch in enumerate(logger.log_every(batches, 10, f"Epoch: [{epoch}]")):
            if step >= steps_per_epoch:
                break
            images_u8, masks = batch[0], (batch[-1] if masked else None)
            # letterboxed batches carry each image's valid extent
            # (--decode_letterbox), so that the crop covers the whole image
            valid_hw = batch[1] if len(batch) == 3 + masked else None
            # (the dVAE trainer's model has no ViT config and draws neither)
            gens = step_generators(args.seed, state.step, device,
                                   gumbel=draws_gumbel(getattr(state.model, "cfg", None)),
                                   hessian=needs_hessian(getattr(args, "opt", None)))
            metrics = run_step(epoch, state, images_u8, masks, gens, valid_hw)
            pending.append((_start_metrics_readback(metrics), step_base + step))
            while len(pending) > 2:
                drain_one()
        while pending:
            drain_one()
        jsonl.write({"epoch": epoch,
                     **{f"{log_prefix}{k}": v for k, v in logger.epoch_summary().items()}})
        if args.save_ckpt and args.output_dir and (
                (epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs):
            C.save_checkpoint(args.output_dir, epoch, state, epoch)
        tb.flush()


def main(args, device=None):
    """Pretrain on ``device`` (the card unless the caller asks for the CPU);
    returns the train state (``train.engine_cyclical.CyclicalState``)."""
    # pretraining from scratch keeps the exact max-subtracted softmax
    setup(bounded_scores_default=False)
    B.validate_aug_args(args)
    if args.device != "cuda":
        raise NotImplementedError(
            f"--device {args.device}: the driver runs on the one card ('cuda'); the CPU is "
            "main(args, device='cpu'), for tests")
    if args.seed_model and not args.finetune:
        args.finetune = args.seed_model
    device = resolve_device(device)
    print(f"device: {device}", flush=True)

    loader, _ = B.build_loaders(args, is_train=True, letterbox_ok=True)
    steps_per_epoch = args.steps_per_epoch or len(loader)
    model, cfg = build_model(args, device)
    hp = hparams(args, steps_per_epoch)
    lr_schedule, wd_schedule, total_steps = B.build_lr_schedules(args, steps_per_epoch)
    n_params = sum(p.numel() for p in model.parameters()) / 1e6
    print(f"model: {args.model} ({n_params:.1f}M params), steps/epoch {steps_per_epoch}, "
          f"total {total_steps}", flush=True)
    if args.finetune:
        seed_from_pth(args, model)
    optimizer = B.build_optimizer(args, model, cfg.depth)
    state = init_cyclical_state(model, optimizer)

    start_epoch = args.start_epoch
    if args.auto_resume and not args.resume:
        state, resumed_epoch = C.auto_load(args.output_dir, state)
        start_epoch = max(start_epoch, resumed_epoch)
        if resumed_epoch:
            print(f"auto-resumed from epoch {resumed_epoch}", flush=True)
    elif args.resume:
        _require_pth(args.resume, "--resume")
        C.restore_checkpoint(args.resume, state)
    if start_epoch and state.step == 0:
        state.step = start_epoch * steps_per_epoch

    aug_fn = make_pretrain_augment(
        args.input_size, args.aug_level,
        imagenet_default_mean_and_std=args.imagenet_default_mean_and_std,
        color_jitter_strength=args.color_jitter)
    train_step = make_cyclical_train_step(model, optimizer, hp, lr_schedule, wd_schedule, aug_fn,
                                          use_hessian=needs_hessian(args.opt))

    def run_step(epoch, state, images_u8, masks, gens, valid_hw):
        return train_step(state, images_u8, masks, gens.model, gens.augment, valid_hw,
                          **optional_streams(gens))

    train_epochs(args, state, loader, steps_per_epoch, cfg.grid_size, device, start_epoch,
                 run_step, {"loss": ("loss",), "opt": ("lr", "grad_norm")}, log_prefix="train_")
    print("done.", flush=True)
    return state


if __name__ == "__main__":
    main(get_args_parser().parse_args())
