"""Supervised finetune / evaluation driver: counterpart of
uncertainty_vit_tpu/cli/finetune.py, which replaces the reference's
run_class_finetuning.py.

    python -m uncertainty_vit_tpu_torch.cli.finetune \
        --finetune CKPT.pth --data_set CIFAR100 --data_path DIR --output_dir OUT ...
    python -m uncertainty_vit_tpu_torch.cli.finetune --eval \
        [--mc_dropout | --ensembles --ensemble_checkpoints A.pth B.pth] \
        --finetune CKPT.pth --data_set CIFAR100 --data_path DIR ...

Ported: the train loop (``main`` without ``--eval``, JAX :580-790): the
train split's uint8 batches onto the device, the train transform there
(random resized crop, flip, RandAugment or colour jitter, erasing), mixup
in batch, elem or pair mode (with ``--cutmix_minmax``), on-the-fly token
masking (``--masked_position_prob``), AdamW with layer decay and its
schedules, gradient accumulation (``--update_freq``), --linear_classifier
freezing, --finetune / --resume / --auto_resume / --start_epoch, the 2-deep
deferred readback of the metrics with the NaN abort, each epoch's
evaluation, log.txt and checkpoint-{N,best}.pth. The evaluation from images
(``--eval``): the split's loader, uint8 batches onto the device, the eval
resize and crop there, then plain evaluation, ``--mc_dropout`` or
``--ensembles`` (run_class_finetuning.py:638-677), printing the JAX
driver's JSON dict. ``--seq_parallel S`` (JAX :185-197, context
parallelism for 384/512 inputs) runs either on S ranks (``run_rank``
through ``parallel.seq.run_ranks``, one gloo group) that share ``device``,
each holding a slice of every image's tokens and reading the same batches;
rank 0 alone prints, writes log.txt and the checkpoints, and returns its
result. ``main`` takes ``device`` (the card by default; the tests pass
"cpu"); the JAX driver has no such flag, and neither has this one.

Not ported yet, and raising ``NotImplementedError`` with the ROADMAP item
that ports it: ``--corrupted_data`` / ``--perturbed_data``, ``--laplace``,
``--temp_scaling`` and ``--visualize_embedding`` (slice 8), ``--stochastic``
(slice 11), ``--mc_dropout`` under ``--seq_parallel`` (item 21), the flags
of ``builders.NOT_PORTED_MODEL_FLAGS``, an optimizer other than adamw, and
a ``--finetune``, ``--resume`` or ensemble member that is not a ``.pth``.
Attention dropout in training under ``--seq_parallel`` raises
``ValueError``, as the JAX package's attention does.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
from typing import Callable, Dict, List, Optional

import torch

from uncertainty_vit_tpu_torch.cli import builders as B
from uncertainty_vit_tpu_torch.cli.common import setup
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.data.pipeline import device_prefetch
from uncertainty_vit_tpu_torch.evals import classification as E
from uncertainty_vit_tpu_torch.evals.collect import _finish, _start_readback, per_call_generator
from uncertainty_vit_tpu_torch.evals.ensembles import stack_params
from uncertainty_vit_tpu_torch.evals.mc_dropout import make_mc_dropout_mean_forward
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops.augment import (
    IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD,
    eval_transform_batch, make_finetune_train_augment, normalize, to_float,
)
from uncertainty_vit_tpu_torch.parallel import seq
from uncertainty_vit_tpu_torch.train.engine_finetune import (
    FinetuneHParams, init_finetune_state, make_finetune_train_step, step_generators,
)
from uncertainty_vit_tpu_torch.train.optim import freeze_all_except
from uncertainty_vit_tpu_torch.utils import checkpoint as C
from uncertainty_vit_tpu_torch.utils.logging import JsonlLogger, MetricLogger, TensorboardLogger

# eval dispatches still to port: flag → (what, where the ROADMAP ports it)
NOT_PORTED_EVALS = {
    "corrupted_data": ("the corruption benchmark (-C)", "item 16, slice 8"),
    "perturbed_data": ("the perturbation benchmark (-P)", "item 16, slice 8"),
    "laplace": ("the last-layer Laplace posterior", "item 16, slice 8"),
    "temp_scaling": ("temperature scaling", "item 16, slice 8"),
}


def get_args_parser():
    p = argparse.ArgumentParser("finetuning / evaluation", add_help=True)
    B.add_model_args(p)
    B.add_opt_args(p, lr=4e-3)
    B.add_data_args(p)
    B.add_io_args(p)
    g = p.add_argument_group("finetune")
    g.add_argument("--nb_classes", type=int, default=0, help="0 = infer from dataset")
    g.add_argument("--seq_parallel", type=int, default=1,
                   help="context-parallel factor: split the tokens of each "
                        "image over that many ranks (384/512 scaling), gloo "
                        "ranks sharing the one card")
    g.add_argument("--mixup", type=float, default=0.8)
    g.add_argument("--cutmix", type=float, default=1.0)
    g.add_argument("--mixup_prob", type=float, default=1.0)
    g.add_argument("--mixup_switch_prob", type=float, default=0.5)
    g.add_argument("--smoothing", type=float, default=0.1)
    g.add_argument("--model_ema", action="store_true")
    g.add_argument("--model_ema_decay", type=float, default=0.9999)
    g.add_argument("--masked_position_prob", type=float, default=0.0)
    g.add_argument("--target_layer", type=int, default=-1,
                   help="truncate blocks to [:N+1] (run_class_finetuning.py:520-522)")
    g.add_argument("--remove_final_norm", action="store_true")
    g.add_argument("--disable_eval_during_finetuning", action="store_true")
    g.add_argument("--dual_finetune", action="store_true",
                   help="keep the checkpoint head/norms verbatim on import "
                        "(run_class_finetuning.py:408-418 skips the "
                        "shape-mismatch head drop)")
    g.add_argument("--reinit_final_norm", action="store_true",
                   help="drop norm/fc_norm from the imported checkpoint "
                        "(run_class_finetuning.py:413-417)")
    g.add_argument("--laplace", action="store_true",
                   help="last-layer KFAC Laplace on the linear head, fit on "
                        "the train split with marginal-likelihood prior "
                        "tuning (the reference's intended dispatch, "
                        "run_class_finetuning.py:651-656, is dead there — "
                        "its laplace import is commented out at :40; this "
                        "is a native implementation, evals/laplace.py)")
    g.add_argument("--laplace_link", choices=["probit", "mc"], default="probit",
                   help="Laplace predictive link approximation")
    g.add_argument("--temp_scaling", action="store_true",
                   help="post-hoc temperature scaling (Guo et al. 2017) — a "
                        "calibration baseline the reference's metric suite "
                        "measures against but never provides "
                        "(evals/calibration.py)")
    g.add_argument("--temp_scaling_split", choices=["eval", "train", "heldout"],
                   default="eval",
                   help="where to fit T*: 'eval' fits the one scalar on the "
                        "reported split (standard when no held-out "
                        "calibration set exists; negligible leak), 'heldout' "
                        "carves --temp_scaling_heldout_frac of eval for the "
                        "fit and reports on the remainder (Guo et al. "
                        "protocol, leak-free), 'train' matches the Laplace "
                        "protocol (sound only for underfit models — "
                        "near-zero train NLL gives T*~1)")
    g.add_argument("--temp_scaling_heldout_frac", type=float, default=0.1,
                   help="fraction of the eval split carved out as the T* fit "
                        "set under --temp_scaling_split heldout")
    g.add_argument("--lambda_finetuning", type=float, default=1e-4)
    g.add_argument("--lambda_pvn", type=float, default=1e-4)
    e = p.add_argument_group("evaluation")
    e.add_argument("--eval", action="store_true")
    e.add_argument("--mc_dropout", action="store_true")
    e.add_argument("--mc_dropout_forwards", type=int, default=8)
    e.add_argument("--mc_dropout_split_at", type=int, default=0,
                   help="share blocks [0, s) across the K samples (one "
                        "deterministic trunk pass). EXACT MC-dropout when "
                        "--dropout_from_block >= s; otherwise a documented "
                        "last-layers approximation. Meets the K=8 <= 4x "
                        "cost target at s >= 8 (depth 12)")
    e.add_argument("--visualize_embedding", action="store_true",
                   help="dump val-set pooled features as TensorBoard-"
                        "projector TSVs + a PCA scatter, then exit "
                        "(run_class_finetuning.py:634-637)")
    e.add_argument("--ensembles", action="store_true")
    e.add_argument("--ensemble_checkpoints", type=str, nargs="*", default=[])
    e.add_argument("--corrupted_data", action="store_true")
    e.add_argument("--perturbed_data", action="store_true")
    e.add_argument("--corruption_data_path", type=str, default=None)
    e.add_argument("--perturbation_data_path", type=str, default=None)
    e.add_argument("--wnids_path", type=str, default=None,
                   help="wnids.txt for TinyImageNet-C class ids (defaults: "
                        "corruption root, then a sibling clean TinyImageNet dir)")
    return p


def _aa_kwargs(args) -> Dict:
    """Parse a 'rand-mM-mstdS[-inc1]' --aa policy (run_class_finetuning.py's
    default) into finetune_train_augment_batch's keywords; {} when off.

    Unknown or unsupported tokens raise: a recipe's typo ('n3', 'p0.5')
    must not become a silent change of the augmentation. The on-device
    RandAugment has timm's two increasing-severity rounds built in, so 'n2'
    and 'inc1' are accepted and change nothing, and every other timm knob
    is refused."""
    aa = getattr(args, "aa", None)
    if not aa or aa in ("None", "none"):
        return {}
    parts = aa.split("-")
    if parts[0] != "rand":
        raise ValueError(
            f"--aa policy {aa!r} not supported: only timm 'rand-...' "
            "configs map onto the on-device RandAugment "
            "(ops/randaugment.py); 'original'/'augmix' policies are not "
            "carried"
        )

    def bad(part):
        return ValueError(
            f"unsupported --aa token {part!r} in {aa!r}: the on-device "
            "RandAugment supports m<mag>, mstd<std>, inc1, n2 "
            "(two rounds and increasing severity are baked in)"
        )

    mag, mstd = 9.0, 0.5
    for part in parts[1:]:
        if part.startswith("mstd"):
            try:
                mstd = float(part[4:])
            except ValueError:
                raise bad(part) from None
        elif part in ("inc1", "n2"):
            pass
        elif part.startswith("m") and part[1:].replace(".", "").isdigit():
            try:
                mag = float(part[1:])
            except ValueError:  # 'm1.2.3' passes the isdigit gate
                raise bad(part) from None
        else:
            raise bad(part)
    return {"auto_augment": True, "aa_magnitude": mag, "aa_magnitude_std": mstd}


def build_model(args, nb_classes: int, device=None, seq_group: Optional[seq.SeqGroup] = None):
    """(model, config) of the flags, its parameters drawn from a generator
    seeded with ``--seed`` on ``device`` (the card by default); with
    ``seq_group`` (``--seq_parallel``) this rank's share of the tokens."""
    cfg = B.model_config_from_args(args, nb_classes)
    if getattr(args, "masked_position_prob", 0.0) > 0:
        cfg = cfg.replace(has_masking=True)
    if getattr(args, "target_layer", -1) != -1 and not args.learn_layer_weights:
        cfg = cfg.replace(depth=args.target_layer + 1)
    if getattr(args, "remove_final_norm", False):
        cfg = cfg.replace(remove_final_norm=True)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = VisionTransformer(cfg, B.compute_dtype(args), device=device, generator=gen,
                              seq_group=seq_group)
    return model, cfg


def _eval_prep(images_u8, args, device: torch.device) -> torch.Tensor:
    """One uint8 batch on ``device``, through the eval transform: resize and
    centre crop when its size is not --input_size, else normalize only."""
    x = torch.as_tensor(images_u8).to(device)
    crop_pct = args.crop_pct or (224 / 256 if args.input_size < 384 else 1.0)
    if x.shape[1] != args.input_size:
        return eval_transform_batch(x, args.input_size, crop_pct,
                                    args.imagenet_default_mean_and_std)
    mean = IMAGENET_DEFAULT_MEAN if args.imagenet_default_mean_and_std else IMAGENET_INCEPTION_MEAN
    std = IMAGENET_DEFAULT_STD if args.imagenet_default_mean_and_std else IMAGENET_INCEPTION_STD
    return normalize(to_float(x), mean, std)


def _eval_batches(loader, args, device: torch.device):
    """Yield (normalized images, labels) on ``device``, each batch copied
    there ahead of its use (``device_prefetch``)."""
    for batch in device_prefetch(loader, device):
        yield _eval_prep(batch[0], args, device), batch[-1]


def _require_pth(path: str, what: str) -> None:
    if not path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{what} {path!r}: the port reads torch .pth checkpoints only (its own are "
            "checkpoint-N.pth files since ROADMAP.md slice 7b); an orbax checkpoint of the JAX "
            "package cannot be read")


def load_variables(args, model: VisionTransformer) -> List[str]:
    """Load --finetune into ``model`` (the surgery of run_class_finetuning.py:
    400-540, ``utils.checkpoint.import_torch_state_dict``) after stripping
    --model_prefix and, with --reinit_final_norm, dropping the final norms
    (:413-417). Returns the model's keys the checkpoint did not fill."""
    missing: List[str] = []
    if args.finetune:
        _require_pth(args.finetune, "--finetune")
        sd = C.load_torch_state_dict(args.finetune)
        prefix = getattr(args, "model_prefix", "")
        if prefix:
            sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
        if getattr(args, "reinit_final_norm", False):
            sd = {k: v for k, v in sd.items()
                  if k not in ("norm.weight", "norm.bias", "fc_norm.weight", "fc_norm.bias")}
        state, missing, unused = C.import_torch_state_dict(
            sd, model.state_dict(), keep_mismatched_head=getattr(args, "dual_finetune", False))
        model.load_state_dict(state, strict=True)
        print(f"imported {args.finetune}: {len(missing)} missing, {len(unused)} unused",
              flush=True)
    return missing


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _mc_eval_model(model: VisionTransformer) -> VisionTransformer:
    """The eval model with stochastic depth off for MC-dropout: the
    reference's enable_dropout turns only the dropouts on
    (uncertainty_evaluations.py:35-39), so the evaluation must not inherit
    the training --drop_path rate. Same weights, a second module."""
    mc = VisionTransformer(model.cfg.replace(drop_path_rate=0.0), model.dtype,
                           device=_device_of(model))
    mc.load_state_dict(model.state_dict(), strict=True)
    return mc


def _load_ensemble_members(args, model: VisionTransformer) -> List[Dict[str, torch.Tensor]]:
    """--ensemble_checkpoints → one state dict per member, each imported over
    the model's state (replaces the reference's path templates,
    engine_for_finetuning.py:234-242)."""
    members = []
    for path in args.ensemble_checkpoints:
        _require_pth(path, "ensemble member")
        state, _, _ = C.import_torch_state_dict(C.load_torch_state_dict(path), model.state_dict())
        members.append(state)
    return members


def _mc_mean_forward(args, model: VisionTransformer) -> Callable[[torch.Tensor], torch.Tensor]:
    """images → the MC-dropout mean logits, each call's masks from a fresh
    generator of the stream --seed starts (the reference redraws the masks
    on every forward, uncertainty_evaluations.py:479-534). For the -C / -P
    dispatches of slice 8."""
    mc = make_mc_dropout_mean_forward(_mc_eval_model(model), args.mc_dropout_forwards,
                                      split_at=args.mc_dropout_split_at)
    fresh = per_call_generator(args.seed, _device_of(model))
    return lambda imgs: mc(imgs, fresh())


def _default_eval_forward(args, model: VisionTransformer) -> Callable[[torch.Tensor], torch.Tensor]:
    """The deterministic eval forward (the heteroscedastic head's per-call
    draws are not ported and raise)."""
    return E.make_eval_forward(model, het=args.het_layer)


def run_eval_dispatch(args, model: VisionTransformer, val_loader, nb_classes: int) -> Dict:
    """--eval dispatch (run_class_finetuning.py:638-677): MC-dropout, the
    ensemble or the plain evaluation; prints and returns the results."""
    for flag, (what, where) in NOT_PORTED_EVALS.items():
        if getattr(args, flag, False):
            raise B.not_ported(flag, what, where)
    device = _device_of(model)
    batches = lambda: _eval_batches(val_loader, args, device)
    results = {}
    if args.mc_dropout:
        results["mc_dropout"] = E.evaluate_mc_dropout(
            _mc_eval_model(model), batches(), num_samples=args.mc_dropout_forwards,
            split_at=args.mc_dropout_split_at,
        )
    elif args.ensembles:
        results["ensembles"] = E.evaluate_ensemble(
            model, stack_params(_load_ensemble_members(args, model)), batches())
    else:
        results["eval"] = E.evaluate(model, batches(), forward=_default_eval_forward(args, model),
                                     het=args.het_layer)
    print(json.dumps(results, indent=2, default=float), flush=True)
    return results


def _check_seq_flags(args) -> None:
    """What --seq_parallel does not run raises before the ranks start: the
    MC-dropout evaluation (not ported under a seq group) and attention
    dropout in training (the JAX package's attention refuses it,
    models/layers.py:353-358)."""
    if args.eval and args.mc_dropout:
        raise B.not_ported("mc_dropout", "MC-dropout under --seq_parallel", "item 21")
    if not args.eval and args.attn_drop_rate > 0:
        raise ValueError("sequence-parallel attention requires attn_drop=0 (in-kernel dropout "
                         "seeds are not defined across re-sharded grids)")


def _start_metrics_readback(metrics: Dict[str, object]):
    """Queue the copy of a step's tensor metrics to the host behind the step
    (one stacked tensor); returns what ``_finish_metrics`` reads."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    values = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    return metrics, keys, _start_readback(values)


def _finish_metrics(pending) -> Dict[str, float]:
    """Wait for a step's metrics (only for that step, not the ones queued
    after it); float values in the step's key order."""
    metrics, keys, readback = pending
    values = dict(zip(keys, _finish(readback).tolist()))
    return {k: values[k] if k in values else float(v) for k, v in metrics.items()}


def train(args, device: torch.device, val_loader, nb_classes: int,
          seq_group: Optional[seq.SeqGroup] = None):
    """The train loop (JAX cli/finetune.py:580-790, non-stochastic): epochs
    of augmented steps from the train split, each followed by an evaluation,
    log.txt and checkpoints. Returns the train state. Under ``seq_group``
    every rank runs it on the same batches and draws; rank 0 alone writes
    the files, and the ranks' parameters are held equal after each epoch."""
    model, cfg = build_model(args, nb_classes, device, seq_group)
    writes = seq_group is None or seq_group.rank == 0
    train_loader, _ = B.build_loaders(args, is_train=True, letterbox_ok=True,
                                      host=None if seq_group is None else (0, 1))
    steps_per_epoch = args.steps_per_epoch or len(train_loader)
    lr_schedule, wd_schedule, _ = B.build_lr_schedules(args, steps_per_epoch)
    missing = load_variables(args, model)
    optimizer = B.build_optimizer(args, model, cfg.depth)
    if args.linear_classifier and args.finetune:
        # linear-probe freezing (run_class_finetuning.py:529-538): train only
        # what the checkpoint did not provide (the fresh head)
        trainable = missing or ["head"]
        print(f"linear probe: trainable params = {trainable}", flush=True)
        freeze_all_except(optimizer, trainable)
    hp = FinetuneHParams(
        num_classes=nb_classes, mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
        mixup_prob=args.mixup_prob, mixup_switch_prob=args.mixup_switch_prob,
        label_smoothing=args.smoothing, mixup_active=B.mixup_active(args),
        mixup_mode=args.mixup_mode,
        cutmix_minmax=tuple(args.cutmix_minmax) if args.cutmix_minmax else None,
        masked_position_prob=args.masked_position_prob, model_ema_decay=args.model_ema_decay,
        head_type=cfg.head_type, update_freq=max(1, args.update_freq),
    )
    # the EMA starts from the imported weights, as the reference creates its
    # ModelEma after the checkpoint surgery (run_class_finetuning.py:545-553)
    state = init_finetune_state(model, optimizer, use_model_ema=args.model_ema)
    aug_fn = make_finetune_train_augment(
        args.input_size, color_jitter_strength=args.color_jitter, reprob=args.reprob,
        imagenet_default_mean_and_std=args.imagenet_default_mean_and_std,
        interpolation=B.interp_method(args.train_interpolation), re_mode=args.remode,
        re_count=args.recount, **_aa_kwargs(args))
    train_step = make_finetune_train_step(model, optimizer, hp, lr_schedule, wd_schedule,
                                          aug_fn=aug_fn)

    start_epoch = args.start_epoch
    if args.auto_resume and not args.resume:
        # the reference's auto_load moves start_epoch only when it found a
        # checkpoint (utils.py:487-545); --start_epoch wins otherwise
        state, resumed_epoch = C.auto_load(args.output_dir, state)
        start_epoch = max(start_epoch, resumed_epoch)
    elif args.resume:
        _require_pth(args.resume, "--resume")
        C.restore_checkpoint(args.resume, state)
    if start_epoch and state.step == 0:
        # a fresh start at a later epoch: the schedules go on from the
        # reference's it = epoch * steps_per_epoch
        state.step = start_epoch * steps_per_epoch

    save_ckpt = args.save_ckpt and args.output_dir and writes
    tb = TensorboardLogger(args.log_dir or args.output_dir if writes else None)
    jsonl = JsonlLogger(args.output_dir) if writes else None
    best_acc = -1.0
    eval_forward = E.make_eval_forward(model, het=args.het_layer)

    for epoch in range(start_epoch, args.epochs):
        train_loader.set_epoch(epoch)
        logger = MetricLogger()
        # the host reads step i's metrics back after it has queued steps
        # i + 1 and i + 2 (the JAX driver's 2-deep window): the card is not
        # left idle behind a readback, and a NaN stops the run within two
        # steps (engine_for_finetuning.py:101-103), reported at its global
        # step
        pending: "collections.deque" = collections.deque()
        step_base = state.step

        def drain_one():
            m, global_step = pending.popleft()
            m = _finish_metrics(m)
            B.check_finite_or_die(m["loss"], global_step)
            logger.update(**m)
            tb.update(head="loss", loss=m["loss"])
            tb.set_step()

        for step, batch in enumerate(logger.log_every(device_prefetch(train_loader, device), 10,
                                                      f"Epoch: [{epoch}]")):
            if step >= steps_per_epoch:
                break
            images_u8, labels = batch[0], batch[-1]
            # letterboxed batches carry each image's valid extent
            # (--decode_letterbox), so that the crop covers the whole image
            valid_hw = batch[1] if len(batch) == 3 else None
            gens = step_generators(args.seed, state.step, device)
            metrics = train_step(state, images_u8, labels, gens.model, gens.mix, gens.augment,
                                 valid_hw)
            pending.append((_start_metrics_readback(metrics), step_base + step))
            while len(pending) > 2:
                drain_one()
        while pending:
            drain_one()

        if seq_group is not None:
            seq.check_equal_on_ranks(model.parameters(), seq_group, "the parameters")
        test = None
        if not args.disable_eval_during_finetuning:
            test = E.evaluate(model, _eval_batches(val_loader, args, device), forward=eval_forward,
                              het=args.het_layer)
        record = {"epoch": epoch, **{f"train_{k}": v for k, v in logger.epoch_summary().items()}}
        if test is not None:
            print(f"epoch {epoch}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in sorted(test.items())), flush=True)
            if test["acc1"] > best_acc:
                best_acc = test["acc1"]
                if save_ckpt:
                    C.save_checkpoint(args.output_dir, "best", state, epoch)
            record.update({f"test_{k}": v for k, v in test.items()})
            record["best_acc1"] = best_acc
        if jsonl is not None:
            jsonl.write(record)
        if save_ckpt and ((epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs):
            C.save_checkpoint(args.output_dir, epoch, state, epoch)
        tb.flush()
    print(f"done. best acc1 {best_acc:.3f}", flush=True)
    return state


def _run(args, device: torch.device, seq_group: Optional[seq.SeqGroup] = None):
    """The driver's body on one process (one rank under ``seq_group``)."""
    print(f"device: {device}", flush=True)
    host = None if seq_group is None else (0, 1)
    val_loader, nb_classes = B.build_loaders(args, is_train=False, host=host)
    nb_classes = args.nb_classes or nb_classes
    if not args.eval:
        return train(args, device, val_loader, nb_classes, seq_group)
    model, _ = build_model(args, nb_classes, device, seq_group)
    load_variables(args, model)
    return run_eval_dispatch(args, model, val_loader, nb_classes)


def run_rank(group: seq.SeqGroup, args, device: str):
    """One rank of --seq_parallel (``parallel.seq.run_ranks`` calls it in
    each process of the group): the driver's body on ``device`` with this
    rank's share of the tokens. Rank 0 prints and returns its result; the
    others print nothing and return None."""
    setup(bounded_scores_default=True)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if group.rank == 0:
        return _run(args, device, group)
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        _run(args, device, group)
    return None


def main(args, device=None):
    """Run the driver on ``device`` (the card unless the caller asks for the
    CPU): with --eval the evaluation, returning its results dict; else the
    train loop, returning the train state. --seq_parallel S runs it on S
    ranks sharing ``device`` and returns rank 0's."""
    # bounded-scores attention by default: finetuning starts from a trained
    # backbone (cli/common.py)
    setup(bounded_scores_default=True)
    B.validate_aug_args(args)
    if args.visualize_embedding:
        raise B.not_ported("visualize_embedding", "the embedding dump (utils/embeddings.py)",
                           "item 16, slice 8")
    if args.device != "cuda":
        raise NotImplementedError(
            f"--device {args.device}: the driver runs on the one card ('cuda'); the CPU is "
            "main(args, device='cpu'), for tests")
    device = resolve_device(device)
    if args.seq_parallel > 1:
        _check_seq_flags(args)
        return seq.run_ranks(run_rank, args.seq_parallel, args, str(device))[0]
    return _run(args, device)


if __name__ == "__main__":
    main(get_args_parser().parse_args())
