"""Joint cyclical+BEiT pretraining driver: counterpart of
uncertainty_vit_tpu/cli/pretrain_joint.py (:30-140), which replaces the
reference's run_cyclical_joint.py.

    python -m uncertainty_vit_tpu_torch.cli.pretrain_joint \
        --model beit_base_patch16_224 --data_set IMNET --data_path DIR \
        --batch_size 128 --lr 2e-3 --num_mask_patches 120 --clip_grad 3.0 \
        --drop_path 0.25 --attn_drop_rate 0.05 --vae_loss_weight 30 \
        --discrete_vae_weight_path DVAE.pth --output_dir OUT ...

The cyclical (data2vec) EMA-teacher regression and BEiT's codebook
prediction on one student (``models.mim.JointViT``), their losses mixed by
an epoch-annealed weight (engine_for_cyclical_joint.py:84-85): the BEiT
loss's weight falls from 1 to 0 over --vae_loss_weight epochs. The driver
is ``cli.pretrain_beit``'s (``cli.pretrain_cyclical.train_epochs``: the masks on the host a batch ahead, the
two-view transform and the frozen tokenizer on the card, the exact softmax,
log.txt under the JAX driver's keys, ``checkpoint-N.pth``), with the
cyclical teacher kept as ``CyclicalState.teacher`` and saved as
"model_ema". ``--seed_model`` (an alias of ``--finetune``) seeds the
student from a ``.pth`` before the teacher's copy and before
``--auto_resume``, the JAX driver's order (:61-110). ``main`` takes
``device`` (the card by default; the tests pass "cpu"). ``--stochastic``,
which the JAX driver parses and ignores, raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import ast

import torch

from uncertainty_vit_tpu_torch.cli import builders as B
from uncertainty_vit_tpu_torch.cli import pretrain_beit as PB
from uncertainty_vit_tpu_torch.cli.pretrain_cyclical import seed_from_pth, train_epochs
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.models.mim import JointViT
from uncertainty_vit_tpu_torch.models.registry import MODEL_NAMES
from uncertainty_vit_tpu_torch.train.engine_cyclical import init_cyclical_state
from uncertainty_vit_tpu_torch.train.engine_finetune import optional_streams
from uncertainty_vit_tpu_torch.train.engine_mim import JointHParams, make_joint_train_step
from uncertainty_vit_tpu_torch.train.optim import needs_hessian
from uncertainty_vit_tpu_torch.utils import checkpoint as C

# the reference's joint registry name, which --model takes beside the presets
JOINT_MODELS = tuple(n for n in MODEL_NAMES if "_joint_" in n)


def get_args_parser():
    p = argparse.ArgumentParser("joint cyclical+BEiT pretraining", add_help=True)
    B.add_model_args(p, JOINT_MODELS)
    B.add_opt_args(p, lr=2e-3)
    B.add_data_args(p)
    B.add_mask_args(p)
    B.add_io_args(p)
    g = p.add_argument_group("joint")
    g.add_argument("--target_layers", type=str, default="[6,7,8,9,10,11]")
    g.add_argument("--layer_results", type=str, default="end", choices=["end", "fc"])
    g.add_argument("--l1_beta", type=float, default=2.0)
    g.add_argument("--seed_model", type=str, default="",
                   help="alias of --finetune for the pretrainer (run_cyclical.py:332)")
    g.add_argument("--ema_decay", type=float, default=0.9998)
    g.add_argument("--ema_decay_init", type=float, default=0.999)
    g.add_argument("--ema_start_at", type=int, default=0)
    g.add_argument("--vae_loss_weight", type=float, default=100.0,
                   help="annealing horizon in epochs (run_cyclical_joint.py)")
    PB.add_tokenizer_args(p)
    return p


def hparams(args) -> JointHParams:
    """The flags the JAX driver passes (:94-103); the rest are
    ``CyclicalHParams``' defaults."""
    return JointHParams(
        target_layers=tuple(ast.literal_eval(args.target_layers)),
        layer_results=args.layer_results, l1_beta=args.l1_beta, ema_decay=args.ema_decay,
        ema_decay_init=args.ema_decay_init, ema_start_at=args.ema_start_at,
        vae_loss_weight_anneal_epochs=args.vae_loss_weight, update_freq=max(1, args.update_freq))


def build_model(args, device=None):
    """(student, config) of the flags: ``JointViT`` over --vocab_size
    tokens, ``head_type`` "none", its parameters drawn from a generator
    seeded with --seed on ``device``."""
    cfg = B.model_config_from_args(args, num_classes=0).replace(head_type="none")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return JointViT(cfg, B.compute_dtype(args), vocab_size=args.vocab_size, device=device,
                    generator=gen), cfg


def main(args, device=None):
    """Pretrain on ``device`` (the card unless the caller asks for the CPU);
    returns the train state (``train.engine_cyclical.CyclicalState``)."""
    PB.check_args(args, "joint")
    if args.seed_model and not args.finetune:
        args.finetune = args.seed_model
    device = resolve_device(device)
    print(f"device: {device}", flush=True)

    loader, _ = B.build_loaders(args, is_train=True, letterbox_ok=True)
    steps_per_epoch = args.steps_per_epoch or len(loader)
    model, cfg = build_model(args, device)
    tokenizer = PB.build_tokenizer(args, device)
    hp = hparams(args)
    lr_schedule, wd_schedule, total_steps = B.build_lr_schedules(args, steps_per_epoch)
    n_params = sum(p.numel() for p in model.parameters()) / 1e6
    print(f"model: {args.model} ({n_params:.1f}M params), tokenizer: {args.discrete_vae_type} "
          f"({type(tokenizer).__name__}), steps/epoch {steps_per_epoch}, total {total_steps}",
          flush=True)
    if args.finetune:
        seed_from_pth(args, model)
    optimizer = B.build_optimizer(args, model, cfg.depth)
    state = init_cyclical_state(model, optimizer)

    start_epoch = 0
    if args.auto_resume:
        state, start_epoch = C.auto_load(args.output_dir, state)
        if start_epoch:
            print(f"auto-resumed from epoch {start_epoch}", flush=True)

    train_step = make_joint_train_step(model, tokenizer, optimizer, hp, lr_schedule,
                                       wd_schedule, PB.two_view_augment(args),
                                       use_hessian=needs_hessian(args.opt))

    def run_step(epoch, state, images_u8, masks, gens, valid_hw):
        return train_step(state, images_u8, masks, epoch, gens.model, gens.augment, valid_hw,
                          **optional_streams(gens))

    train_epochs(args, state, loader, steps_per_epoch, cfg.grid_size, device, start_epoch,
                 run_step, {"loss": ("loss", "loss_cyc", "loss_beit", "mlm_acc"),
                            "opt": ("lr", "grad_norm", "beit_weight")})
    print("done.", flush=True)
    return state


if __name__ == "__main__":
    main(get_args_parser().parse_args())
