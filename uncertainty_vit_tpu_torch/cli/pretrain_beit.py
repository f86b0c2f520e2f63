"""BEiT masked-image-modeling pretraining driver: counterpart of
uncertainty_vit_tpu/cli/pretrain_beit.py (:25-117), which replaces the
reference's run_beit_pretraining.py.

    python -m uncertainty_vit_tpu_torch.cli.pretrain_beit \
        --model beit_base_patch16_224_8k_vocab --data_set IMNET --data_path DIR \
        --batch_size 128 --lr 1.5e-3 --warmup_epochs 10 --num_mask_patches 75 \
        --second_input_size 112 --clip_grad 3.0 --discrete_vae_type dall-e \
        --discrete_vae_weight_path DALLE_DIR --output_dir OUT ...

The recipe (README_Original.md:94-102 of the reference): ViT-B, 150 epochs,
global batch 2048, lr 1.5e-3, mask 75, the tokenizer view at 112; drop-path
0.1, layer scale 0.1 and the shared rel-pos bias are the flags' defaults.

The train split's uint8 batches go to the card a batch ahead of their step
(``device_prefetch``), each with its blockwise masks made on the host from
the step's CPU generator (``cli.pretrain_cyclical.train_epochs``); the step
(``train.engine_mim``) runs the two-view transform on the card, the frozen
tokenizer (``cli.builders.build_discrete_vae``: the DALL-E network from its
pickles, or the in-repo dVAE from ``cli.train_dvae``'s
``checkpoint-dvae-weights.pth``), the masked student, the cross-entropy
over the codebook and AdamW with the clip. The attention's softmax is the
exact one: the driver sets ``BOUNDED_SCORES`` off (``cli.common.setup``).

As in the JAX driver: ``--auto_resume`` restores student, optimizer and
step from the highest ``checkpoint-N.pth`` (there is no --resume, --finetune
or --start_epoch: they raise); log.txt gets a record an epoch under the JAX
driver's keys (the step's metric names, no prefix); ``checkpoint-N.pth`` is
written every ``--save_ckpt_freq`` epochs and at the end. ``main`` takes
``device`` (the card by default; the tests pass "cpu"). Every --opt of the
JAX make_optimizer runs, adahessian with its Hessian pass in the step (JAX
:89). ``--stochastic`` raises ``ValueError``: the JAX driver parses it and
ignores it.
"""

from __future__ import annotations

import argparse

import torch

from uncertainty_vit_tpu_torch.cli import builders as B
from uncertainty_vit_tpu_torch.cli.common import setup
from uncertainty_vit_tpu_torch.cli.pretrain_cyclical import train_epochs
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.models.mim import MIMViT
from uncertainty_vit_tpu_torch.models.registry import MODEL_NAMES
from uncertainty_vit_tpu_torch.ops.augment import make_pretrain_two_view
from uncertainty_vit_tpu_torch.train.engine_finetune import optional_streams
from uncertainty_vit_tpu_torch.train.engine_mim import MIMState, make_mim_train_step
from uncertainty_vit_tpu_torch.train.optim import needs_hessian
from uncertainty_vit_tpu_torch.utils import checkpoint as C


# the reference's MIM registry names (modeling_pretrain.py:139-166), which
# --model takes beside the presets
MIM_MODELS = tuple(n for n in MODEL_NAMES if n.endswith("_8k_vocab"))


def add_tokenizer_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("beit")
    g.add_argument("--vocab_size", type=int, default=8192)
    g.add_argument("--second_input_size", type=int, default=112)
    g.add_argument("--discrete_vae_weight_path", type=str, default="",
                   help="dall-e: the directory of encoder.pkl / decoder.pkl; customized / "
                        "none: a DiscreteVAE .pth (cli.train_dvae's "
                        "checkpoint-dvae-weights.pth)")
    g.add_argument("--discrete_vae_type", type=str, default="customized",
                   choices=["none", "dall-e", "customized"],
                   help="tokenizer-view transform (datasets.py:86-102): dall-e applies "
                        "map_pixels, customized Inception-normalizes, none leaves [0,1]")
    g.add_argument("--dvae_num_layers", type=int, default=3)
    g.add_argument("--dvae_hidden_dim", type=int, default=64)
    return g


def get_args_parser():
    p = argparse.ArgumentParser("BEiT MIM pretraining", add_help=True)
    B.add_model_args(p, MIM_MODELS)
    B.add_opt_args(p, lr=1.5e-3)
    B.add_data_args(p)
    B.add_mask_args(p)
    B.add_io_args(p)
    add_tokenizer_args(p)
    return p


def check_args(args, what: str) -> None:
    """The checks both BEiT-style drivers make before they build anything."""
    setup(bounded_scores_default=False)  # pretraining keeps the exact softmax
    B.validate_aug_args(args)
    if args.device != "cuda":
        raise NotImplementedError(
            f"--device {args.device}: the driver runs on the one card ('cuda'); the CPU is "
            "main(args, device='cpu'), for tests")
    for flag in ("resume", "start_epoch") + (("finetune",) if what == "mim" else ()):
        if getattr(args, flag):
            raise ValueError(f"--{flag}: the {what} driver resumes through --auto_resume only, "
                             "as the JAX driver does")
    if args.mask_dropout_prob > 0:
        raise ValueError(f"--mask_dropout_prob: the {what} step takes no mask dropout, as the "
                         "JAX step takes none")
    if args.stochastic:
        raise ValueError(f"--stochastic: not read by this driver (the {what} model has no dist "
                         "variant; the JAX driver parses the flag and ignores it)")


def build_model(args, device=None):
    """(student, config) of the flags: ``MIMViT`` over --vocab_size tokens,
    ``head_type`` "none", its parameters drawn from a generator seeded with
    --seed on ``device``."""
    cfg = B.model_config_from_args(args, num_classes=0).replace(head_type="none")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return MIMViT(cfg, B.compute_dtype(args), vocab_size=args.vocab_size, device=device,
                  generator=gen), cfg


def build_tokenizer(args, device):
    """The frozen tokenizer (``builders.build_discrete_vae``), drawn from a
    generator seeded with --seed + 1 where no file fills it."""
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    return B.build_discrete_vae(args, gen, device)


def two_view_augment(args):
    return make_pretrain_two_view(
        args.input_size, args.second_input_size,
        imagenet_default_mean_and_std=args.imagenet_default_mean_and_std,
        color_jitter_strength=args.color_jitter, discrete_vae_type=args.discrete_vae_type,
        second_interpolation=B.interp_method(args.second_interpolation))


def main(args, device=None):
    """Pretrain on ``device`` (the card unless the caller asks for the CPU);
    returns the train state (``train.engine_mim.MIMState``)."""
    check_args(args, "mim")
    device = resolve_device(device)
    print(f"device: {device}", flush=True)

    loader, _ = B.build_loaders(args, is_train=True, letterbox_ok=True)
    steps_per_epoch = args.steps_per_epoch or len(loader)
    model, cfg = build_model(args, device)
    tokenizer = build_tokenizer(args, device)
    lr_schedule, wd_schedule, total_steps = B.build_lr_schedules(args, steps_per_epoch)
    n_params = sum(p.numel() for p in model.parameters()) / 1e6
    print(f"model: {args.model} ({n_params:.1f}M params), tokenizer: {args.discrete_vae_type} "
          f"({type(tokenizer).__name__}), steps/epoch {steps_per_epoch}, total {total_steps}",
          flush=True)
    optimizer = B.build_optimizer(args, model, cfg.depth)
    state = MIMState(model=model, optimizer=optimizer)

    start_epoch = 0
    if args.auto_resume:
        state, start_epoch = C.auto_load(args.output_dir, state)
        if start_epoch:
            print(f"auto-resumed from epoch {start_epoch}", flush=True)

    train_step = make_mim_train_step(model, tokenizer, optimizer, lr_schedule, wd_schedule,
                                     two_view_augment(args), use_hessian=needs_hessian(args.opt))

    def run_step(epoch, state, images_u8, masks, gens, valid_hw):
        return train_step(state, images_u8, masks, gens.model, gens.augment, valid_hw,
                          **optional_streams(gens))

    train_epochs(args, state, loader, steps_per_epoch, cfg.grid_size, device, start_epoch,
                 run_step, {"loss": ("loss", "mlm_acc"), "opt": ("lr", "grad_norm")})
    print("done.", flush=True)
    return state


if __name__ == "__main__":
    main(get_args_parser().parse_args())
