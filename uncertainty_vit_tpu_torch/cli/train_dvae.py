"""The discrete-VAE tokenizer trainer: counterpart of
uncertainty_vit_tpu/cli/train_dvae.py (:36-201).

    python -m uncertainty_vit_tpu_torch.cli.train_dvae \
        --data_set IMNET --data_path DIR --input_size 112 --batch_size 128 \
        --output_dir DVAE_DIR ...

The reference has no in-repo producer of its dVAE weights (its ``Dalle_VAE``
loads OpenAI's pickles). This trains ``models.dvae.DiscreteVAE`` with the
DALL-E recipe's shape: the Gumbel-softmax relaxation over the codebook at a
temperature annealed by a cosine from --temperature_start to
--temperature_end over --temperature_anneal_steps, a pixel MSE, and
--kl_weight times the KL to the uniform code distribution. Its metrics are
those of the JAX step: the loss and its two terms, the perplexity of the
batch-mean code distribution, the fraction of the codebook that some
position's argmax takes, and the temperature, all computed on the card
without a host synchronization.

Each step's uint8 batch goes to the card a batch ahead; the augmentation
(``augment_batch``: flip, then a random resized crop over (0.3, 1), then
``map_pixels`` with --use_map_pixels) and the Gumbel noise draw from the
step's generators (functions of --seed and the step). AdamW (no layer decay)
with the cosine lr and its warm-up; ``--auto_resume`` from the highest
``checkpoint-N.pth``; log.txt with the ``train_`` prefix; at the end the
weights alone as ``checkpoint-dvae-weights.pth``, which the pretrainers
read through --discrete_vae_weight_path. ``main`` takes ``device`` (the card
by default; the tests pass "cpu").
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from uncertainty_vit_tpu_torch.cli import builders as B
from uncertainty_vit_tpu_torch.cli.pretrain_cyclical import train_epochs
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.models.dvae import DiscreteVAE, draw_gumbel, f32_scope
from uncertainty_vit_tpu_torch.ops.augment import (
    RRCDraws, draw_hflip, draw_rrc, from_planar, map_pixels, random_hflip_batch,
    random_resized_crop_batch, to_planar,
)
from uncertainty_vit_tpu_torch.train import schedules
from uncertainty_vit_tpu_torch.train.engine_finetune import FinetuneState
from uncertainty_vit_tpu_torch.train.optim import LayerDecayAdamW, make_optimizer
from uncertainty_vit_tpu_torch.utils import checkpoint as C

WEIGHTS_TAG = "dvae-weights"


def get_args_parser():
    p = argparse.ArgumentParser("dVAE tokenizer training", add_help=True)
    B.add_data_args(p)
    B.add_io_args(p)
    g = p.add_argument_group("dvae")
    g.add_argument("--input_size", type=int, default=112,
                   help="tokenizer-view resolution (BEiT second_input_size)")
    g.add_argument("--vocab_size", type=int, default=8192)
    g.add_argument("--dvae_num_layers", type=int, default=3)
    g.add_argument("--dvae_hidden_dim", type=int, default=64)
    g.add_argument("--codebook_dim", type=int, default=512)
    g.add_argument("--lr", type=float, default=1e-3)
    g.add_argument("--min_lr", type=float, default=1e-5)
    g.add_argument("--warmup_epochs", type=int, default=1)
    g.add_argument("--weight_decay", type=float, default=0.0)
    g.add_argument("--clip_grad", type=float, default=None)
    g.add_argument("--kl_weight", type=float, default=6.6e-3,
                   help="KL(q‖uniform) coefficient (DALL-E final beta / V)")
    g.add_argument("--temperature_start", type=float, default=1.0)
    g.add_argument("--temperature_end", type=float, default=0.0625)
    g.add_argument("--temperature_anneal_steps", type=int, default=150000)
    g.add_argument("--use_map_pixels", type=ast.literal_eval, default=False,
                   help="train in the dall-e logit-Laplace pixel space "
                        "(match --discrete_vae_type dall-e at pretrain time)")
    return p


@dataclasses.dataclass
class DVAEAugmentDraws:
    """The flip's raw uniforms [B] and the crop's draws."""

    flip_u: torch.Tensor
    rrc: RRCDraws


def draw_dvae_augment(generator: torch.Generator, b: int) -> DVAEAugmentDraws:
    return DVAEAugmentDraws(draw_hflip(generator, b), draw_rrc(generator, b))


def augment_batch(draws: DVAEAugmentDraws, images_u8: torch.Tensor, out_size: int,
                  use_map_pixels: bool) -> torch.Tensor:
    """The flip, then a random resized crop over (0.3, 1) (bicubic): uint8
    [B, H, W, C] → f32 [B, out, out, C] in [0, 1], or through
    ``map_pixels`` (JAX :70-78)."""
    imgs = random_hflip_batch(draws.flip_u, to_planar(images_u8))
    imgs = random_resized_crop_batch(draws.rrc, imgs, out_size, scale=(0.3, 1.0))
    out = from_planar(imgs)
    return map_pixels(out) if use_map_pixels else out


def temperature_schedule(step: int, start: float, end: float, anneal_steps: int) -> float:
    """The cosine from ``start`` to ``end`` over ``anneal_steps`` steps,
    then ``end`` (JAX :81-83), computed in f32 on the host from the step
    number."""
    t = np.clip(np.float32(step) / np.float32(max(anneal_steps, 1)), 0.0, 1.0)
    half = np.float32(0.5) * (np.float32(start) - np.float32(end))
    return float(np.float32(end) + half * (np.float32(1.0) + np.cos(np.float32(np.pi) * t,
                                                                       dtype=np.float32)))


def make_dvae_train_step(model: DiscreteVAE, optimizer: LayerDecayAdamW, args,
                         lr_schedule: schedules.Schedule):
    """Returns step(state, images, generator) → metrics {"loss",
    "recon_loss", "kl", "perplexity", "codebook_used_frac", "temperature"}
    (JAX :86-127); images [B, S, S, C] on the model's device, ``generator``
    (on that device) draws the Gumbel noise. The state is updated in place."""
    vocab = args.vocab_size

    def step(state: FinetuneState, images: torch.Tensor, generator: torch.Generator
             ) -> Dict[str, object]:
        tau = temperature_schedule(state.step, args.temperature_start, args.temperature_end,
                                   args.temperature_anneal_steps)
        b, s = images.shape[0], images.shape[1] >> model.num_layers
        model.train()
        # the backward's convolutions and products in float32 too, whatever
        # the process set for TF32
        with f32_scope():
            recon, logits = model(images, tau, draw_gumbel(generator, (b, s, s, vocab)))
            recon_loss = torch.mean((recon.float() - images.float()) ** 2)
            logp = torch.log_softmax(logits.float(), dim=-1)
            q = torch.exp(logp)
            # KL(q ‖ U) = log V − H(q), per position
            kl = math.log(float(vocab)) + torch.mean(torch.sum(q * logp, dim=-1))
            loss = recon_loss + args.kl_weight * kl
            with torch.no_grad():
                # the perplexity of the batch-mean code distribution, and the
                # share of the codebook some position's argmax takes (a
                # scatter into a vocabulary-sized row: no host synchronization)
                mean_q = q.reshape(-1, vocab).mean(dim=0)
                perplexity = torch.exp(-torch.sum(mean_q * torch.log(mean_q + 1e-10)))
                hard = logits.argmax(dim=-1).reshape(-1)
                used = torch.zeros(vocab, device=hard.device).index_fill_(0, hard, 1.0).sum()
            optimizer.zero_grad()
            loss.backward()
            optimizer.step(lr_schedule(state.step), optimizer.weight_decay)
        state.step += 1
        return {"loss": loss.detach(), "recon_loss": recon_loss.detach(), "kl": kl.detach(),
                "perplexity": perplexity, "codebook_used_frac": used / float(vocab),
                "temperature": tau}

    return step


def build_model(args, device=None) -> DiscreteVAE:
    device = resolve_device(device)
    return DiscreteVAE(image_size=args.input_size, num_tokens=args.vocab_size,
                       codebook_dim=args.codebook_dim, num_layers=args.dvae_num_layers,
                       hidden_dim=args.dvae_hidden_dim, device=device,
                       generator=torch.Generator(device=device).manual_seed(args.seed))


def main(args, device=None):
    """Train on ``device`` (the card unless the caller asks for the CPU);
    returns the train state (``train.engine_finetune.FinetuneState``)."""
    B.validate_aug_args(args)
    if args.device != "cuda":
        raise NotImplementedError(
            f"--device {args.device}: the trainer runs on the one card ('cuda'); the CPU is "
            "main(args, device='cpu'), for tests")
    device = resolve_device(device)
    print(f"device: {device}", flush=True)
    loader, _ = B.build_loaders(args, is_train=True)
    steps_per_epoch = args.steps_per_epoch or len(loader)
    model = build_model(args, device)
    total = args.epochs * steps_per_epoch
    lr_schedule = schedules.cosine_schedule(args.lr, args.min_lr, total,
                                            args.warmup_epochs * steps_per_epoch)
    optimizer = make_optimizer(model, weight_decay=args.weight_decay, clip_grad=args.clip_grad)
    state = FinetuneState(model=model, optimizer=optimizer)  # "model_ema" stays None
    n_params = sum(p.numel() for p in model.parameters()) / 1e6
    print(f"dVAE: {n_params:.2f}M params, vocab {args.vocab_size}, steps/epoch "
          f"{steps_per_epoch}, total {total}", flush=True)

    start_epoch = 0
    if args.auto_resume:
        state, start_epoch = C.auto_load(args.output_dir, state)
        if start_epoch:
            print(f"auto-resumed from epoch {start_epoch}", flush=True)

    train_step = make_dvae_train_step(model, optimizer, args, lr_schedule)

    def run_step(epoch, state, images_u8, masks, gens, valid_hw):
        images = augment_batch(draw_dvae_augment(gens.augment, images_u8.shape[0]), images_u8,
                               args.input_size, args.use_map_pixels)
        return train_step(state, images, gens.model)

    train_epochs(args, state, loader, steps_per_epoch, None, device, start_epoch, run_step, {},
                 log_prefix="train_")
    if args.output_dir:
        # the weights alone, which the pretrainers read with
        # --discrete_vae_weight_path
        C.save_weights(args.output_dir, WEIGHTS_TAG, model)
    print("done.", flush=True)
    return state


if __name__ == "__main__":
    main(get_args_parser().parse_args())
