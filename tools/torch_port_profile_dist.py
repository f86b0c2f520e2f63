#!/usr/bin/env python3
"""Where the time of the dist (mean+covariance) model's stochastic finetune
step goes, on one card.

    python3 tools/torch_port_profile_dist.py [--batch 128]

Builds the step as ``cli.finetune --stochastic`` does at the finetune
recipe (RECIPES.md:35-45: ``dist_beit_base_patch16_224``, 100 classes,
drop-path 0.2, layer scale 0.1, shared rel-pos bias, mixup 0.8 / cutmix 1.0,
AdamW with layer decay 0.65, bf16 compute on f32 parameters) from seeded
weights and seeded uint8 triplets at 32x32 (the anchor through the train
transform, pos and neg through the eval transform, all to 224 on the card),
runs 3 warm-up steps, times 5 steps by CUDA events, then times its parts
alone by CUDA events: the transforms, the anchor's forward and backward,
the pos and neg forwards, AdamW, and the Wasserstein attention of the 12
blocks (one block's DistAttention at the step's shapes: forward and
backward for the anchor, forward alone for pos and neg). Last, 2 steps
under torch.profiler: kernel time by class and the device's busy share.
Prints the card's name and power limit first, and the peak memory of a
step. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# kernel-name fragments → class, first match wins
CLASSES = (
    ("gemm", "GEMMs (cuBLAS)"), ("nvjet", "GEMMs (cuBLAS)"), ("sm90_xmma", "GEMMs (cuBLAS)"),
    ("cutlass", "GEMMs (cuBLAS)"),
    ("layer_norm", "LayerNorm fwd/bwd"), ("LayerNorm", "LayerNorm fwd/bwd"),
    ("GammaBeta", "LayerNorm fwd/bwd"),
    ("multi_tensor_apply", "AdamW / foreach (optimizer)"),
    ("softmax", "softmax fwd/bwd"), ("sigmoid", "sigmoid fwd/bwd"),
    ("gelu", "GELU fwd/bwd"), ("GeluCUDA", "GELU fwd/bwd"), ("elu", "ELU fwd/bwd"),
    ("copy", "dtype casts / copies"), ("cast", "dtype casts / copies"),
    ("reduce", "reductions (sums, norms)"),
    ("elementwise", "other elementwise"),
)


def cuda_ms(torch, fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import numpy as np
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=128)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from torch.profiler import ProfilerActivity, profile

    from uncertainty_vit_tpu_torch.cli import builders as B
    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.ops.augment import make_finetune_train_augment
    from uncertainty_vit_tpu_torch.train import engine_finetune_dist as ED
    from uncertainty_vit_tpu_torch.train.engine_finetune import init_finetune_state
    from uncertainty_vit_tpu_torch.train.engine_finetune import step_generators
    from uncertainty_vit_tpu_torch.train.schedules import constant_schedule

    dev = torch.device("cuda", 0)
    bs = a.batch
    args = FT.get_args_parser().parse_args([
        "--model", "dist_beit_base_patch16_224", "--stochastic", "--input_size", "224",
        "--batch_size", str(bs), "--lr", "4e-3", "--layer_decay", "0.65", "--drop_path", "0.2",
        "--weight_decay", "0.0", "--mixup", "0.8", "--cutmix", "1.0"])
    model, cfg = FT.build_model(args, 100, dev)
    optimizer = B.build_optimizer(args, model, cfg.depth)
    aug_fn = make_finetune_train_augment(
        args.input_size, color_jitter_strength=args.color_jitter, reprob=args.reprob,
        imagenet_default_mean_and_std=args.imagenet_default_mean_and_std,
        interpolation=B.interp_method(args.train_interpolation), re_mode=args.remode,
        re_count=args.recount, **FT._aa_kwargs(args))

    def prep(x):
        return FT._eval_prep(x, args, dev)

    hp = ED.DistFinetuneHParams(num_classes=100, mixup_alpha=0.8, cutmix_alpha=1.0)
    step = ED.make_dist_finetune_train_step(model, optimizer, hp, constant_schedule(1e-4),
                                            aug_fn=aug_fn, prep_fn=prep)
    state = init_finetune_state(model, optimizer)
    rs = np.random.RandomState(0)
    u8 = [torch.from_numpy(rs.randint(0, 256, (bs, 32, 32, 3), dtype=np.uint8)).to(dev)
          for _ in range(3)]
    labels = torch.from_numpy(np.arange(bs) % 100).to(dev)

    def one_step():
        gens = step_generators(0, state.step, dev)
        return step(state, *u8, labels, gens.model, gens.mix, gens.augment)

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        one_step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"dist finetune step at batch {bs} (bf16): {[round(t, 2) for t in times]} ms by CUDA "
          f"events, {bs * 1000 / min(times):.1f} img/s at the fastest; peak memory "
          f"{peak:.2f} GiB", flush=True)

    # the parts alone, on one fixed batch and generators
    gens = step_generators(0, 99, dev)
    images = aug_fn(gens.augment, u8[0], None)
    pos, neg = prep(u8[1]), prep(u8[2])

    def anchor():
        model.train()
        mean, cov, logits = model(images, generator=torch.Generator(device=dev).manual_seed(1))
        (logits.float().logsumexp(-1).mean() + mean.float().mean() + cov.float().mean()).backward()

    def pos_neg():
        with torch.no_grad():
            model(pos, deterministic=True)
            model(neg, deterministic=True)

    optimizer.zero_grad()
    anchor()
    attn = model.blocks[0].attn
    n = cfg.num_patches + 1
    x = torch.randn(bs, n, cfg.embed_dim, device=dev, dtype=torch.bfloat16, requires_grad=True)
    cx = torch.randn(bs, n, cfg.embed_dim, device=dev, dtype=torch.bfloat16, requires_grad=True)
    bias = model.rel_pos_bias().detach()

    def attn_fwd_bwd():
        m, c = attn(x, cx, bias, deterministic=True)
        (m.float().sum() + c.float().sum()).backward()

    def attn_fwd():
        with torch.no_grad():
            attn(x, cx, bias, deterministic=True)

    parts = {
        "transforms (anchor train, pos / neg eval)": cuda_ms(
            torch, lambda: (aug_fn(gens.augment, u8[0], None), prep(u8[1]), prep(u8[2])), 5),
        "anchor forward + backward": cuda_ms(torch, anchor, 3),
        "pos + neg forwards": cuda_ms(torch, pos_neg, 3),
        f"AdamW (layer decay, {len(optimizer.params)} tensors)": cuda_ms(
            torch, lambda: optimizer.step(1e-4, 0.0), 5),
        "Wasserstein attention, anchor: 12 x forward + backward":
            12 * cuda_ms(torch, attn_fwd_bwd, 5),
        "Wasserstein attention, pos + neg: 24 x forward": 24 * cuda_ms(torch, attn_fwd, 5),
    }
    for k, v in parts.items():
        print(f"  {k}: {v:.2f} ms", flush=True)

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            one_step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1000
    by_class, busy = {}, 0.0
    for e in prof.events():
        if e.device_type.name != "CUDA" or e.is_user_annotation:
            continue
        us = e.time_range.elapsed_us()
        busy += us
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name)
        cls = next((c for frag, c in CLASSES if frag in name), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us
    print(f"2 profiled steps: wall {wall:.2f} ms, kernel time {busy / 1000:.2f} ms, busy share "
          f"{busy / 1000 / wall:.3f}; kernel ms a step by class:", flush=True)
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {us / 2000:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
