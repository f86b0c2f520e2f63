#!/usr/bin/env python3
"""Profile the PyTorch port's finetune train step on one card.

    python3 tools/torch_port_profile_train.py [--plain] [--quant int8]
        [--model beit_large_patch16_512 | beit_huge_patch16_224]

Builds the train step as chip_smoke.py phase 4 does (bench.py's
configuration: ViT-B/16 224, shared rel-pos bias, layer scale 0.1,
drop-path 0.1, batch mixup, AdamW with layer decay 0.65, bounded-scores
softmax, bf16 compute on f32 params, seeded random weights and images) at
batch 160, or with ``--model beit_large_patch16_512`` phase 9's step (ViT-L/16
512, N = 1025: layer decay 0.75, batch 8, K3 and K4 24 launches a step),
or with ``--model beit_huge_patch16_224`` phase 13's (ViT-H/16 224, head
width 80: layer decay 0.75, batch 32, K1 and K2 32 launches a step),
runs 3 warm-up steps, times 3 steps, then records 3 more under
torch.profiler (CPU and CUDA activities).
Prints the card, the step time, the device busy share (summed kernel time
over the window's wall time), the CUDA time by operator and a coarse split
by kernel class, and writes the Chrome trace to
chiprun_out/profile_train_step_<model>.json. ``--plain`` profiles the plain
attention path instead of the K1/K2 kernels; ``--quant int8`` the step with
the int8 trunk (K6 and K7). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 3
# model → (batch, layer decay, image side)
MODELS = {"beit_base_patch16_224": (160, 0.65, 224), "beit_large_patch16_512": (8, 0.75, 512),
          "beit_huge_patch16_224": (32, 0.75, 224)}
# kernel-name fragments → class, first match wins
CLASSES = (
    ("stream_fwd", "K1 / K3 streaming forward"),
    # the streaming kernels are K1 and K2 at N <= 256, K3 and K4 above
    ("stream_bwd_dq", "K2 / K4 kernel 1 (dq, dbias)"),
    ("stream_bwd_dkv", "K2 / K4 kernel 2 (dk, dv)"),
    ("attention_fwd", "K1 attention forward"),
    ("attention_bwd", "K2 attention backward (the earlier fused kernel)"),
    ("quantize_rows", "K6 row quantize (forward, dgrad)"),
    ("qmm_s8", "K6 int8 product (forward, dgrad)"),
    ("quant_fwd_kernel", "K6 int8 matmul (forward, dgrad; the mma.sync kernel of PR 6)"),
    ("quantize_transpose", "K7 quantize-transpose"), ("wgrad_s8", "K7 int32 product"),
    ("wgrad_mm", "K7 int32 product (the mma.sync kernel of PR 6)"),
    ("gemm", "GEMMs (cuBLAS)"), ("nvjet", "GEMMs (cuBLAS)"), ("sm90_xmma", "GEMMs (cuBLAS)"),
    ("cutlass", "GEMMs (cuBLAS)"),
    ("layer_norm", "LayerNorm fwd/bwd"), ("LayerNorm", "LayerNorm fwd/bwd"),
    ("GammaBeta", "LayerNorm fwd/bwd"),
    ("multi_tensor_apply", "AdamW / foreach (optimizer)"),
    ("gelu", "GELU fwd/bwd"), ("GeluCUDA", "GELU fwd/bwd"),
    ("copy", "dtype casts / copies"), ("cast", "dtype casts / copies"),
    ("reduce", "reductions (sums, norms)"),
    ("softmax", "softmax"),
    ("elementwise", "other elementwise"),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--quant", choices=("none", "int8"), default="none")
    ap.add_argument("--model", choices=sorted(MODELS), default="beit_base_patch16_224")
    args = ap.parse_args()
    batch, layer_decay, side = MODELS[args.model]

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA
    from uncertainty_vit_tpu_torch.train.engine_finetune import (
        FinetuneHParams, init_finetune_state, make_finetune_train_step,
    )
    from uncertainty_vit_tpu_torch.train.optim import make_optimizer
    from uncertainty_vit_tpu_torch.train.schedules import cosine_schedule

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    FA.BOUNDED_SCORES = True
    dev = torch.device("cuda", 0)
    cfg = get_preset(args.model, use_shared_rel_pos_bias=True,
                     drop_path_rate=0.1, init_values=0.1, use_flash_attention=not args.plain,
                     quant=args.quant)
    gen = torch.Generator(device=dev).manual_seed(2)
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
    opt = make_optimizer(model, weight_decay=0.05, layer_decay=layer_decay, depth=cfg.depth)
    step = make_finetune_train_step(model, opt, FinetuneHParams(num_classes=cfg.num_classes),
                                    cosine_schedule(4e-3, 1e-6, 10_000, warmup_steps=500))
    state = init_finetune_state(model, opt)
    images = torch.randn(batch, side, side, 3, generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen, device=dev)
    g_dev, g_cpu = torch.Generator(device=dev).manual_seed(3), torch.Generator().manual_seed(3)

    for _ in range(3):
        step(state, images, labels, g_dev, g_cpu)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(state, images, labels, g_dev, g_cpu)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1000 / STEPS

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(state, images, labels, g_dev, g_cpu)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(f"chiprun_out/profile_train_step_{args.model}.json")

    # kernels and copies only: an optimizer's ``record_function`` range is
    # mirrored onto the device timeline and would count its kernels twice
    events = [e for e in prof.events()
              if e.device_type.name == "CUDA" and not e.is_user_annotation]
    total_us = sum(e.time_range.elapsed_us() for e in events)
    by_class = {}
    for e in events:
        cls = next((c for frag, c in CLASSES if frag in e.name), "other")
        by_class[cls] = by_class.get(cls, 0.0) + e.time_range.elapsed_us()
    print(f"{args.model}, path: {'plain attention' if args.plain else 'attention kernels'}, "
          f"quant {args.quant}, batch {batch}", flush=True)
    print(f"step {step_ms:.2f} ms unprofiled ({batch * 1000 / step_ms:.1f} img/s); "
          f"profiled window {wall_ms:.1f} ms for {STEPS} steps, "
          f"CUDA kernel time {total_us / 1000:.1f} ms, busy share {total_us / 1000 / wall_ms:.3f}",
          flush=True)
    print(json.dumps({k: round(v / 1000 / STEPS, 3) for k, v in
                      sorted(by_class.items(), key=lambda kv: -kv[1])}), flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
