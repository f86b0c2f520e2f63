"""uncertainty_vit_tpu_torch — the PyTorch / CUDA port of uncertainty_vit_tpu.

The JAX package beside it is the reference; this package keeps its module
names so each counterpart is easy to find, and its layouts at the public
functions (NHWC images, packed qkv [B, N, 3C], [H, N, N] attention bias).
Plain tensor code is PyTorch; each Pallas kernel of the reference becomes a
CUDA kernel written for Hopper (sm_90a) under ``csrc/``, built with nvcc at
first use. On CPU tensors every kernel wrapper runs its plain PyTorch
version.

Ported so far (ROADMAP.md has the slices):
    core/      ViTConfig and presets; initializers on torch.Generators; the
               default device (the card)
    ops/       rel-pos index, plain attention, the attention kernels K1-K5,
               the int8 matmuls K6 / K7, the fused dropout K8, Philox bits,
               mixup, losses, the eval transform
    models/    ViT layers, the VisionTransformer with the linear head, the
               registry's finetune family
    parallel/  sequence parallelism over torch.distributed
    train/     the finetune train step, AdamW with layer decay, schedules, EMA
    evals/     calibration metrics, logit collection, evaluate(), MC-dropout
               and ensembles
    data/      datasets, their registry, the batch loader, device prefetch
    utils/     JAX params and reference .pth files -> port state_dict; the
               native host IO library
    cli/       the finetune driver's evaluation (python -m
               uncertainty_vit_tpu_torch.cli.finetune --eval ...)

This package imports torch and never jax.
"""
