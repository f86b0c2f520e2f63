"""uncertainty_vit_tpu_torch — the PyTorch / CUDA port of uncertainty_vit_tpu.

The JAX package beside it is the reference; this package keeps its module
names so each counterpart is easy to find, and its layouts at the public
functions (NHWC images, packed qkv [B, N, 3C], [H, N, N] attention bias).
Plain tensor code is PyTorch; each Pallas kernel of the reference becomes a
CUDA kernel written for Hopper (sm_90a) under ``csrc/``, built with nvcc at
first use. On CPU tensors every kernel wrapper runs its plain PyTorch
version.

Ported so far (the deterministic evaluation path):
    core/    ViTConfig and presets; initializers on torch.Generators
    ops/     rel-pos index, plain attention, the fused attention forward
             (kernel K1), image normalization
    models/  ViT layers and the VisionTransformer with the linear head
    utils/   JAX param tree -> port state_dict
    evals/   calibration metrics, logit collection, evaluate()

This package imports torch and never jax.
"""
