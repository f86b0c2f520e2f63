"""Shared CLI setup: the attention's softmax mode.

Counterpart of uncertainty_vit_tpu/cli/common.py (``setup_jax`` :8-50). The
JAX package's compilation cache has no counterpart: the port's kernels are
built once per checkout (``ops/_native.py``).
"""

from __future__ import annotations

import os

from uncertainty_vit_tpu_torch.ops import flash_attention as FA


def setup(bounded_scores_default: bool = False) -> None:
    """Set the attention kernels' softmax mode for a driver's run.

    bounded_scores_default: the default of ``flash_attention.BOUNDED_SCORES``
    (the softmax without the running max). The finetune driver passes True:
    it starts from a trained backbone, whose attention scores stay far from
    f32's exp overflow. The pretraining drivers keep the exact max-subtracted
    softmax (False). The environment variable UVIT_ATTN_BOUNDED_SCORES ("1"
    or "0") overrides the default either way.

    UVIT_ATTN_LSE_BF16=1 (the reference's bf16 log-sum-exp) raises: the
    port's kernels keep the lse in f32 (ROADMAP.md §2). UVIT_FUSED_DROPOUT has
    no counterpart: the port's MC-dropout evaluation always runs the fused
    dropout kernel K8."""
    if os.environ.get("UVIT_ATTN_LSE_BF16", "") == "1":
        raise NotImplementedError(
            "UVIT_ATTN_LSE_BF16=1: the port's attention kernels keep the log-sum-exp in "
            "f32; a bf16 lse is not ported (ROADMAP.md §2)")
    bounded_env = os.environ.get("UVIT_ATTN_BOUNDED_SCORES", "")
    FA.BOUNDED_SCORES = bounded_scores_default if bounded_env == "" else bounded_env == "1"
