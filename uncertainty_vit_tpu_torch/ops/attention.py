"""Reference-semantics attention in plain PyTorch (softmax variant).

Counterpart of uncertainty_vit_tpu/ops/attention.py:80-139: the attention
math of the reference (modeling_finetune.py:145-188) over [B, H, N, D]
tensors. It is the model's path when ``use_flash_attention=False`` and the
oracle the fused kernel (ops/flash_attention.py) is held against. The gumbel
and sinkformer variants are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def softmax_probs(scores: torch.Tensor) -> torch.Tensor:
    return torch.softmax(scores, dim=-1)


def attention_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    scale: float,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, H, N, D] q/k → [B, H, N, N] f32 scores with optional bias add.

    q is scaled in its own dtype; the product of the (exactly upcast)
    operands is taken in f32, as the reference's
    ``einsum(..., preferred_element_type=f32)`` does."""
    scores = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    return scores


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    bias: Optional[torch.Tensor] = None,
    *,
    variant: str = "softmax",
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Unfused attention: the correctness reference.

    q, k, v: [B, H, N, D]. bias: broadcastable to [B, H, N, N]. Returns
    [B, H, N, D] in v.dtype. Probabilities are computed in float32."""
    if variant != "softmax":
        raise NotImplementedError(f"attention variant {variant!r} is not ported yet")
    probs = softmax_probs(attention_scores(q, k, scale, bias))
    if dropout_rate > 0.0 and not deterministic:
        u = torch.rand(probs.shape, generator=generator, device=probs.device)
        keep = u < 1.0 - dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)
