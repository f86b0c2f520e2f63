"""Reference-semantics attention in plain PyTorch (softmax variant).

Counterpart of uncertainty_vit_tpu/ops/attention.py:80-139: the attention
math of the reference (modeling_finetune.py:145-188) over [B, H, N, D]
tensors. It is the model's path when ``use_flash_attention=False`` and the
oracle the fused kernel (ops/flash_attention.py) is held against. The gumbel
and sinkformer variants are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def softmax_probs(scores: torch.Tensor) -> torch.Tensor:
    return torch.softmax(scores, dim=-1)


def attention_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    scale: float,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, H, Nq, D] q, [B, H, Nk, D] k → [B, H, Nq, Nk] f32 scores with
    optional bias add.

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
    query_rows: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Unfused attention: the correctness reference.

    q: [B, H, Nq, D], k, v: [B, H, Nk, D] (Nq = Nk = N in self-attention).
    bias: broadcastable to [B, H, Nq, Nk]. Returns [B, H, Nq, D] in v.dtype.
    Probabilities are computed in float32. The dropout mask comes from
    ``generator``, never from the global one; with ``query_rows`` = (start,
    n), q holds rows [start, start + Nq) of n queries, and the mask is drawn
    for all n rows and those kept, as the unsharded attention draws it."""
    if variant != "softmax":
        raise NotImplementedError(f"attention variant {variant!r} is not ported yet")
    probs = softmax_probs(attention_scores(q, k, scale, bias))
    if dropout_rate > 0.0 and not deterministic:
        if generator is None:
            raise ValueError("attention dropout draws from an explicit torch.Generator; "
                             "pass generator=")
        b, h, nq, nk = probs.shape
        if query_rows is None:
            u = torch.rand(probs.shape, generator=generator, device=probs.device)
        else:
            start, n = query_rows
            u = torch.rand((b, h, n, nk), generator=generator,
                           device=probs.device)[:, :, start:start + nq]
        keep = u < 1.0 - dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)
