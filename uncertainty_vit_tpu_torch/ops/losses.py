"""The data2vec regression losses (engine_for_cyclical.py:132-163) and the
classification criteria (run_class_finetuning.py:617-623).

Counterpart of uncertainty_vit_tpu/ops/losses.py:25-95. The regression
losses take a [B, N] weight mask in place of the reference's gather of the
masked tokens, as the JAX package does: the same value for these means.
Every loss computes in float32. ``masked_mim_cross_entropy`` (:96-112) is
BEiT's masked codebook cross-entropy. The Wasserstein losses are not
ported yet.
"""

from __future__ import annotations

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    """Elementwise F.smooth_l1_loss (the Huber form with ``beta``)."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def masked_regression_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                           beta: float = 2.0, l2: bool = False) -> torch.Tensor:
    """Mean smooth-L1 (or squared error with ``l2``) over the masked
    positions: pred, target [B, N, C], mask [B, N] in {0, 1}."""
    pred, target = pred.float(), target.float()
    elem = (pred - target) ** 2 if l2 else smooth_l1(pred, target, beta)
    w = mask.float()[..., None]
    denom = torch.clamp_min(w.sum() * pred.shape[-1], 1.0)
    return (elem * w).sum() / denom


def masked_variance_hinge(pred: torch.Tensor, mask: torch.Tensor, margin: float = 0.5,
                          eps: float = 1e-6) -> torch.Tensor:
    """VICReg-style hinge on the per-channel std over the masked rows:
    z = sqrt(unbiased var + eps), loss = mean(relu(margin − z))."""
    x = pred.float().reshape(-1, pred.shape[-1])
    w = mask.float().reshape(-1, 1)
    n = torch.clamp_min(w.sum(), 2.0)
    mean = (x * w).sum(0) / n
    var = ((x - mean) ** 2 * w).sum(0) / (n - 1.0)
    z = torch.sqrt(var + eps)
    return torch.relu(margin - z).sum() / z.shape[0]


def soft_target_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor) -> torch.Tensor:
    """timm SoftTargetCrossEntropy: mean over batch of −Σ t·log_softmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.mean(torch.sum(-soft_targets * logp, dim=-1))


def label_smoothing_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, smoothing: float = 0.1
) -> torch.Tensor:
    """timm LabelSmoothingCrossEntropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    smooth = -logp.mean(dim=-1)
    return torch.mean((1.0 - smoothing) * nll + smoothing * smooth)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(logp.gather(-1, labels[:, None]))


def masked_mim_cross_entropy(logits: torch.Tensor, token_ids: torch.Tensor,
                             mask: torch.Tensor) -> tuple:
    """BEiT's MIM loss (engine_for_pretraining.py:50-57) and its MLM
    accuracy (:74): the cross-entropy of f32 log-softmax over the codebook
    vocabulary, and argmax == token, each weighted by the mask over
    max(Σmask, 1). logits [B, N, V]; token_ids [B, N] int; mask [B, N] in
    {0, 1}. Returns (loss, acc) as 0-d device tensors (nothing is read back)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ids = token_ids.long()[..., None]
    nll = -logp.gather(-1, ids)[..., 0]
    w = mask.float()
    denom = torch.clamp_min(w.sum(), 1.0)
    loss = (nll * w).sum() / denom
    correct = (logits.argmax(dim=-1) == ids[..., 0]).float()
    return loss, (correct * w).sum() / denom
