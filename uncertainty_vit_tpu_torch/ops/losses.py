"""The data2vec regression losses (engine_for_cyclical.py:132-163), the
classification criteria (run_class_finetuning.py:617-623) and the
Wasserstein losses of the dist (mean+covariance) model (distloss.py).

Counterpart of uncertainty_vit_tpu/ops/losses.py:25-229. The regression
losses take a [B, N] weight mask in place of the reference's gather of the
masked tokens, as the JAX package does: the same value for these means.
Every loss computes in float32. ``masked_mim_cross_entropy`` (:96-112) is
BEiT's masked codebook cross-entropy. The Wasserstein functions (:119-229)
keep the JAX package's formulas term for term: its clamps at 1e-24 (as
``torch.maximum``, whose gradient splits evenly at a tie, as ``jnp.clip``'s
does), its maxima (``torch.amax``, split evenly over ties as ``jnp.max``),
and its normalizations by a maximum without a guard where it has none (0/0
where all distances are 0). ``wasserstein_distance_matmul``'s two products
run in float32 with TF32 off, forward and backward, whatever the process
set: the distance m1² + m2²ᵀ − 2·m1·m2ᵀ cancels where it is small.
"""

from __future__ import annotations

from typing import Optional

import torch

from uncertainty_vit_tpu_torch.models.dvae import f32_scope


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


# ---------------------------------------------------------------------------
# Wasserstein losses (distloss.py; JAX :119-229)
# ---------------------------------------------------------------------------

def _at_least(x: torch.Tensor, lo: float) -> torch.Tensor:
    """max(x, lo) elementwise, the gradient split evenly at a tie (jnp.clip's
    and jnp.maximum's); the bound is filled on x's device (no host copy)."""
    return torch.maximum(x, x.new_full((), lo))


def wasserstein_distance(mean1: torch.Tensor, cov1: torch.Tensor, mean2: torch.Tensor,
                         cov2: torch.Tensor) -> torch.Tensor:
    """Elementwise 2-Wasserstein distance between diagonal Gaussians over the
    last axis (distloss.py:73-78)."""
    ret = torch.sum((mean1 - mean2) ** 2, dim=-1)
    c1 = torch.sqrt(_at_least(cov1, 1e-24))
    c2 = torch.sqrt(_at_least(cov2, 1e-24))
    return ret + torch.sum((c1 - c2) ** 2, dim=-1)


def _max_abs(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(x.abs())


def wasserstein_pretrain_loss(mean_out: torch.Tensor, cov_out: torch.Tensor,
                              pos_mean: torch.Tensor, pos_cov: torch.Tensor,
                              lambda_pretraining: float = 1e-5,
                              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WassersteinLoss (distloss.py:7-30): sigmoid-squash, the W2 distance,
    −log σ(−d) normalized by its maximum, summed × λ. ``mask`` (the flattened
    rows, {0, 1}) stands for the reference's gather of the masked tokens:
    the maxima and the sum range over the masked rows only."""
    s = torch.sigmoid
    d = wasserstein_distance(s(mean_out), s(cov_out), s(pos_mean), s(pos_cov)).reshape(-1)
    if mask is not None:
        m = mask.reshape(-1).to(d.dtype)
        d = d / _at_least(torch.amax(d.abs() * m), 1e-24)
        loss = -torch.log(torch.sigmoid(-d + 1e-24))
        loss = loss / _at_least(torch.amax(loss.abs() * m), 1e-24)
        return torch.sum(loss * m) * lambda_pretraining
    d = d / _max_abs(d)
    loss = -torch.log(torch.sigmoid(-d + 1e-24))
    loss = loss / _max_abs(loss)
    return torch.sum(loss) * lambda_pretraining


def wasserstein_finetune_loss(mean_out: torch.Tensor, cov_out: torch.Tensor,
                              pos_mean: torch.Tensor, pos_cov: torch.Tensor,
                              neg_mean: torch.Tensor, neg_cov: torch.Tensor,
                              lambda_finetuning: float = 1e-4,
                              lambda_pvn: float = 1e-4) -> torch.Tensor:
    """WassersteinLossFineTuning (distloss.py:33-70): the contrastive ranking
    term −log σ(neg − pos) plus the clamp(pos − pos_vs_neg, 0) "PVN" term,
    each normalized by its maximum."""
    s = torch.sigmoid
    m, c = s(mean_out), s(cov_out)
    pm, pc = s(pos_mean), s(pos_cov)
    nm, nc = s(neg_mean), s(neg_cov)
    pos = wasserstein_distance(m, c, pm, pc)
    neg = wasserstein_distance(m, c, nm, nc)
    pvn = wasserstein_distance(pm, pc, nm, nc)
    pos = pos / _max_abs(pos)
    neg = neg / _max_abs(neg)
    pvn = pvn / _max_abs(pvn)
    rank = -torch.log(torch.sigmoid(neg - pos + 1e-24))
    rank = rank / _max_abs(rank) * lambda_finetuning
    pvn_loss = _at_least(pos - pvn, 0.0)
    pvn_loss = pvn_loss / _at_least(_max_abs(pvn_loss), 1e-24) * lambda_pvn
    return torch.sum(rank) + torch.sum(pvn_loss)


def at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 (a reference copy of a model)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class _F32ProductNT(torch.autograd.Function):
    """a·bᵀ over the last two axes in float32 (float64 for float64 inputs)
    with TF32 off, in the forward and in the backward
    (``models.dvae.f32_scope``)."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        dtype = at_least_f32(a.dtype)
        with f32_scope():
            return a.to(dtype) @ b.to(dtype).transpose(-1, -2)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        with f32_scope():
            return g @ b.to(g.dtype), g.transpose(-1, -2) @ a.to(g.dtype)


def wasserstein_distance_matmul(mean1: torch.Tensor, cov1: torch.Tensor, mean2: torch.Tensor,
                                cov2: torch.Tensor) -> torch.Tensor:
    """All-pairs W2 distance of the dist attention (uncertainty_evaluations.py:
    276-294): every input sigmoid-squashed as the reference does; [..., N, D]
    → [..., N, N]."""
    s = torch.sigmoid
    mean1, mean2 = s(mean1), s(mean2)
    cov1, cov2 = s(cov1), s(cov2)
    m1_sq = torch.sum(mean1**2, dim=-1, keepdim=True)
    m2_sq = torch.sum(mean2**2, dim=-1, keepdim=True)
    ret = m1_sq + m2_sq.transpose(-1, -2) - 2 * _F32ProductNT.apply(mean1, mean2)
    c1 = torch.sqrt(_at_least(cov1, 1e-24))
    c2 = torch.sqrt(_at_least(cov2, 1e-24))
    c1_sum = torch.sum(cov1, dim=-1, keepdim=True)
    c2_sum = torch.sum(cov2, dim=-1, keepdim=True)
    return ret + c1_sum + c2_sum.transpose(-1, -2) - 2 * _F32ProductNT.apply(c1, c2)


def kl_distance_matmul(mean1: torch.Tensor, cov1: torch.Tensor, mean2: torch.Tensor,
                       cov2: torch.Tensor) -> torch.Tensor:
    """Batched diagonal-Gaussian KL (uncertainty_evaluations.py:296-314), the
    reference's formula with its quirks (JAX :213-229): the mean term
    (mean1 − mean2)² · (1/cov2)ᵀ elementwise first (coherent for inputs of
    one N only), the trace term in the reference's transposed orientation.
    No active path uses it."""
    log_det = torch.log((1.0 / torch.prod(cov1, dim=-1, keepdim=True))
                        @ torch.prod(cov2, dim=-1, keepdim=True).transpose(-1, -2))
    trace_sum = (1.0 / cov2) @ cov1.transpose(-1, -2)
    mean_cov_part = ((mean1 - mean2) ** 2) @ (1.0 / cov2).transpose(-1, -2)
    return (log_det + mean_cov_part + trace_sum - mean1.shape[-1]) / 2
