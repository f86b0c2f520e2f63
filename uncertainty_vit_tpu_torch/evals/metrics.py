"""Calibration / uncertainty metrics on torch tensors, on the logits' device.

Counterpart of uncertainty_vit_tpu/evals/metrics.py (:25-210), mirroring
uncertainty_evaluations.py:99-272 (BrierScore, ECE/MCE/OE/SCE/TACE/ACE, NLL)
plus torchmetrics-style multiclass AUROC. Every metric runs on the FULL
logit set at once.

Binning conventions (uncertainty_evaluations.py:110-186):
  - in_bin: conf > lower AND conf <= upper
  - uniform boundaries linspace(0,1,n_bins+1); adaptive boundaries from the
    sorted per-class probabilities at indices i*(n//n_bins), closed with 1.0
  - bin_score = |bin_conf − bin_acc|, weighted by bin_prop

Both kinds of boundaries are sorted and contiguous (each lower bound is the
previous upper bound), so a sample's bin is found with one searchsorted and
the bins are summed with scatter_add: O(n) memory per class, where the JAX
version builds an [n_bins, n] membership mask one class at a time.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def softmax_probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1)


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor,
                  ks=(1, 5)) -> Tuple[torch.Tensor, ...]:
    """timm accuracy: top-k percentage (0-100), k clamped to the class count.
    Equal logits rank lower class index first, as jax.lax.top_k does."""
    nc = logits.shape[-1]
    pred = logits.sort(dim=-1, descending=True, stable=True).indices[:, : min(max(ks), nc)]
    correct = pred == labels[:, None]
    return tuple(100.0 * correct[:, : min(k, nc)].any(dim=1).float().mean() for k in ks)


def _bin_stats(conf: torch.Tensor, acc: torch.Tensor, lowers: torch.Tensor,
               uppers: torch.Tensor):
    """Per-bin (prop, acc, conf, score), each [K, n_bins], for K rows of
    [n] confidences/accuracies and [K, n_bins] sorted contiguous boundaries
    (uncertainty_evaluations.py:159-186)."""
    k, n = conf.shape
    nb = uppers.shape[1]
    idx = torch.searchsorted(uppers.contiguous(), conf.contiguous())  # first upper >= conf
    # idx >= 1 implies conf > uppers[idx-1] == lowers[idx]; bin 0 needs the check
    inside = (idx < nb) & (conf > lowers.gather(1, idx.clamp(max=nb - 1)))
    idx = torch.where(inside, idx, nb)  # spill column, dropped below

    def bin_sum(values: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(k, nb + 1, dtype=torch.float32, device=conf.device)
        return out.scatter_add_(1, idx, values)[:, :nb]

    count = bin_sum(torch.ones_like(conf))
    safe = count.clamp(min=1.0)
    nonempty = count > 0
    bacc = torch.where(nonempty, bin_sum(acc) / safe, 0.0)
    bconf = torch.where(nonempty, bin_sum(conf) / safe, 0.0)
    score = torch.where(nonempty, (bconf - bacc).abs(), 0.0)
    return count / n, bacc, bconf, score


def _uniform_bounds(n_bins: int, rows: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    b = torch.linspace(0.0, 1.0, n_bins + 1, device=device)
    return b[:-1].expand(rows, n_bins), b[1:].expand(rows, n_bins)


def _maxprob(logits, labels):
    probs = softmax_probs(logits)
    # argmax takes the first of equal maxima, as jnp.argmax does
    return probs.amax(dim=1)[None], (probs.argmax(dim=1) == labels).float()[None]


def _class_rows(logits, labels):
    """Per-class rows: probabilities [K, n] and one-vs-rest targets [K, n]."""
    probs = softmax_probs(logits).T.contiguous()
    classes = torch.arange(probs.shape[0], device=probs.device)
    return probs, (labels[None, :] == classes[:, None]).float()


def ece(logits, labels, n_bins: int = 15) -> torch.Tensor:
    """Expected calibration error, Σ prop·|conf−acc| (uncertainty_evaluations.py:198-202)."""
    conf, acc = _maxprob(logits, labels)
    prop, _, _, score = _bin_stats(conf, acc, *_uniform_bounds(n_bins, 1, conf.device))
    return (prop * score).sum()


def mce(logits, labels, n_bins: int = 15) -> torch.Tensor:
    """Max-bin calibration error (uncertainty_evaluations.py:205-209)."""
    conf, acc = _maxprob(logits, labels)
    _, _, _, score = _bin_stats(conf, acc, *_uniform_bounds(n_bins, 1, conf.device))
    return score.max()


def oe(logits, labels, n_bins: int = 15) -> torch.Tensor:
    """Overconfidence error, Σ prop·conf·max(conf−acc, 0)
    (uncertainty_evaluations.py:214-218)."""
    conf, acc = _maxprob(logits, labels)
    prop, bacc, bconf, _ = _bin_stats(conf, acc, *_uniform_bounds(n_bins, 1, conf.device))
    return (prop * bconf * (bconf - bacc).clamp(min=0.0)).sum()


def sce(logits, labels, n_bins: int = 15) -> torch.Tensor:
    """Static calibration error: per-class uniform-bin ECE averaged over
    classes (uncertainty_evaluations.py:222-238)."""
    conf, acc = _class_rows(logits, labels)
    prop, _, _, score = _bin_stats(conf, acc, *_uniform_bounds(n_bins, conf.shape[0], conf.device))
    return (prop * score).sum(dim=1).mean()


def tace(logits, labels, threshold: float = 0.01, n_bins: int = 30) -> torch.Tensor:
    """Thresholded adaptive calibration error (uncertainty_evaluations.py:241-261):
    probabilities below ``threshold`` zeroed; per-class adaptive bin
    boundaries from the sorted probabilities at indices i·(n//n_bins). With
    n < n_bins the bin count is clamped to n, as the JAX version does."""
    conf, acc = _class_rows(logits, labels)
    conf = torch.where(conf < threshold, 0.0, conf)
    k, n = conf.shape
    n_bins = min(n_bins, n)
    if n_bins == 0:
        return torch.zeros((), device=conf.device)
    idx = torch.arange(n_bins, device=conf.device) * (n // n_bins)
    lowers = conf.sort(dim=1).values[:, idx]
    uppers = torch.cat([lowers[:, 1:], torch.ones(k, 1, device=conf.device)], dim=1)
    prop, _, _, score = _bin_stats(conf, acc, lowers, uppers)
    return (prop * score).sum(dim=1).mean()


def ace(logits, labels, n_bins: int = 15) -> torch.Tensor:
    """Adaptive calibration error = TACE with threshold 0
    (uncertainty_evaluations.py:265-268)."""
    return tace(logits, labels, threshold=0.0, n_bins=n_bins)


def brier(logits, labels) -> torch.Tensor:
    """Mean over samples of Σ(probs − one-hot)² (uncertainty_evaluations.py:99-107)."""
    probs = softmax_probs(logits)
    one_hot = F.one_hot(labels, probs.shape[1]).float()
    return ((probs - one_hot) ** 2).sum(dim=1).mean()


def nll(logits, labels) -> torch.Tensor:
    """-mean log softmax prob of the target (uncertainty_evaluations.py:270-272)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def auroc_ovr_macro(logits, labels) -> torch.Tensor:
    """Multiclass AUROC, one-vs-rest macro average (torchmetrics AUROC
    semantics, engine_for_finetuning.py:25). Rank-statistic (Mann-Whitney U)
    form with average ranks for ties; classes with no positives or no
    negatives are left out of the average, and 0.0 is returned when no class
    has both."""
    scores, pos = _class_rows(logits, labels)
    n = scores.shape[1]
    srt = scores.sort(dim=1).values
    lo = torch.searchsorted(srt, scores)
    hi = torch.searchsorted(srt, scores, right=True)
    ranks = (lo + hi + 1).float() / 2.0
    n_pos = pos.sum(dim=1)
    n_neg = n - n_pos
    auc = ((ranks * pos).sum(dim=1) - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg).clamp(min=1.0)
    valid = (n_pos > 0) & (n_neg > 0)
    return torch.where(valid, auc, 0.0).sum() / valid.float().sum().clamp(min=1.0)


def classification_metrics(logits: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Full metric suite on one logit set (acc1/5, ECE, TACE, NLL, AUROC —
    run_class_finetuning.py:714-731 — plus the rest of the calibration
    family), as 0-d tensors on the logits' device."""
    labels = labels.long()
    acc1, acc5 = accuracy_topk(logits, labels)
    return {
        "acc1": acc1,
        "acc5": acc5,
        "ece": ece(logits, labels),
        "tace": tace(logits, labels),
        "mce": mce(logits, labels),
        "sce": sce(logits, labels),
        "ace": ace(logits, labels),
        "oe": oe(logits, labels),
        "brier": brier(logits, labels),
        "nll": nll(logits, labels),
        "auroc": auroc_ovr_macro(logits, labels),
    }
