"""Corruption (·-C) and perturbation (·-P) robustness benchmarks.

Counterpart of uncertainty_vit_tpu/evals/robustness.py (:26-183), mirroring
uncertainty_evaluations.py:393-853 of the reference: per-distortion
accuracy and the unnormalized mCE over ``DISTORTIONS``, and the stability
metrics of CIFAR-P videos (flip probability, top-5 and Zipf ranking
distances). The forward is pluggable, so the plain, MC-dropout (mean
logits), ensemble (mean member logits) and Laplace (predictive
log-probabilities) evaluations share one harness. The frames' transform
runs on the device of the forward's inputs; the ranking metrics are numpy
on the host, copied from the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Sequence

import numpy as np
import torch

from uncertainty_vit_tpu_torch.core.device import resolve
from uncertainty_vit_tpu_torch.evals import metrics as M
from uncertainty_vit_tpu_torch.evals.collect import collect_logits, pipelined_pairs
from uncertainty_vit_tpu_torch.ops.augment import (
    IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD, eval_resize_center_crop, normalize, to_float,
)

# uncertainty_evaluations.py:846-853
DISTORTIONS = (
    "gaussian_noise", "shot_noise", "impulse_noise", "defocus_blur",
    "glass_blur", "motion_blur", "zoom_blur", "snow", "frost", "brightness",
    "contrast", "elastic_transform", "pixelate", "jpeg_compression",
    "speckle_noise",
)
PERTURBATIONS = (
    "gaussian_noise", "shot_noise", "motion_blur", "zoom_blur", "snow",
    "brightness", "translate", "rotate", "tilt", "scale",
)


def evaluate_corruption(forward_fn: Callable[[torch.Tensor], torch.Tensor],
                        loader_factory: Callable[[str], Iterable],
                        distortions: Sequence[str] = DISTORTIONS) -> Dict[str, object]:
    """Per-distortion Acc@1 and the unnormalized mCE (c_evaluate: CE =
    (100 − acc)/100, mCE their mean over the distortions).
    ``loader_factory(name)`` yields (images, ..., labels) batches."""
    accs, errors, per = [], [], {}
    for name in distortions:
        logits, labels = collect_logits(forward_fn, loader_factory(name))
        acc1, _ = M.accuracy_topk(torch.from_numpy(logits), torch.from_numpy(labels))
        acc1 = float(acc1)
        accs.append(acc1)
        errors.append((100.0 - acc1) / 100.0)
        per[name] = {"acc1": acc1, "ce": errors[-1]}
    return {"per_distortion": per, "mce_unnormalized": float(np.mean(errors)),
            "mean_acc": float(np.mean(accs))}


# ---------------------------------------------------------------------------
# Perturbation (CIFAR-P) metrics
# ---------------------------------------------------------------------------

def process_p_frames(frames_u8: torch.Tensor, out_size: int = 224) -> torch.Tensor:
    """process_raw_data (uncertainty_evaluations.py:801-826): uint8 frames
    [N, H, W, C] → the shorter side resized to 256 (bicubic), centre crop
    out_size, Inception normalize, × 2 − 1."""
    imgs = eval_resize_center_crop(to_float(frames_u8), out_size, out_size / 256.0)
    return normalize(imgs, IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD) * 2.0 - 1.0


def _rankdata_ordinal_desc(frame_logits: np.ndarray) -> np.ndarray:
    """scipy rankdata(-x, method='ordinal'): rank 1 = the highest logit."""
    order = np.argsort(-frame_logits, kind="stable")
    ranks = np.empty_like(order)
    ranks[order] = np.arange(1, len(order) + 1)
    return ranks.astype(np.uint16)


def flip_prob(predictions: Sequence[np.ndarray], noise_perturbation: bool = False) -> float:
    """Frame-wise prediction flip probability
    (uncertainty_evaluations.py:765-782): for a noise perturbation each
    frame against frame 0, else against the previous frame."""
    result = 0.0
    for vid_preds in predictions:
        flips = []
        prev = vid_preds[0]
        for pred in vid_preds[1:]:
            flips.append(int(prev != pred))
            if not noise_perturbation:
                prev = pred
        result += np.mean(flips) / len(predictions)
    return float(result)


def _dist(sigma: np.ndarray, mode: str, num_classes: int = 100) -> float:
    """uncertainty_evaluations.py:829-837."""
    identity = np.arange(1, num_classes + 1)
    cum_sum_top5 = np.cumsum(np.asarray([0] + [1] * 5 + [0] * (num_classes - 1 - 5)))
    recip = 1.0 / identity
    if mode == "top5":
        return float(np.sum(np.abs(cum_sum_top5[:5] - cum_sum_top5[sigma - 1][:5])))
    if mode == "zipf":
        return float(np.sum(np.abs(recip - recip[sigma - 1]) * recip))
    raise ValueError(mode)


def ranking_dist(ranks: Sequence[np.ndarray], noise_perturbation: bool = False,
                 mode: str = "top5", num_classes: int = 100) -> float:
    """Ranking distance between frames (uncertainty_evaluations.py:743-763)."""
    result = 0.0
    for vid_ranks in ranks:
        per_vid = []
        perm1 = vid_ranks[0]
        perm1_inv = np.argsort(perm1)
        for rank in vid_ranks[1:]:
            per_vid.append(_dist(rank[perm1_inv], mode, num_classes))
            if not noise_perturbation:
                perm1 = rank
                perm1_inv = np.argsort(perm1)
        result += np.mean(per_vid) / len(ranks)
    return float(result)


def evaluate_perturbation(forward_fn: Callable[[torch.Tensor], torch.Tensor],
                          video_loader_factory: Callable[[str], Iterable],
                          num_classes: int, perturbations: Sequence[str] = PERTURBATIONS,
                          frame_size: int = 224, device=None) -> Dict[str, object]:
    """p_evaluate (uncertainty_evaluations.py:584-658): per perturbation,
    every frame of every video through ``process_p_frames`` and the
    forward, then the flip probability and the top-5 / Zipf ranking
    distances; the means of flip probability and Zipf distance over the
    perturbations. ``video_loader_factory(name)`` yields uint8 videos
    [b, T, H, W, C]; the frames go to ``device`` (the card unless the caller
    asks for the CPU)."""
    device = resolve(device)
    per: Dict[str, Dict[str, float]] = {}
    flips, zipfs = [], []
    for name in perturbations:
        is_noise = "noise" in name
        predictions: List[np.ndarray] = []
        ranks: List[np.ndarray] = []

        def dispatch(name=name):
            for videos_u8 in video_loader_factory(name):
                videos = torch.as_tensor(np.asarray(videos_u8))
                b, t = videos.shape[0], videos.shape[1]
                frames = videos.reshape(b * t, *videos.shape[2:]).to(device, non_blocking=True)
                yield forward_fn(process_p_frames(frames, frame_size)), np.array([b, t])

        # the ranking host work of batch i overlaps the forwards queued
        # behind it (evals/collect.py)
        for flat, bt in pipelined_pairs(dispatch()):
            logits = flat.reshape(int(bt[0]), int(bt[1]), num_classes)
            for vid in logits:
                predictions.append(vid.argmax(1))
                ranks.append(np.stack([_rankdata_ordinal_desc(f) for f in vid]))
        cur_flip = flip_prob(predictions, is_noise)
        cur_zipf = ranking_dist(ranks, is_noise, "zipf", num_classes)
        cur_top5 = ranking_dist(ranks, is_noise, "top5", num_classes)
        per[name] = {"flip_prob": cur_flip, "zipf": cur_zipf, "top5": cur_top5}
        flips.append(cur_flip)
        zipfs.append(cur_zipf)
    return {"per_perturbation": per, "mean_flip_prob": float(np.mean(flips)),
            "mean_zipf": float(np.mean(zipfs))}
