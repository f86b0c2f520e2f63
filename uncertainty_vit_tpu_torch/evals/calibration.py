"""Temperature scaling (Guo et al. 2017): the post-hoc calibration baseline
the reference's metric suite measures against but never provides.

Counterpart of uncertainty_vit_tpu/evals/calibration.py (:37-159). T* =
argmin_T NLL(logits / T, labels) on a two-pass log-spaced grid: 64
temperatures over [t_min, t_max], then 64 inside the bracket around the
first pass's best; each NLL is one reduction over the fit set on the
logits' device (never a [grid, N, C] intermediate), every point of a pass
is queued before the one readback of the pass. The answer is the
log-midpoint of the final bracket.

Fit split (the driver's --temp_scaling_split): the eval split itself by
default, a held-out carve-out of it (``heldout_split``: a seeded numpy
permutation, the JAX package's indices to the bit), or the train split.
Under a ``parallel.mesh.Mesh`` whose data axis splits the fit set, each
rank's curve is weighted by its sample count and the curves and counts are
summed over the axis, as the JAX package sums each host's
(``_gather_weighted``, :51-61): every rank fits the same T. The ranks of a
seq group each hold every sample and sum over nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from uncertainty_vit_tpu_torch.core.device import resolve
from uncertainty_vit_tpu_torch.evals import metrics as M
from uncertainty_vit_tpu_torch.evals.collect import collect_logits
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib


def nll_at_temperature(logits: torch.Tensor, labels: torch.Tensor, t) -> torch.Tensor:
    lp = torch.log_softmax(logits / t, dim=-1)
    return -lp.gather(1, labels.long()[:, None]).mean()


def _nll_curve(logits: torch.Tensor, labels: torch.Tensor, grid: np.ndarray,
               mesh=None) -> np.ndarray:
    """The fit set's NLL at each grid temperature: every point queued, then
    one readback of the stacked curve; under ``mesh`` the count-weighted
    mean over the data axis's shards."""
    curve = torch.stack([nll_at_temperature(logits, labels, float(t)) for t in grid])
    if meshlib.active(mesh, meshlib.DATA_AXIS):
        n = labels.shape[0]
        # an empty shard's NaN curve weighs nothing
        total = meshlib.reduce_value(torch.cat([curve.nan_to_num(0.0) * n,
                                                curve.new_full((1,), n)]), mesh)
        curve = total[:-1] / total[-1]
    return curve.double().cpu().numpy()


def fit_temperature(logits, labels, t_min: float = 0.05, t_max: float = 20.0,
                    grid_points: int = 64, device=None, mesh=None) -> float:
    """Scalar T minimizing the fit set's NLL (see the module doc). ``logits``
    and ``labels`` are tensors or host arrays; the curves are computed on
    ``device`` (the logits' own when they are a tensor, else the card unless
    the caller asks for the CPU). Under ``mesh`` they are this data rank's
    shard of the fit set (a shard may be empty, not all of them)."""
    if device is None and isinstance(logits, torch.Tensor):
        device = logits.device
    device = resolve(device)
    logits = torch.as_tensor(logits).to(device, torch.float32)
    labels = torch.as_tensor(labels).to(device)
    if labels.shape[0] == 0 and not meshlib.active(mesh, meshlib.DATA_AXIS):
        raise ValueError("fit_temperature got an empty fit set")
    lo, hi = float(t_min), float(t_max)
    for _ in range(2):  # coarse bracket, then fine grid inside it
        grid = np.logspace(np.log10(lo), np.log10(hi), grid_points)
        curve = _nll_curve(logits, labels, grid, mesh)
        if not np.isfinite(curve).all():
            raise ValueError("fit_temperature got an empty fit set on every rank")
        i = int(np.argmin(curve))
        lo = float(grid[max(i - 1, 0)])
        hi = float(grid[min(i + 1, grid_points - 1)])
    return float(np.sqrt(lo * hi))  # log-midpoint of the final bracket


def heldout_split(n: int, frac: float, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic (fit_idx, report_idx) carve-out of an n-sample set: a
    seeded shuffle, the first ceil(frac·n) samples fit T*, the rest are
    reported on (Guo et al.'s held-out protocol when the dataset ships no
    calibration split). Both sides are non-empty for n ≥ 2."""
    if not 0.0 < frac < 1.0:
        raise ValueError(f"heldout fraction must be in (0, 1), got {frac}")
    if n < 2:
        raise ValueError(f"cannot carve a held-out split from {n} samples")
    k = min(max(int(np.ceil(frac * n)), 1), n - 1)
    perm = np.random.RandomState(seed).permutation(n)
    return perm[:k], perm[k:]


def evaluate_temperature_scaled(
    forward: Callable[[torch.Tensor], torch.Tensor],
    eval_batches: Iterable,
    fit_batches: Optional[Iterable] = None,
    heldout_frac: Optional[float] = None,
    heldout_seed: int = 0,
    device=None,
) -> Dict[str, float]:
    """Fit T (on ``fit_batches`` if given; else on a held-out carve-out of the
    eval split when ``heldout_frac`` is set; else on the eval split itself)
    and report the calibration suite at logits / T* on ``device`` (the
    card unless the caller asks for the CPU), with "temperature" (and
    "heldout_fit_samples" under heldout_frac). Log-probabilities are valid
    logits for every metric."""
    device = resolve(device)
    if fit_batches is not None and heldout_frac is not None:
        raise ValueError("pass fit_batches OR heldout_frac, not both")
    logits, labels = collect_logits(forward, eval_batches)
    n_heldout = 0
    if fit_batches is not None:
        fit_logits, fit_labels = collect_logits(forward, fit_batches)
    elif heldout_frac is not None:
        fit_idx, rep_idx = heldout_split(int(labels.shape[0]), heldout_frac, heldout_seed)
        fit_logits, fit_labels = logits[fit_idx], labels[fit_idx]
        logits, labels = logits[rep_idx], labels[rep_idx]
        n_heldout = int(fit_idx.shape[0])
    else:
        fit_logits, fit_labels = logits, labels
    t = fit_temperature(fit_logits, fit_labels, device=device)
    out = M.classification_metrics(torch.from_numpy(logits).to(device) / t,
                                   torch.from_numpy(labels).to(device))
    out["loss"] = out["nll"]
    out = {k: float(v) for k, v in out.items()}
    out["temperature"] = t
    if heldout_frac is not None:
        out["heldout_fit_samples"] = float(n_heldout)
    return out
