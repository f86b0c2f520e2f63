"""K-sample MC-dropout inference.

Counterpart of uncertainty_vit_tpu/evals/mc_dropout.py (:40-122). The
reference runs K full dataset sweeps with dropout re-enabled
(uncertainty_evaluations.py:41-89: dropout on, drop-path off); here the K
samples of a batch are one forward, and the logits are averaged over K
before the metrics, like the reference's ``mean_outputs = mean(outputs, 0)``.
Labels come straight from the batch, so K = 1 works (the reference collected
targets only on its second pass).

The model must be built with ``drop_path_rate=0`` and the finetuned dropout
rates: the forwards here run it in eval mode with ``deterministic=False``,
which switches on dropout and would switch on stochastic depth too. Under
``inference_mode`` the attention-projection and MLP-fc2 dropouts are the
fused kernel K8 (``ops/dropout.py``) and any attention dropout runs inside
K1; no backward is set up.

``_fast_dropout_key`` of the reference (:27-37) picks a cheaper bit
generator of the TPU for the masks; it has no counterpart here, where every
mask comes from the kernels' own counter-based generator.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

MCForward = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def make_mc_dropout_forward(
    model: nn.Module, num_samples: int, fold_into_batch: bool = True, split_at: int = 0
) -> MCForward:
    """Returns (images, generator) → [K, B, C] logits; ``generator`` lies on
    the images' device and seeds every mask of the call.

    Formulations (the same math when dropout is active in every block: masks
    are i.i.d. per element, so K samples of batch B are one pass over a K·B
    batch):
    - split_at > 0: shared-trunk MC-dropout. Blocks [0, split_at) run once
      with dropout off, the batch tiles K× and blocks [split_at, depth) run
      with dropout: about (split_at + K·(depth − split_at))/depth forward
      passes. Exact MC-dropout only when the trunk carries no dropout
      (``cfg.dropout_from_block >= split_at``), otherwise a last-layers
      variant.
    - fold_into_batch=True (default): tile the images to [K·B] and run one
      forward, which keeps the GEMMs at their large-batch operating point.
    - fold_into_batch=False: K passes over the batch, one after the other
      (the reference package maps one pass over K keys)."""
    if num_samples < 1:
        raise ValueError(f"num_samples must be at least 1, got {num_samples}")
    if getattr(model.cfg, "drop_path_rate", 0.0) > 0.0:
        raise ValueError("MC-dropout evaluates a model built with drop_path_rate=0 "
                         "(dropout on, stochastic depth off)")

    def forward(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            if split_at > 0:
                return model(images, generator=generator, deterministic=False,
                             mc_samples=num_samples, mc_split=split_at)
            if fold_into_batch:
                big = images.repeat((num_samples,) + (1,) * (images.ndim - 1))
                logits = model(big, generator=generator, deterministic=False)
                return logits.reshape(num_samples, images.shape[0], -1)
            return torch.stack([model(images, generator=generator, deterministic=False)
                                for _ in range(num_samples)])

    return forward


def make_mc_dropout_mean_forward(model: nn.Module, num_samples: int, split_at: int = 0
                                 ) -> MCForward:
    """Returns (images, generator) → [B, C] mean logits over the K samples."""
    fwd = make_mc_dropout_forward(model, num_samples, split_at=split_at)

    def forward(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return fwd(images, generator).mean(dim=0)

    return forward


def predictive_entropy(mean_probs: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """H[E_k p_k]: the total predictive uncertainty."""
    p = mean_probs.clamp(eps, 1.0)
    return -(p * p.log()).sum(dim=-1)


def mutual_information(sample_probs: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """BALD decomposition: H[E_k p_k] − E_k H[p_k] over [K, B, C] probs."""
    h_mean = predictive_entropy(sample_probs.mean(dim=0), eps)
    p = sample_probs.clamp(eps, 1.0)
    mean_h = (-(p * p.log()).sum(dim=-1)).mean(dim=0)
    return h_mean - mean_h
