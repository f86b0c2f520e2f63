"""Deep-ensemble evaluation over stacked parameters.

Counterpart of uncertainty_vit_tpu/evals/ensembles.py (:18-37). The
reference loads its member checkpoints one after the other
(engine_for_finetuning.py:224-343); the JAX package stacks the member
parameter trees on a leading axis and maps one forward over it. Here the
members' state dicts are stacked the same way and one model runs each
member's slice through ``torch.func.functional_call``, so the members share
one module and nothing is copied into it. The ensemble's prediction is the
metrics of the mean member logits (:288-300). A gumbel or dual_sto model
draws its noise from the forward's ``generator``.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
import torch.nn as nn
from torch.func import functional_call


def stack_params(member_params: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Stack M state dicts into one dict of tensors with a leading member
    axis."""
    keys = list(member_params[0])
    for m in member_params[1:]:
        if list(m) != keys:
            raise ValueError("ensemble members hold different parameters")
    return {k: torch.stack([m[k] for m in member_params]) for k in keys}


def make_ensemble_forward(model: nn.Module) -> Callable[..., torch.Tensor]:
    """Returns (stacked state dict, images, generator=None) → [M, B, C]
    member logits, in eval mode under inference_mode; the members draw
    their Gumbel noise, one after the other, from ``generator``."""

    def forward(stacked: Mapping[str, torch.Tensor], images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        model.eval()
        members = next(iter(stacked.values())).shape[0]
        kwargs = {} if generator is None else {"gumbel_generator": generator}
        with torch.inference_mode():
            return torch.stack([
                functional_call(model, {k: v[m] for k, v in stacked.items()}, (images,), kwargs)
                for m in range(members)
            ])

    return forward


def ensemble_mean_logits(member_logits: torch.Tensor) -> torch.Tensor:
    """[M, B, C] → [B, C] mean-logit combination (engine_for_finetuning.py:288-300)."""
    return member_logits.mean(dim=0)
