"""Parameter initializers matching the reference's torch init semantics.

Counterpart of uncertainty_vit_tpu/core/init.py. An initializer here is a
callable ``init(tensor, generator)`` that fills the tensor in place from the
given ``torch.Generator`` (which must live on the tensor's device) and
returns it. The reference initializes Linear/LayerNorm with timm
``trunc_normal_(std=.02)`` (absolute truncation at ±2.0), the cyclical zoo
with ``trunc_normal_(std, a=-std, b=std)``, and leaves the patch-embed conv
at torch defaults (U(±1/sqrt(fan_in)) for weight and bias). The image
tokenizers take flax's defaults, as the JAX package builds them: a conv's
``lecun_normal`` kernel, an embedding's ``normal(1/sqrt(features))``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Init = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def trunc_normal(std: float = 0.02, abs_bound: float = 2.0) -> Init:
    """timm trunc_normal_ semantics: N(0, std) truncated to [-abs_bound, abs_bound]."""

    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            return torch.nn.init.trunc_normal_(
                t, 0.0, std, -abs_bound, abs_bound, generator=generator
            )

    return init


def torch_linear_default(fan_in: int) -> Init:
    """torch nn.Linear/Conv2d default init, for the weight and the bias alike:
    U(-1/sqrt(fan_in), +1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)

    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            return t.uniform_(-bound, bound, generator=generator)

    return init


def lecun_normal(fan_in: int) -> Init:
    """flax's default kernel init, variance_scaling(1, "fan_in",
    "truncated_normal"): N(0, s) truncated to ±2s, with s = sqrt(1/fan_in)
    / 0.8796 (the std of a standard normal truncated to ±2), so that the
    truncated draw has variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978

    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                               generator=generator)

    return init


def normal(std: float) -> Init:
    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            return t.normal_(0.0, std, generator=generator)

    return init


def zeros(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    with torch.no_grad():
        return t.zero_()


def constant(value: float) -> Init:
    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            return t.fill_(value)

    return init


def scaled(base_init: Init, factor: float) -> Init:
    """Post-scale an initializer (fix_init_weight rescale of attn-proj / fc2
    weights by 1/sqrt(2·layer_id), modeling_finetune.py:443-449; head init
    ×init_scale, :438-441)."""

    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        base_init(t, generator)
        with torch.no_grad():
            return t.mul_(factor)

    return init
