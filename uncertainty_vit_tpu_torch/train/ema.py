"""EMA copies of the parameters: the finetune model EMA and the cyclical
(data2vec) teacher.

Counterpart of uncertainty_vit_tpu/train/ema.py (``ema_update`` :17-21,
``ema_on_update_boundary`` :24-37, ``cyclical_ema_step`` :40-67; timm
ModelEmaV2 and engine_for_cyclical.py:55-56, 182-185 of the reference):
e ← d·e + (1−d)·m. The port updates the EMA tensors in place (one copy of
the parameters instead of two), in f32, with one ``torch._foreach_*`` call
per op over all of them. The decay is a host number: the cyclical rule's
warm-up and freeze depend only on the step, which the host holds.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from uncertainty_vit_tpu_torch.train.schedules import ema_decay_schedule

Tensors = Dict[str, torch.Tensor]


@torch.no_grad()
def _blend(ema_params: Tensors, params: Tensors, decay: float, rest: float) -> Tensors:
    """e ← decay·e + rest·m for every name, in place."""
    names = list(ema_params)
    ema = [ema_params[k] for k in names]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [params[k].to(ema_params[k].dtype) for k in names], alpha=rest)
    return ema_params


def ema_update(ema_params: Tensors, params: Tensors, decay: float) -> Tensors:
    """e ← decay·e + (1−decay)·m for every name, in place; returns ema_params."""
    return _blend(ema_params, params, decay, 1.0 - decay)


def ema_on_update_boundary(update_fn: Callable[[], Tensors], ema_params: Tensors, step: int,
                           update_freq: int) -> Tensors:
    """Run ``update_fn()`` only where a gradient-accumulation window ends
    ((step + 1) % update_freq == 0, engine_for_finetuning.py:110-127)."""
    if update_freq <= 1 or (step + 1) % update_freq == 0:
        return update_fn()
    return ema_params


def cyclical_ema_decay(step: int, decay: float, decay_init: float, ema_start_at: int,
                       start_lr_decay_at_step: int = -1) -> float:
    """The cyclical teacher's decay at update ``step``: warmed linearly from
    decay_init to decay over ema_start_at updates, and 1 (a frozen teacher)
    once ``start_lr_decay_at_step`` (when ≥ 0) is passed."""
    cur = ema_decay_schedule(decay, decay_init, ema_start_at)(step)
    frozen = cur == 1.0 or (0 <= start_lr_decay_at_step < step)
    return 1.0 if frozen else cur


def cyclical_ema_step(ema_params: Tensors, params: Tensors, step: int, decay: float,
                      decay_init: float, ema_start_at: int,
                      start_lr_decay_at_step: int = -1) -> Tensors:
    """The exact cyclical EMA rule (engine_for_cyclical.py:55-56, 182-185)
    at update ``step``, in place; a frozen teacher is left as it is."""
    d = cyclical_ema_decay(step, decay, decay_init, ema_start_at, start_lr_decay_at_step)
    if d == 1.0:
        return ema_params
    # the JAX rule's decay is an f32 array, so 1 − d is formed in f32 too
    return _blend(ema_params, params, d, float(np.float32(1.0) - np.float32(d)))
