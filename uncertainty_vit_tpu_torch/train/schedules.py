"""Per-step LR / weight-decay schedules (utils.py:408-425 of the reference).

Counterpart of uncertainty_vit_tpu/train/schedules.py (``cosine_schedule``
:13-35, ``tri_phase_schedule`` :38-61, ``constant_schedule`` :64-69, ``ema_decay_schedule`` :71-82). A
schedule is a plain step → float function; the train step reads it on the
host and writes the value into the optimizer's param groups.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

Schedule = Callable[[int], float]


def cosine_schedule(
    base_value: float,
    final_value: float,
    total_steps: int,
    warmup_steps: int = 0,
    start_warmup_value: float = 0.0,
) -> Schedule:
    """linspace warmup (base reached at the last warmup step), then cosine
    from base to final over the remaining steps."""
    decay_steps = max(total_steps - warmup_steps, 1)
    warm_denom = max(warmup_steps - 1, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return start_warmup_value + step * (base_value - start_warmup_value) / warm_denom
        i = step - warmup_steps
        return final_value + 0.5 * (base_value - final_value) * (
            1.0 + math.cos(math.pi * i / decay_steps))

    return schedule


def tri_phase_schedule(
    base_value: float,
    final_value: float,
    total_steps: int,
    warmup_perc: float = 0.05,
    decay_perc: float = 0.05,
    start_warmup_value: float = 0.0,
) -> Schedule:
    """utils.py:427-459: linear warmup over the first warmup_perc of the
    steps, hold at base, linear decay to final over the last decay_perc."""
    if warmup_perc + decay_perc > 1:
        raise ValueError(f"tri-phase warmup {warmup_perc} + decay {decay_perc} exceeds 1")
    warmup_steps = int(warmup_perc * total_steps)
    decay_steps = int(decay_perc * total_steps)
    hold_end = total_steps - decay_steps
    warm_denom = max(warmup_steps - 1, 1)
    decay_denom = max(decay_steps - 1, 1)

    def schedule(step: int) -> float:
        if step >= hold_end:
            return base_value + (step - hold_end) * (final_value - base_value) / decay_denom
        if step < warmup_steps:
            return start_warmup_value + step * (base_value - start_warmup_value) / warm_denom
        return base_value

    return schedule


def constant_schedule(value: float) -> Schedule:
    def schedule(step: int) -> float:
        del step
        return float(value)

    return schedule


def ema_decay_schedule(decay: float, decay_init: float, ema_start_at: int) -> Schedule:
    """The EMA teacher's decay (engine_for_cyclical.py:55-56): linear from
    decay_init to decay over ema_start_at steps, then decay; in float32, as
    the JAX schedule computes it."""

    def schedule(step: int) -> float:
        d = np.float32(decay)
        if ema_start_at <= 0 or step >= ema_start_at:
            return float(d)
        warm = (np.float32(decay_init)
                + np.float32(step) * np.float32(decay - decay_init) / np.float32(ema_start_at))
        return float(warm)

    return schedule
