"""Observability: metric smoothing, console telemetry, TensorBoard, JSONL,
and a profiler trace.

Counterpart of uncertainty_vit_tpu/utils/logging.py (``SmoothedValue`` :25,
``device_memory_mb`` :69, ``MetricLogger`` :77, ``TensorboardLogger`` :128,
``JsonlLogger`` :159, ``profile_trace`` :179), which mirrors the reference's
utils.py:34-201 and its rank-0 JSON-lines epoch log. The peak memory is
``torch.cuda.max_memory_allocated`` of the current card (0 without one), and
the trace is ``torch.profiler``'s, written where TensorBoard's profiler
plugin reads it. ``TensorboardLogger`` does nothing where
``torch.utils.tensorboard`` cannot be imported.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch


class SmoothedValue:
    """Windowed median / average and the global average (utils.py:34-93).
    The values are already reduced over the batch by the train step."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


def device_memory_mb() -> float:
    """Peak memory allocated on the current card, in MiB (0 without one)."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 1024 / 1024


class MetricLogger:
    """Console telemetry with iteration / data timing and ETA
    (utils.py:96-177)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        total = len(iterable) if hasattr(iterable, "__len__") else None
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    print(
                        f"{header} [{i}/{total}]  eta: {eta_str}  {self}  "
                        f"time: {iter_time}  data: {data_time}  "
                        f"mem: {device_memory_mb():.0f}MB",
                        flush=True,
                    )
                else:
                    print(f"{header} [{i}]  {self}  time: {iter_time}", flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}", flush=True)

    def epoch_summary(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}


class TensorboardLogger:
    """Step-keeping TensorBoard writer (utils.py:180-201); does nothing when
    torch.utils.tensorboard cannot be imported or ``log_dir`` is None."""

    def __init__(self, log_dir: Optional[str]):
        self.writer = None
        self.step = 0
        if log_dir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(log_dir=log_dir)
        except Exception:
            self.writer = None

    def set_step(self, step: Optional[int] = None):
        self.step = step if step is not None else self.step + 1

    def update(self, head: str = "scalar", step: Optional[int] = None, **kwargs):
        if self.writer is None:
            return
        for k, v in kwargs.items():
            if v is None:
                continue
            self.writer.add_scalar(f"{head}/{k}", float(v), self.step if step is None else step)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()


class JsonlLogger:
    """Per-epoch JSON-lines log.txt (run_cyclical.py:640-646)."""

    def __init__(self, output_dir: str, name: str = "log.txt"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, name)

    def write(self, record: Dict[str, Any]):
        with open(self.path, "a") as f:
            f.write(json.dumps({k: _jsonable(v) for k, v in record.items()}) + "\n")


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return float(v)
    return v


class profile_trace:
    """``torch.profiler`` trace (host and card activity) of the steps run
    inside, written to log_dir as a Chrome / TensorBoard trace on exit."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.log_dir = log_dir
        self.enabled = enabled
        self.prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities,
                                on_trace_ready=tensorboard_trace_handler(self.log_dir))
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False
