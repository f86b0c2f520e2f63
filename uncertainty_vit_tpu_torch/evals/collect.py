"""Pipelined device → host logits collection for the eval loops.

Counterpart of uncertainty_vit_tpu/evals/collect.py (:20-64). Reading each
batch's logits back as soon as its forward is queued would make the host
wait for the device once per batch, and the device then idles while the
host queues the next forward. ``pipelined_pairs`` keeps a window of
``depth`` batches between the dispatch front and the readback: the copy of
batch i to the host is queued right behind its forward (into pinned memory,
without blocking), and the host waits for it only after batches i+1 ..
i+depth have been queued.

On a mesh's data axis each rank evaluates its shard of the split;
``DataShards`` gathers the ranks' host logits into the split's own order,
each sample once, so that every metric is the one process's of the union.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def per_call_generator(seed: int, device) -> Callable[[], torch.Generator]:
    """Stateful stream of fresh generators on ``device``: each call returns
    a generator seeded with the next draw of a root generator seeded with
    ``seed``. For eval dispatches that draw fresh randomness per batch (the
    MC-dropout masks) without correlating the draws across the dataset;
    the counterpart of ``per_call_rng`` (:20-28), which folds a counter
    into a root key."""
    root = torch.Generator().manual_seed(seed)

    def fresh() -> torch.Generator:
        s = int(torch.randint(0, 2**63 - 1, (), generator=root, dtype=torch.int64))
        return torch.Generator(device=device).manual_seed(s)

    return fresh


def _start_readback(x) -> Tuple[object, Optional["torch.cuda.Event"]]:
    """Queue the copy of a CUDA tensor to pinned host memory behind the work
    that produces it; returns (host value, event to wait for or None)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        x = x.detach()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(x.device))
        return host, event
    return x, None


def _finish(pending) -> np.ndarray:
    value, event = pending
    if event is not None:
        event.synchronize()
    return value.detach().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def pipelined_pairs(
    pairs: Iterable[Tuple[object, object]], depth: int = 2
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(device logits, labels) stream → (host logits f32, host labels),
    reading back ``depth`` batches behind the dispatch front."""
    pending: "collections.deque" = collections.deque()

    def pop():
        logits, labels = pending.popleft()
        return _finish(logits), _finish(labels)

    for logits, labels in pairs:
        if isinstance(logits, torch.Tensor):
            logits = logits.float()
        pending.append((_start_readback(logits), _start_readback(labels)))
        if len(pending) > depth:
            yield pop()
    while pending:
        yield pop()


def collect_logits(
    forward: Callable[[torch.Tensor], torch.Tensor], batches: Iterable,
    allow_empty: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run ``forward`` over (images, ..., labels) batches with the pipelined
    window; returns the concatenated (f32 logits, labels) on the host.
    allow_empty=True returns zero-length arrays instead of raising."""
    pairs = ((forward(batch[0]), batch[-1]) for batch in batches)
    outs = list(pipelined_pairs(pairs))
    if not outs:
        if allow_empty:
            return np.zeros((0, 0), np.float32), np.zeros((0,), np.int64)
        raise ValueError("collect_logits got an empty batch stream")
    return np.concatenate([o[0] for o in outs]), np.concatenate([o[1] for o in outs])


@dataclasses.dataclass(frozen=True)
class DataShards:
    """This data rank's shard of an evaluation split, which the ranks of the
    data axis (``group``, a ``parallel.seq.SeqGroup``) read unshuffled as
    ``data.pipeline.BatchLoader`` shards it: rank d holds the split's
    samples d, d + D, d + 2D, ..., its first ``real`` rows (the loader's
    ``real_count()``) not padding. ``union`` gathers every rank's real rows
    into the split's order, on every rank: the padded duplicates are left
    out, so each metric is the one-process metric of the split."""

    group: Any
    real: int

    @classmethod
    def of(cls, mesh, loader) -> Optional["DataShards"]:
        """The shards of ``loader`` on ``mesh``'s data axis; None where the
        axis has one rank."""
        from uncertainty_vit_tpu_torch.parallel import mesh as meshlib

        if not meshlib.active(mesh, meshlib.DATA_AXIS):
            return None
        if loader.shuffle:
            raise ValueError("an evaluation's shards are read unshuffled")
        return cls(mesh.axis_group(meshlib.DATA_AXIS), loader.real_count())

    def union(self, x: np.ndarray, axis: int = 0) -> np.ndarray:
        """Every rank's real rows of x (rows along ``axis``) in the split's
        order: rank d's row j is sample d + D·j."""
        mine = np.take(x, np.arange(self.real), axis=axis)
        parts = [None] * self.group.size
        dist.all_gather_object(parts, mine, group=self.group.group)
        n = sum(p.shape[axis] for p in parts)
        out = np.empty(mine.shape[:axis] + (n,) + mine.shape[axis + 1:], mine.dtype)
        for d, part in enumerate(parts):
            index = [slice(None)] * out.ndim
            index[axis] = slice(d, None, self.group.size)
            out[tuple(index)] = part
        return out
