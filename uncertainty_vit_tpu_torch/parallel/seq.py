"""Sequence (token) parallelism over a torch.distributed process group.

Counterpart of the ``seq`` axis of uncertainty_vit_tpu/parallel/mesh.py
(:21-44, 50-53): the tokens of every image are split over the ranks of a
group, and the ranks meet only in the attention's k/v all-gather
(``ops.flash_attention.seq_sharded_qkv_attention``), in the pooling and in
the gradient sum of the train step. Where JAX lets GSPMD place those
collectives, the port names them: ``gather_tokens`` (its backward the
reduce-scatter), ``all_reduce_sum`` (the pooling, identity backward),
``logsumexp_over`` (the sinkformer's column steps), ``all_reduce_max`` (the
int8 wgrad's column scales) and ``sum_in_place`` (the gradients);
``check_equal_on_ranks`` holds the ranks' copies of what must agree (the
driver's parameters after each epoch). The differentiable ones have
backwards that are differentiable in turn (the AdaHessian pass's Hz).

The collectives run on any backend ``torch.distributed`` was started with.
On one card the ranks share it over gloo, whose process group carries CUDA
tensors for ``all_gather`` and ``all_reduce`` by staging them through host
memory; gloo has no reduce-scatter, so the gather's backward is an
all-reduce and a slice. ``run_ranks`` starts such a group of processes,
and with ``mesh=(data, seq, model)`` lays them out as a
``parallel.mesh.Mesh``, whose seq axis is a ``SeqGroup``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@dataclasses.dataclass(frozen=True)
class SeqGroup:
    """A process group along one axis of ranks; on the seq axis the tokens
    of each image are split over it: rank r of S holds rows ``rows(n)`` = [r·m, min((r + 1)·m, n)) with m =
    ceil(n / S), the reference's split of the sequence padded to a multiple
    of S (flash_attention.py:1325-1332) without the pad rows. ``group=None``
    is the default group."""

    rank: int
    size: int
    group: Optional[Any] = None

    def __deepcopy__(self, memo):  # a copy of a model shares its process group
        return self

    def __reduce__(self):
        # a pickled copy (a rank's result handed to the parent) keeps the
        # layout; a process group does not cross processes
        return SeqGroup, (self.rank, self.size)

    @classmethod
    def of(cls, group: Optional[Any] = None) -> "SeqGroup":
        return cls(dist.get_rank(group), dist.get_world_size(group), group)

    def rows(self, n: int, rank: Optional[int] = None) -> Tuple[int, int]:
        """[start, stop) of the n tokens that ``rank`` (this rank by default)
        holds."""
        m = -(-n // self.size)
        r = self.rank if rank is None else rank
        return min(r * m, n), min((r + 1) * m, n)

    def shard(self, n: int) -> "SeqShard":
        """This rank's rows of a sequence of n tokens. Every rank must hold
        at least one."""
        if (self.size - 1) * -(-n // self.size) >= n:
            raise ValueError(f"{n} tokens leave a rank of {self.size} without a row")
        return SeqShard(self, n, *self.rows(n))


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """The rows [start, stop) of a sequence of n tokens that this rank of
    ``group`` holds."""

    group: SeqGroup
    n: int
    start: int
    stop: int

    def __deepcopy__(self, memo):
        return self


def _gather(x: torch.Tensor, group: SeqGroup, n: int) -> torch.Tensor:
    m = -(-n // group.size)
    if x.shape[1] < m:  # the last rank's short shard, padded for the gather
        x = torch.cat([x, x.new_zeros((x.shape[0], m - x.shape[1]) + x.shape[2:])], dim=1)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.group)
    return torch.cat([p[:, :stop - start] for p, (start, stop) in
                      zip(parts, (group.rows(n, r) for r in range(group.size)))], dim=1)


def _sum_rows(x: torch.Tensor, group: SeqGroup, n: int) -> torch.Tensor:
    total = x.contiguous().clone()
    dist.all_reduce(total, group=group.group)
    start, stop = group.rows(n)
    return total[:, start:stop].contiguous()


# The collectives below are autograd Functions whose backwards are
# Functions too (each the other's adjoint), so that a backward taken with
# ``create_graph=True`` stays in the graph and a second backward (the
# AdaHessian pass's Hz) meets the collectives it needs. A collective run in
# place inside a backward would be cut off from that graph, and Hz would
# lose every term that passes through it without an error.

class _GatherTokens(torch.autograd.Function):
    """All ranks' rows in token order; backward ``_SumTokenRows``."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _gather(x, group, n)

    @staticmethod
    def backward(ctx, grad):
        return _SumTokenRows.apply(grad, ctx.group, ctx.n), None, None


class _SumTokenRows(torch.autograd.Function):
    """The sum over the ranks of x [B, n, ...], this rank's rows kept (the
    reduce-scatter); backward ``_GatherTokens``."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _sum_rows(x, group, n)

    @staticmethod
    def backward(ctx, grad):
        return _GatherTokens.apply(grad, ctx.group, ctx.n), None, None


def gather_tokens(x: torch.Tensor, group: SeqGroup, n: int) -> torch.Tensor:
    """All ranks' rows of x [B, rows, ...] in token order: [B, n, ...],
    contiguous, the same on every rank (``all_gather(..., tiled=True)`` and
    the cut to n keys, flash_attention.py:1336-1340). Its backward sums the
    cotangent over the ranks and keeps this rank's rows, and can itself be
    differentiated (its backward is this gather)."""
    return _GatherTokens.apply(x, group, n)


def _all_reduce(x: torch.Tensor, group: SeqGroup, op=None) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op is None else op, group=group.group)
    return y


class _AllReduceSum(torch.autograd.Function):
    """Sum forward; identity backward, written as ``_Replicated``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _Replicated.apply(grad, ctx.group), None


class _Replicated(torch.autograd.Function):
    """Identity forward; sum backward (``_AllReduceSum``): the cotangent of
    a value every rank holds alike, whose second backward receives each
    rank's share of a cotangent and must sum them."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: SeqGroup) -> torch.Tensor:
    """The sum of x over the ranks. The backward is the identity: every rank
    computes the same loss from the sum, so each passes its own cotangent
    on, and the gradient sum (``sum_in_place``) adds the ranks' shares. That
    identity is itself differentiable, as a sum: in a second backward each
    rank holds its share of the cotangent of the first backward's value,
    and the ranks' shares add (Megatron's f and g, each the other's
    backward)."""
    return _AllReduceSum.apply(x, group)


class _SharedSum(torch.autograd.Function):
    """Sum forward and backward (self-adjoint): a sum every rank uses on
    rows of its own."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _SharedSum.apply(grad, ctx.group), None


def shared_sum(x: torch.Tensor, group: SeqGroup) -> torch.Tensor:
    """The sum of x over the ranks, where every rank uses the sum on rows of
    its own (a batch statistic, a sinkformer's column logsumexp): the
    backward sums the ranks' cotangents, and is differentiable in turn."""
    return _SharedSum.apply(x, group)


def logsumexp_over(x: torch.Tensor, dim: int, group: SeqGroup) -> torch.Tensor:
    """log Σ exp(x) over ``dim`` and over the ranks, whose rows of ``dim``
    together make the whole (a max, then a sum of exponentials): the same
    on every rank. Each rank uses it on rows of its own, so its gradient sums
    the ranks' cotangents (``_SharedSum``) and hands each element its
    softmax weight; twice differentiable."""
    with torch.no_grad():
        m = _all_reduce(x.detach().amax(dim=dim, keepdim=True), group, dist.ReduceOp.MAX)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = shared_sum(torch.exp(x - m).sum(dim=dim, keepdim=True), group)
    return (torch.log(s) + m).squeeze(dim)


def all_reduce_max(x: torch.Tensor, group: SeqGroup) -> torch.Tensor:
    """The elementwise max of x over the ranks, a new tensor, outside
    autograd (the int8 wgrad's column amaxes: a max is exact, so every rank
    holds the scales of the whole trunk)."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


# Elements of one all-reduce in sum_in_place: bounds the flat buffer (and
# gloo's host copy of it) at 256 MB of f32.
_BUCKET = 1 << 26


def sum_in_place(tensors: Sequence[torch.Tensor], group: SeqGroup) -> None:
    """Sums each tensor over the ranks, in place, a bucket of tensors
    flattened into one tensor per all-reduce (the gradient sum of a train
    step). Every rank must pass tensors of the same shapes, in the same
    order."""
    tensors = list(tensors)
    i = 0
    while i < len(tensors):
        j, size = i, 0
        while j < len(tensors) and (j == i or size + tensors[j].numel() <= _BUCKET):
            size += tensors[j].numel()
            j += 1
        bucket = tensors[i:j]
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group.group)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))
        i = j


def check_equal_on_ranks(tensors: Iterable[torch.Tensor], group: SeqGroup, what: str) -> None:
    """Raises unless every rank holds the same values: each tensor's f64 sum
    of its elements and of their squares, gathered and compared exactly."""
    t = [x.detach().double() for x in tensors]
    digest = torch.stack([torch.stack([x.sum() for x in t]),
                          torch.stack([(x * x).sum() for x in t])])
    parts = [torch.empty_like(digest) for _ in range(group.size)]
    dist.all_gather(parts, digest, group=group.group)
    differ = [r for r, p in enumerate(parts) if not torch.equal(p, parts[0])]
    if differ:
        raise RuntimeError(f"{what} differ between rank 0 and ranks {differ} of the group")


def _rank_main(fn, rank, size, init_method, args, results, timeout, mesh):
    try:
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=size,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            if mesh is None:
                first = SeqGroup.of()
            else:
                from uncertainty_vit_tpu_torch.parallel.mesh import Mesh

                first = Mesh.create(*mesh)
            out = fn(first, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable[..., Any], size: int, *args: Any, timeout: float = 900.0,
              mesh: Optional[Tuple[int, int, int]] = None) -> List[Any]:
    """Runs ``fn(group, *args)`` in ``size`` new processes, one gloo group
    over them (a ``file://`` rendezvous in a temporary directory), and
    returns each rank's result in rank order. With ``mesh`` (data, seq,
    model), whose product is ``size``, ``fn`` takes the rank's
    ``parallel.mesh.Mesh`` in place of the group. ``fn`` must be importable by
    name (a module-level function), and its arguments and result picklable;
    return tensors on the CPU. Raises with the failing ranks' tracebacks when
    a rank raises, dies or does not finish within ``timeout`` seconds; every
    process is stopped before it returns or raises."""
    if mesh is not None and mesh[0] * mesh[1] * mesh[2] != size:
        raise ValueError(f"a mesh of {tuple(mesh)} does not hold {size} ranks")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(fn, rank, size, init_method, args, results,
                                                      timeout, mesh), daemon=True)
                 for rank in range(size)]
        for p in procs:
            p.start()
        done, failures, seen_dead = {}, [], set()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < size and not failures:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue_lib.Empty:
                    dead = {r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None}
                    # a rank found dead twice, a poll apart, left nothing in the queue
                    if dead & seen_dead:
                        failures.append(f"ranks {sorted(dead & seen_dead)} exited without a result")
                    elif time.monotonic() > deadline:
                        failures.append(f"no result within {timeout} s")
                    seen_dead = dead
                    continue
                if ok:
                    done[rank] = payload
                else:
                    failures.append(f"rank {rank}:\n{payload}")
        finally:
            for p in procs:
                p.join(timeout=10 if not failures else 0.1)
                if p.is_alive():
                    p.terminate()
                    p.join()
        if failures:
            raise RuntimeError("run_ranks failed: " + "\n".join(failures))
        return [pickle.loads(done[r]) for r in range(size)]
