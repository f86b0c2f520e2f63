"""The device mesh (data × seq × model) over torch.distributed.

Counterpart of uncertainty_vit_tpu/parallel/mesh.py:21-106 (the
reference has data parallelism only, run_cyclical.py:515-519). The JAX
package shards arrays over one ``jax.sharding.Mesh`` and lets GSPMD place
the collectives; the port holds this rank's shard of every tensor and
names each collective, as ``parallel.seq`` does for the seq axis:

* ``Mesh`` lays the world's ranks out in JAX's device order,
  ``devices.reshape(n // (m·s), s, m)`` (:115-118): rank = d·s·m + q·m + t
  for data index d, seq index q and model index t, with one process group
  per slice of each axis of more than one rank.
* ``param_spec`` is the Megatron cut of the trunk (:130-148) on the port's
  torch names: qkv, its q / v biases and the rel-pos tables by heads (each
  of q, k and v cut into contiguous head groups, so that a rank's attention
  is a whole set of heads), fc1 on its output, proj and fc2 on their input
  with their bias added once, after the reduce; everything else is
  replicated. ``shard_state_dict`` / ``gather_state_dict`` move between the
  full dict and this rank's shard.
* ``copy_to_model`` / ``reduce_from_model`` are Megatron's f and g.
* The batch is split over ``data``: every rank of the mesh computes the
  whole loss from collectives in its forward (``sum_over``, ``global_max``)
  and its backward gives its share of each gradient; the optimizer sums
  the shares (``grad_reducer``): over ``seq`` for the parameters that act
  on token rows, every mini-step, and over ``data`` for all, once an
  update. (The sum of the shares of a batch mean is the mean over the
  data ranks of their shards' means.)
* Draws: ranks of one data index share their generators; every draw of a
  per-sample mask is made for the global batch and sliced
  (``rand_rows``), so the sharded step draws what the unsharded one
  draws.

``torch.distributed.device_mesh`` / DTensor are not used: the attention
kernels' autograd Functions take plain tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from uncertainty_vit_tpu_torch.parallel import seq

DATA_AXIS, SEQ_AXIS, MODEL_AXIS = "data", "seq", "model"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)


def coords(rank: int, shape: Sequence[int]) -> Tuple[int, int, int]:
    """(data, seq, model) index of ``rank`` in a mesh of ``shape``."""
    _, s, m = shape
    return rank // (s * m), (rank // m) % s, rank % m


def axis_slices(shape: Sequence[int], axis: str) -> List[List[int]]:
    """The rank lists of every slice along ``axis``: the ranks that differ
    in that index only, in a fixed order (every rank makes the groups in
    this order)."""
    a = AXES.index(axis)
    n = shape[0] * shape[1] * shape[2]
    slices: Dict[Tuple[int, ...], List[int]] = {}
    for r in range(n):
        c = coords(r, shape)
        slices.setdefault(c[:a] + c[a + 1:], []).append(r)
    return list(slices.values())


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, seq, model) mesh and the process
    groups of its three slices (None for an axis of one rank), and the
    group of all its ranks (``world``; None: the default group)."""

    shape: Tuple[int, int, int]
    rank: int
    groups: Tuple[Any, Any, Any] = (None, None, None)
    world: Any = None

    def __deepcopy__(self, memo):  # a model's copy (the EMA teacher) shares the groups
        return self

    def __reduce__(self):
        # a pickled copy (a rank's result handed to the parent) keeps the
        # layout; process groups do not cross processes
        return Mesh, (self.shape, self.rank)

    @classmethod
    def create(cls, data: Optional[int] = None, seq: int = 1, model: int = 1) -> "Mesh":
        """The mesh over the default process group's ranks; ``data``
        defaults to what the other two leave. Every rank must call it."""
        world, rank = dist.get_world_size(), dist.get_rank()
        if data is None:
            data = world // (seq * model)
        shape = (data, seq, model)
        if data * seq * model != world:
            raise ValueError(f"a mesh of {shape} does not cover a world of {world} ranks")
        groups = []
        for axis, size in zip(AXES, shape):
            mine = None
            if size > 1:
                for ranks in axis_slices(shape, axis):
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        mine = g
            groups.append(mine)
        return cls(shape, rank, tuple(groups))

    def size(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    @property
    def world_group(self) -> seq.SeqGroup:
        """Every rank of the mesh as a ``parallel.seq.SeqGroup``."""
        return seq.SeqGroup(self.rank, self.shape[0] * self.shape[1] * self.shape[2], self.world)

    def index(self, axis: str) -> int:
        return coords(self.rank, self.shape)[AXES.index(axis)]

    def group(self, axis: str) -> Any:
        return self.groups[AXES.index(axis)]

    def axis_group(self, axis: str) -> seq.SeqGroup:
        """The ranks along ``axis`` as a ``parallel.seq.SeqGroup``."""
        return seq.SeqGroup(self.index(axis), self.size(axis), self.group(axis))

    @property
    def trunk_group(self) -> seq.SeqGroup:
        """The data × seq ranks of this rank's model index, whose rows make
        the trunk of the global batch (the int8 layers' wgrad scales span
        them): every rank of a mesh whose model axis has one rank."""
        if self.size(MODEL_AXIS) > 1:
            raise NotImplementedError("the data x seq group under a model axis is not built "
                                      "(ROADMAP.md item 21)")
        return self.world_group

    @property
    def seq_group(self) -> Optional[seq.SeqGroup]:
        """The seq axis, where it splits the tokens; None for one rank."""
        return self.axis_group(SEQ_AXIS) if self.size(SEQ_AXIS) > 1 else None

    def batch_rows(self, rows: int) -> Tuple[int, int, int]:
        """(start, stop, total) of this rank's ``rows`` rows of the global
        batch split over ``data``."""
        d, n = self.index(DATA_AXIS), self.size(DATA_AXIS)
        return d * rows, (d + 1) * rows, n * rows


def active(mesh: Optional[Mesh], axis: str) -> bool:
    """Whether ``mesh`` splits over ``axis`` (more than one rank)."""
    return mesh is not None and mesh.size(axis) > 1


def data_rows(mesh: Optional[Mesh], rows: int) -> Optional[Tuple[int, int, int]]:
    """``mesh.batch_rows(rows)`` where ``mesh`` splits over ``data``, else None."""
    return mesh.batch_rows(rows) if active(mesh, DATA_AXIS) else None


def fold_index(n: int, rows: Tuple[int, int, int]) -> Tuple[torch.Tensor, int]:
    """(index, total): where the n local rows of a batch split over
    ``data`` stand in the global batch, for rows (start, stop, total) of
    this rank. n may be k·(stop − start): k folds of the rank's rows, one
    after the other (the folded MC-dropout batch tiles the global batch k
    times), so local row k·b + i is global k·total + start + i, of k·total."""
    start, stop, total = rows
    b = stop - start
    if n % b:
        raise RuntimeError(f"a draw of {n} rows for a shard of {b}")
    g = torch.arange(n)
    return (g // b) * total + start + g % b, n // b * total


def rand_rows(shape: Sequence[int], generator: torch.Generator, device,
              rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """U[0, 1) of ``shape``; with ``rows`` (start, stop, total) its first dim
    is this rank's rows [start, stop) of a batch of ``total``, or k folds of
    them (``fold_index``): drawn for the whole batch, those rows kept
    (``data_rows``)."""
    if rows is None:
        return torch.rand(tuple(shape), generator=generator, device=device)
    index, total = fold_index(shape[0], rows)
    u = torch.rand((total,) + tuple(shape[1:]), generator=generator, device=device)
    start, stop, _ = rows
    if shape[0] == stop - start:
        return u[start:stop]
    return u[index.to(u.device)]


# ---------------------------------------------------------------------------
# the Megatron cut of the parameters
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Spec:
    """A tensor cut on ``dim`` over the model axis: the dim is ``blocks``
    equal blocks (q, k, v of a fused qkv), each cut into contiguous
    pieces, and a rank holds its piece of each block."""

    dim: int
    blocks: int = 1


_BY_HEADS_QKV = ("attn.qkv.weight", "attn.cov_qkv.weight")
_DIM0 = ("attn.q_bias", "attn.v_bias", "attn.cov_q_bias", "attn.cov_v_bias",
         "mlp.fc1.weight", "mlp.fc1.bias")
_DIM1 = ("attn.proj.weight", "attn.cov_proj.weight", "mlp.fc2.weight",
         "relative_position_bias_table")


def param_spec(name: str) -> Optional[Spec]:
    """The cut of the parameter ``name`` (a torch state_dict key) over the
    model axis, or None where it is replicated."""
    if name.endswith(_BY_HEADS_QKV):
        return Spec(0, 3)
    if name.endswith(_DIM0):
        return Spec(0)
    if name.endswith(_DIM1):
        return Spec(1)
    return None


def shard_tensor(t: torch.Tensor, spec: Optional[Spec], index: int, parts: int) -> torch.Tensor:
    """Piece ``index`` of ``parts`` of a full tensor (a copy)."""
    if spec is None or parts == 1:
        return t
    if t.shape[spec.dim] % (spec.blocks * parts):
        raise ValueError(f"a dim of {t.shape[spec.dim]} does not split into {spec.blocks} "
                         f"blocks of {parts} pieces")
    blocks = t.chunk(spec.blocks, spec.dim)
    return torch.cat([b.chunk(parts, spec.dim)[index] for b in blocks], dim=spec.dim).clone()


def unshard_tensor(pieces: Sequence[torch.Tensor], spec: Spec) -> torch.Tensor:
    """The full tensor from every rank's piece, in model order."""
    per_rank = [p.chunk(spec.blocks, spec.dim) for p in pieces]
    return torch.cat([torch.cat([blocks[b] for blocks in per_rank], dim=spec.dim)
                      for b in range(spec.blocks)], dim=spec.dim)


def shard_state_dict(state: Mapping[str, torch.Tensor], mesh: Optional[Mesh]
                     ) -> Dict[str, torch.Tensor]:
    """This rank's shard of a full (``.pth``-keyed) state dict."""
    if not active(mesh, MODEL_AXIS):
        return dict(state)
    t, m = mesh.index(MODEL_AXIS), mesh.size(MODEL_AXIS)
    return {k: shard_tensor(v, param_spec(k), t, m) for k, v in state.items()}


def gather_state_dict(state: Mapping[str, torch.Tensor], mesh: Optional[Mesh]
                      ) -> Dict[str, torch.Tensor]:
    """The full state dict from every model rank's shard (an all-gather over
    the model axis: every rank of the axis must call it, in the same key
    order); the same on every rank."""
    if not active(mesh, MODEL_AXIS):
        return dict(state)
    out = {}
    for k, v in state.items():
        spec = param_spec(k)
        if spec is None:
            out[k] = v
            continue
        v = v.detach().contiguous()
        pieces = [torch.empty_like(v) for _ in range(mesh.size(MODEL_AXIS))]
        dist.all_gather(pieces, v, group=mesh.group(MODEL_AXIS))
        out[k] = unshard_tensor(pieces, spec)
    return out


def shard_batch(x: torch.Tensor, mesh: Optional[Mesh], include_seq: bool = False
                ) -> torch.Tensor:
    """This rank's rows of a global batch: split over ``data``, or over the
    (data × seq) product, data-major, with ``include_seq`` (:174-181)."""
    if mesh is None:
        return x
    parts, index = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
    if include_seq:
        parts *= mesh.size(SEQ_AXIS)
        index = index * mesh.size(SEQ_AXIS) + mesh.index(SEQ_AXIS)
    if x.shape[0] % parts:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {parts} ranks")
    rows = x.shape[0] // parts
    return x[index * rows:(index + 1) * rows]


# ---------------------------------------------------------------------------
# collectives as autograd functions
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group: Any, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The input of a column-parallel layer: the identity forward; the
    backward sums the model ranks' cotangents."""
    if not active(mesh, MODEL_AXIS):
        return x
    return _CopyTo.apply(x, mesh.group(MODEL_AXIS))


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The output of a row-parallel layer: the sum of the model ranks'
    partial products; the backward is the identity (what follows is the
    same on every model rank)."""
    if not active(mesh, MODEL_AXIS):
        return x
    return _ReduceFrom.apply(x, mesh.group(MODEL_AXIS))


def sum_over(x: torch.Tensor, mesh: Optional[Mesh], axes: Iterable[str] = (DATA_AXIS,),
             shared: bool = False) -> torch.Tensor:
    """The sum of x over the ranks of ``axes``. The backward is the identity
    where every rank computes the same thing from the sum (a loss), and,
    with ``shared``, the sum of the ranks' cotangents where each rank uses
    the sum on rows of its own (a batch statistic)."""
    for axis in axes:
        if active(mesh, axis):
            x = (seq.shared_sum(x, mesh.axis_group(axis)) if shared
                 else _ReduceFrom.apply(x, mesh.group(axis)))
    return x


def reduce_value(x: torch.Tensor, mesh: Optional[Mesh], axes: Iterable[str] = (DATA_AXIS,),
                 op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of a value that needs no gradient (counts, metrics)."""
    x = x.detach()
    for axis in axes:
        if active(mesh, axis):
            x = _all_reduce(x, mesh.group(axis), op)
    return x


class _GlobalMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        m = x.amax()
        for g in groups:
            m = seq.all_reduce_max(m, g)
        hit = (x == m)
        ties = hit.sum().to(x.dtype)
        for g in groups:
            ties = _all_reduce(ties, g.group)
        ctx.groups = groups
        ctx.save_for_backward(hit, ties)
        return m

    @staticmethod
    def backward(ctx, grad):
        # the ranks' cotangents summed by an autograd Function: the AdaHessian
        # pass differentiates this backward, and the second backward must sum
        # over the ranks in turn
        hit, ties = ctx.saved_tensors
        for g in ctx.groups:
            grad = seq.shared_sum(grad, g)
        return hit.to(grad.dtype) * (grad / ties), None


def global_max(x: torch.Tensor, mesh: Optional[Mesh], axes: Iterable[str] = (DATA_AXIS,)
               ) -> torch.Tensor:
    """The largest element of x over the ranks of ``axes`` (an all-reduce
    MAX). Every rank scales rows of its own by it, so the backward sums the
    ranks' cotangents and hands them to the elements that hold the maximum,
    split evenly over the ties of all ranks, as ``jnp.max`` splits them;
    that backward is twice differentiable (the AdaHessian pass of the dist
    loss)."""
    groups = tuple(mesh.axis_group(a) for a in axes if active(mesh, a)) if mesh is not None \
        else ()
    if not groups:
        return torch.amax(x)
    return _GlobalMax.apply(x, groups)


def flip_batch(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows of the global batch flipped: the mixing partner of
    global row i is row B−1−i, so local row i of data rank d pairs with
    local row b−1−i of rank D−1−d. An all-gather over ``data`` (gloo has no
    point-to-point collective of a group); no gradient."""
    if not active(mesh, DATA_AXIS):
        return x.flip(0)
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size(DATA_AXIS))]
    dist.all_gather(parts, x, group=mesh.group(DATA_AXIS))
    return parts[mesh.size(DATA_AXIS) - 1 - mesh.index(DATA_AXIS)].flip(0)


# ---------------------------------------------------------------------------
# the gradients
# ---------------------------------------------------------------------------

def token_parameters(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters whose gradient a seq rank holds a share of: the
    model's ``token_parameters()`` where it has them, else all."""
    fn = getattr(model, "token_parameters", None)
    return list(fn()) if fn is not None else list(model.parameters())


@dataclasses.dataclass(frozen=True)
class GradReducer:
    """Sums the ranks' gradient shares in place on tensors aligned with the
    optimizer's parameters, one flat bucketed all-reduce a group
    (``parallel.seq.sum_in_place``): ``sum_tokens`` those at ``tokens_at``
    over the ``tokens`` group, which completes a mini-step's gradient of a
    token-sharded model; ``sum_data`` all over the ``data`` group, the
    mean of the data ranks' gradients, which commutes with accumulation
    (either group None: nothing to sum). A plain object, so that an
    optimizer holding it pickles."""

    tokens: Optional[seq.SeqGroup]
    data: Optional[seq.SeqGroup]
    tokens_at: Tuple[int, ...]

    def sum_tokens(self, tensors: Sequence[torch.Tensor]) -> None:
        if self.tokens is not None:
            seq.sum_in_place([tensors[i] for i in self.tokens_at], self.tokens)

    def sum_data(self, tensors: Sequence[torch.Tensor]) -> None:
        if self.data is not None:
            seq.sum_in_place(tensors, self.data)


def grad_reducer(model: torch.nn.Module, params: Sequence[torch.nn.Parameter]
                 ) -> Optional[GradReducer]:
    """The sums of the ranks' gradient shares of ``model``'s ``params``:
    over the model's seq group for its token parameters, over ``data`` for
    all; None for a model of one process. The optimizer takes the seq sum
    every mini-step and the data sum, which is linear, once an accumulation
    window, on the window's mean. A model that does not split its tokens
    (``seq_group`` None: the dist model) holds a replica on each seq rank,
    and nothing is summed over seq."""
    mesh = getattr(model, "mesh", None)
    tokens = getattr(model, "seq_group", None)
    data = mesh.axis_group(DATA_AXIS) if active(mesh, DATA_AXIS) else None
    if tokens is None and data is None:
        return None
    mine = {id(p) for p in token_parameters(model)}
    return GradReducer(tokens, data, tuple(i for i, p in enumerate(params) if id(p) in mine))
