"""ViT building blocks (torch.nn).

Counterpart of uncertainty_vit_tpu/models/layers.py. Numerical semantics
follow the reference's modeling_finetune.py, as the JAX modules do; layout is
the same: images NHWC, a compute dtype that is an argument (bfloat16 on the
card), parameters float32 under the reference's torch names and shapes, so
that ``utils.checkpoint.load_flax_params`` loads the JAX params with
``strict=True``. Every module initializes its parameters from an explicit
``torch.Generator`` on its ``device``; ``device=None`` is the current CUDA
device (``core.device``), never the CPU.

A forward's randomness is switched per call: ``deterministic=None`` follows
the module's train/eval mode, True or False overrides it, as the
reference's modules take ``deterministic`` per call (the split-trunk
MC-dropout forward runs some blocks with dropout and some without in one
pass).

Under sequence parallelism (``seq_shard``, a ``parallel.seq.SeqShard``; the
reference's ``seq_mesh``) a block sees only this rank's token rows. Its
draws are those of the unsharded model: a dropout mask is drawn for all n
tokens and this rank's rows kept, a drop-path mask per image (the same on
every rank, from generators of one seed).

``attn_variant`` "gumbel" and "dual_sto" draw Gumbel noise on every forward,
evaluation included (F.gumbel_softmax of the reference), from the
forward's ``gumbel_generator``, a stream of its own.

``record_draws()`` / ``replay_draws()`` let the AdaHessian pass recompute a
train step's loss on the same dropout and drop-path masks (the reference's
double backward runs through the step's own graph).

Under a ``parallel.mesh.Mesh`` (``mesh``) the batch is split over its data
axis: a model's forward runs inside ``batch_shard``, so that each dropout
and drop-path mask is drawn for the global batch and this rank's rows kept
(the draws of the unsharded model). Its model axis cuts the trunk as
Megatron does (the reference's tensor-parallel specs, parallel/mesh.py:
130-148): ``Attention`` holds H/T of the heads (its qkv rows, q / v biases
and rel-pos table columns) and runs the attention kernels on them,
``Mlp`` H/T of fc1's outputs; proj and fc2 are row-parallel, their partial
products summed by ``parallel.mesh.reduce_from_model`` before the bias and
the layer scale. Under a model axis the int8 trunk, training attention
dropout (K1's mask counter is the local head index) and the other
attention variants raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.core import init as I
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.ops import philox, relpos
from uncertainty_vit_tpu_torch.ops import quant as quant_ops
from uncertainty_vit_tpu_torch.ops.attention import VARIANTS, gumbel_softmax_probs, naive_attention
from uncertainty_vit_tpu_torch.ops.dropout import fused_dropout
from uncertainty_vit_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIM, fused_qkv_attention, in_plain_only, seq_sharded_qkv_attention,
)
from uncertainty_vit_tpu_torch.ops.losses import at_least_f32
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
from uncertainty_vit_tpu_torch.parallel import seq


def _require_generator(generator: Optional[torch.Generator], what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{what} in training draws from an explicit torch.Generator; "
                         "pass generator= to the model's forward")
    return generator


class DrawLog:
    """The dropout and drop-path uniforms of one forward, in draw order
    (``record_draws``), handed out again in that order (``replay_draws``)."""

    def __init__(self) -> None:
        self.draws: List[torch.Tensor] = []
        self.replaying = False
        self.next = 0
        # the replay's own stream for what is not replayed (attention dropout)
        self.generator: Optional[torch.Generator] = None


_DRAW_LOG: Optional[DrawLog] = None
# (start, stop, total): this rank's rows of the global batch, inside batch_shard
_BATCH_ROWS: Optional[Tuple[int, int, int]] = None


@contextlib.contextmanager
def batch_shard(mesh: Optional[meshlib.Mesh], rows: int) -> Iterator[None]:
    """Inside, every dropout and drop-path mask of a forward on ``rows``
    rows of a batch split over ``mesh``'s data axis is drawn for the global
    batch and this rank's rows kept; nothing changes without a data axis."""
    global _BATCH_ROWS
    prev, _BATCH_ROWS = _BATCH_ROWS, meshlib.data_rows(mesh, rows)
    try:
        yield
    finally:
        _BATCH_ROWS = prev


@contextlib.contextmanager
def record_draws() -> Iterator[DrawLog]:
    """Record every dropout / drop-path uniform the forwards inside draw."""
    global _DRAW_LOG
    prev, _DRAW_LOG = _DRAW_LOG, DrawLog()
    try:
        yield _DRAW_LOG
    finally:
        _DRAW_LOG = prev


@contextlib.contextmanager
def replay_draws(log: DrawLog, generator: Optional[torch.Generator]) -> Iterator[DrawLog]:
    """Hand the recorded uniforms out again, in order, to the forwards
    inside; ``generator`` draws the attention-dropout masks and seeds there
    (the one draw not replayed: the kernel route of the recorded forward
    drew a seed where the plain route draws a whole mask, JAX
    optim.py:297-300). Raises unless every draw is taken, each at its
    recorded shape."""
    global _DRAW_LOG
    log.replaying, log.next, log.generator = True, 0, generator
    prev, _DRAW_LOG = _DRAW_LOG, log
    try:
        yield log
    finally:
        _DRAW_LOG = prev
        log.replaying = False
    if log.next != len(log.draws):
        raise RuntimeError(f"the replayed forward took {log.next} of {len(log.draws)} "
                           "recorded draws")


def _uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """u ~ U[0, 1) of ``shape`` from ``generator``: the masks of dropout and
    drop-path, recorded or replayed under ``record_draws`` / ``replay_draws``."""
    log = _DRAW_LOG
    if log is not None and log.replaying:
        if log.next >= len(log.draws) or tuple(log.draws[log.next].shape) != tuple(shape):
            raise RuntimeError("the replayed forward draws other masks than the recorded one")
        log.next += 1
        return log.draws[log.next - 1]
    u = meshlib.rand_rows(shape, generator, device, _BATCH_ROWS)
    if log is not None:
        log.draws.append(u)
    return u


def _attention_generator(generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
    """The generator attention dropout draws from: the forward's, or under
    ``replay_draws`` the replay's own stream."""
    log = _DRAW_LOG
    return log.generator if log is not None and log.replaying else generator


def drop_path(
    x: torch.Tensor, rate: float, training: bool,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Stochastic depth per sample (modeling_finetune.py:51-62 / timm drop_path);
    the mask comes from ``generator`` (JAX models/layers.py:29-48 draws it
    from the "droppath" rng)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    u = _uniform(shape, _require_generator(generator, "drop-path"), x.device)
    return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


def dropout(
    x: torch.Tensor, rate: float, training: bool,
    generator: Optional[torch.Generator] = None,
    shard: Optional[seq.SeqShard] = None,
) -> torch.Tensor:
    """Inverted dropout with its mask from ``generator`` (flax nn.Dropout).
    With ``shard``, x [B, rows, ...] holds its rows of n tokens: the mask is
    drawn for [B, n, ...] and those rows kept."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    gen = _require_generator(generator, "dropout")
    if shard is None:
        u = _uniform(x.shape, gen, x.device)
    else:
        u = _uniform((x.shape[0], shard.n) + x.shape[2:], gen, x.device)
        u = u[:, shard.start:shard.stop]
    return torch.where(u < keep, x / keep, 0.0).to(x.dtype)


def site_dropout(
    x: torch.Tensor, rate: float, active: bool,
    generator: Optional[torch.Generator] = None,
    shard: Optional[seq.SeqShard] = None,
) -> torch.Tensor:
    """The dropout of the attention-projection and MLP-fc2 sites (``_dropout``
    of the reference's models/layers.py:66-77). When no gradient is wanted
    (the MC-dropout evaluation) it is the fused kernel K8,
    ``ops.dropout.fused_dropout``, seeded from ``generator``; under grad
    mode, or inside ``flash_attention.plain_only()``, it is ``dropout``: K8
    is forward only, as in the reference. K8's mask follows the position in
    x, so under a ``shard`` it is not ported."""
    if not active or rate == 0.0:
        return x
    if torch.is_grad_enabled() or in_plain_only():
        return dropout(x, rate, True, generator, shard)
    if shard is not None:
        raise NotImplementedError("MC-dropout under a seq group is not ported yet")
    seed = philox.draw_seed(_require_generator(generator, "dropout"), x.device)
    return fused_dropout(x.contiguous(), rate, seed)


def _use_quant(quant: str, x: torch.Tensor, features: int,
               shard: Optional[seq.SeqShard] = None) -> bool:
    """Whether a dense layer of x's shape with ``features`` outputs is an
    int8 matmul: the flag, and the shapes ``quant.supported`` admits
    (``_use_quant`` of the reference's models/layers.py:51-63, which does not
    look at ``deterministic``: evaluation runs the int8 forward too). The
    reference decides on its whole [B·N, C] trunk, so under a ``shard``
    (x [B, rows, C] of n tokens) the token count is B·n, the same on every
    rank, not this rank's rows. The reference's backend test has no
    counterpart: ``ops.quant``'s wrappers take the kernel or its plain
    version by the tensor's device. Inside ``flash_attention.plain_only()``
    every dense layer is the plain one (the reference's :58-59)."""
    if quant != "int8" or in_plain_only():
        return False
    m = x.numel() // x.shape[-1] if shard is None else x.shape[0] * shard.n
    return quant_ops.supported(m, x.shape[-1], features)


def _quant_seed(x: torch.Tensor, active: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """The seed of one int8 layer's stochastic gradient rounding: drawn from
    the forward's generator when the forward draws, a fixed zero otherwise
    (``_quant_seed`` of the reference's models/layers.py:80-87)."""
    if active:
        return philox.draw_seed(_require_generator(generator, "int8 stochastic rounding"),
                                x.device)
    return torch.zeros(1, dtype=torch.int64, device=x.device)


def _active(module: nn.Module, deterministic: Optional[bool]) -> bool:
    """Whether a forward draws: the call's ``deterministic`` when given, else
    the module's train mode."""
    return module.training if deterministic is None else not deterministic


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in f32 with f32 params; the result is f32 (as
    flax's LayerNorm promotes a bf16 input against its f32 params). A
    float64 input (a float64 copy of a model) stays float64."""
    return F.layer_norm(x.to(at_least_f32(x.dtype)), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


def _uniform_init(low: float, high: float) -> I.Init:
    """torch.nn.init.uniform_(a=low, b=high) from the generator."""
    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return t.uniform_(low, high, generator=generator)

    return init


def _param(shape, init: I.Init, device, generator) -> nn.Parameter:
    return nn.Parameter(init(torch.empty(shape, dtype=torch.float32, device=device), generator))


class _Params(nn.Module):
    """A weight and an optional bias under the reference's names (``weight``
    in torch's [out, in, ...] layout, ``bias``)."""

    def __init__(self, weight_shape, weight_init: I.Init, bias_shape=None,
                 bias_init: I.Init = I.zeros, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = _param(weight_shape, weight_init, device, generator)
        self.bias = None if bias_shape is None else _param(bias_shape, bias_init, device, generator)


class PatchEmbed(nn.Module):
    """Patchifier → [B, N, C] (modeling_finetune.py:304-325), NHWC input.

    The stride-p conv is computed as space-to-depth + matmul, as the JAX
    module does; the parameter keeps torch's conv layout [C, in, p, p].
    ``weight_init`` "torch" is torch's Conv2d default (the finetune zoo);
    ("trunc", std) the cyclical zoo's: the weight trunc_normal(std) bounded
    at ±std, the bias zero (JAX models/layers.py:120-133,
    modeling_cyclical.py:158-161)."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 768,
                 dtype: torch.dtype = torch.float32, weight_init="torch", *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.patch_size, self.embed_dim, self.dtype = patch_size, embed_dim, dtype
        fan_in = in_chans * patch_size * patch_size
        if weight_init == "torch":
            w_init = b_init = I.torch_linear_default(fan_in)
        else:
            _, std = weight_init
            w_init, b_init = I.trunc_normal(std, std), I.zeros
        self.proj = _Params((embed_dim, in_chans, patch_size, patch_size), w_init, (embed_dim,),
                            b_init, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        b, h, w, c = x.shape
        gh, gw = h // p, w // p
        # space-to-depth: patch-major rows [py, px, c]
        patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, gh * gw, p * p * c).to(self.dtype)
        wm = self.proj.weight.permute(0, 2, 3, 1).reshape(self.embed_dim, p * p * c)
        return F.linear(patches, wm.to(self.dtype), self.proj.bias.to(self.dtype))


class _ScaledOutDense(_Params):
    """Linear whose weight/bias are premultiplied by an optional per-output
    scale — the layer-scale fold of models/layers.py:146-174:
    γ ⊙ (x Wᵀ + b) = x (γ·W)ᵀ + γ⊙b, exactly, at the cost of scaling the
    weight instead of the [B, N, C] activations. With ``quant="int8"`` and a
    supported shape the matmul is ``ops.quant.int8_dense`` on the f32 weight
    after the fold (both are diagonal rescalings before the quantization,
    :164-174); the fold stays an autograd node, so γ gets its gradient.

    ``row_parallel`` (a mesh with a model axis): the layer holds its columns
    of the weight; the partial products are summed over the model axis, and
    then the bias is added and γ multiplies (γ's gradient then is whole on
    every model rank)."""

    def __init__(self, in_features: int, out_features: int, weight_init: I.Init,
                 quant: str = "none", seq_shard: Optional[seq.SeqShard] = None, *,
                 row_parallel: Optional[meshlib.Mesh] = None, device=None, generator=None):
        super().__init__((out_features, in_features), weight_init, (out_features,),
                         device=device, generator=generator)
        self.quant, self.seq_shard, self.row_parallel = quant, seq_shard, row_parallel

    def forward(self, x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                active: bool = False) -> torch.Tensor:
        """``active`` says whether the forward draws (then the int8 layer's
        rounding seed comes from ``generator``)."""
        w, b = self.weight, self.bias
        if self.row_parallel is not None:
            y = meshlib.reduce_from_model(F.linear(x, w.to(x.dtype)), self.row_parallel)
            y = y + b.to(y.dtype)
            return y if scale is None else y * scale.to(y.dtype)
        if scale is not None:
            w = w * scale[:, None]
            b = b * scale
        if _use_quant(self.quant, x, w.shape[0], self.seq_shard):
            return quant_ops.int8_dense(x, w, b, _quant_seed(x, active, generator))
        return F.linear(x, w.to(x.dtype), b.to(x.dtype))


def _model_axis(mesh: Optional[meshlib.Mesh], quant: str = "none") -> Optional[meshlib.Mesh]:
    """``mesh`` where it has a model axis of more than one rank, else None;
    raises for what is not ported under one."""
    if not meshlib.active(mesh, meshlib.MODEL_AXIS):
        return None
    if quant != "none":
        raise NotImplementedError("the int8 trunk under a model axis is not ported (its row "
                                  "scales would be taken over a part of the contraction; "
                                  "ROADMAP.md item 21)")
    return mesh


def _local(size: int, tp: meshlib.Mesh, what: str) -> int:
    """This model rank's part of ``size``."""
    parts = tp.size(meshlib.MODEL_AXIS)
    if size % parts:
        raise NotImplementedError(f"{what} of {size} does not split over a model axis of "
                                  f"{parts} (ROADMAP.md item 21)")
    return size // parts


def _fix_init(base: I.Init, layer_id: int) -> I.Init:
    """fix_init_weight rescale by 1/sqrt(2·layer_id) (modeling_finetune.py:443-449)."""
    return base if layer_id == 0 else I.scaled(base, 1.0 / math.sqrt(2.0 * layer_id))


class Mlp(nn.Module):
    """fc1 → GELU → fc2 → dropout (modeling_finetune.py:65-82).

    GELU is the tanh form under bfloat16 and exact erf otherwise, as the
    JAX module selects (models/layers.py:201-205). Under ``mesh``'s model
    axis of T ranks fc1 holds hidden/T of its outputs and fc2 is
    row-parallel."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, drop: float = 0.0,
                 layer_id: int = 0, init_std: float = 0.02, init_trunc_abs: float = 2.0,
                 dtype: torch.dtype = torch.float32, quant: str = "none",
                 seq_shard: Optional[seq.SeqShard] = None, *,
                 mesh: Optional[meshlib.Mesh] = None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        tn = I.trunc_normal(init_std, init_trunc_abs)
        self.drop, self.dtype, self.seq_shard = drop, dtype, seq_shard
        self.tp = _model_axis(mesh, quant)
        if self.tp is not None:
            hidden_dim = _local(hidden_dim, self.tp, "the MLP's hidden width")
        self.fc1 = _ScaledOutDense(in_dim, hidden_dim, tn, quant, seq_shard, device=device,
                                   generator=generator)
        self.fc2 = _ScaledOutDense(hidden_dim, out_dim, _fix_init(tn, layer_id), quant,
                                   seq_shard, row_parallel=self.tp, device=device,
                                   generator=generator)

    def forward(self, x: torch.Tensor, out_scale: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None) -> torch.Tensor:
        active = _active(self, deterministic)
        x = self.fc1(meshlib.copy_to_model(x, self.tp), None, generator, active)
        x = F.gelu(x, approximate="tanh" if self.dtype == torch.bfloat16 else "none")
        x = self.fc2(x, out_scale, generator, active)
        return site_dropout(x, self.drop, active, generator, self.seq_shard)


def _register_relpos_index(module: nn.Module, window_size: Tuple[int, int], device) -> None:
    """The static [N, N] index into the rel-pos table, as a buffer that is
    not part of the state_dict (the reference checkpoints hold only tables)."""
    index = torch.from_numpy(relpos.relative_position_index(window_size).astype("int64"))
    module.register_buffer("relative_position_index", index.to(device), persistent=False)


def _table_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """[nrd, H] table gathered by the [Nq, N] index (all rows of the [N, N]
    one, or a shard's) → contiguous [H, Nq, N]."""
    nq, n = index.shape
    return table[index.reshape(-1)].reshape(nq, n, -1).permute(2, 0, 1).contiguous()


def _query_rows(shard: Optional[seq.SeqShard]) -> slice:
    return slice(None) if shard is None else slice(shard.start, shard.stop)


class RelativePositionBias(nn.Module):
    """Shared-across-blocks rel-pos bias table (modeling_finetune.py:328-364).

    Returns [num_heads, N+1, N+1] f32, or only the query rows ``rows`` of it;
    zero-initialized like the reference."""

    def __init__(self, window_size: Tuple[int, int], num_heads: int, *, device=None):
        super().__init__()
        device = resolve_device(device)
        nrd = relpos.num_relative_distance(window_size)
        self.relative_position_bias_table = _param((nrd, num_heads), I.zeros, device, None)
        _register_relpos_index(self, window_size, device)

    def forward(self, rows: slice = slice(None)) -> torch.Tensor:
        return _table_bias(self.relative_position_bias_table, self.relative_position_index[rows])


class Attention(nn.Module):
    """MHSA with the reference's fused-qkv / no-key-bias layout
    (modeling_finetune.py:85-188) and its probability variants
    (``ops.attention.VARIANTS``: softmax, gumbel, sinkformer).

    The qkv Linear has no bias; q_bias and v_bias are separate parameters
    and the key bias is structurally zero. The q|0|v bias is added with the
    qkv matmul, outside the attention kernel (models/layers.py:296-314): by
    ``F.linear``, or in the int8 kernel's f32 epilogue with ``quant="int8"``.
    ``use_kernel``, decided at each call as the reference decides it
    (:332-338): ``use_flash=True``, the softmax variant, a head width the
    attention kernels take (``KERNEL_HEAD_DIM``) and no
    ``flash_attention.plain_only()`` context route through
    ``fused_qkv_attention`` (the kernel on a CUDA tensor, its plain version
    on CPU), attention dropout included, from a seed drawn from the
    forward's generator; otherwise ``naive_attention`` runs, the Gumbel
    variant's noise drawn from the forward's ``gumbel_generator``.

    With ``seq_shard`` x holds this rank's query rows and a ``rel_pos_bias``
    those rows of the bias; the kernel route runs
    ``seq_sharded_qkv_attention`` (:352-366; attention dropout raises in
    training, as in the reference), the plain route gathers k/v through the
    same ``seq.gather_tokens`` and runs ``naive_attention`` on the local
    rows (the reference runs it replicated).

    Under ``mesh``'s model axis of T ranks the module holds H/T of the
    heads, the same kernels run on them, and proj is row-parallel; H must
    split over T."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, window_size: Optional[Tuple[int, int]] = None,
                 attn_head_dim: Optional[int] = None, layer_id: int = 0,
                 init_std: float = 0.02, init_trunc_abs: float = 2.0,
                 use_flash: bool = True, quant: str = "none",
                 seq_shard: Optional[seq.SeqShard] = None, variant: str = "softmax",
                 sinkformer_eps: float = 1.0, sinkformer_iters: int = 3, *,
                 mesh: Optional[meshlib.Mesh] = None, device=None, generator=None):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown attention variant: {variant}")
        device = resolve_device(device)
        head_dim = attn_head_dim or dim // num_heads
        self.tp = _model_axis(mesh, quant)
        if self.tp is not None:
            if variant != "softmax":
                raise NotImplementedError(f"the {variant} attention under a model axis is not "
                                          "ported (ROADMAP.md item 21)")
            num_heads = _local(num_heads, self.tp, "the head count")
        all_head_dim = head_dim * num_heads
        self.num_heads, self.head_dim = num_heads, head_dim
        self.scale = qk_scale or head_dim**-0.5
        self.attn_drop, self.proj_drop, self.quant = attn_drop, proj_drop, quant
        self.seq_shard, self.use_flash, self.variant = seq_shard, use_flash, variant
        self.sinkformer_eps, self.sinkformer_iters = sinkformer_eps, sinkformer_iters
        tn = I.trunc_normal(init_std, init_trunc_abs)

        self.qkv = _Params((all_head_dim * 3, dim), tn, device=device, generator=generator)
        if qkv_bias:
            self.q_bias = _param((all_head_dim,), I.zeros, device, generator)
            self.v_bias = _param((all_head_dim,), I.zeros, device, generator)
        else:
            self.q_bias = self.v_bias = None
        if window_size is not None:
            nrd = relpos.num_relative_distance(window_size)
            self.relative_position_bias_table = _param((nrd, num_heads), I.zeros, device, generator)
            _register_relpos_index(self, window_size, device)
        else:
            self.relative_position_bias_table = None
        self.proj = _ScaledOutDense(all_head_dim, dim, _fix_init(tn, layer_id), quant,
                                    seq_shard, row_parallel=self.tp, device=device,
                                    generator=generator)

    @property
    def use_kernel(self) -> bool:
        """Whether this call takes the attention kernels (read per call)."""
        return (self.use_flash and self.variant == "softmax"
                and self.head_dim == KERNEL_HEAD_DIM and not in_plain_only())

    def forward(self, x: torch.Tensor, rel_pos_bias: Optional[torch.Tensor] = None,
                out_scale: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None,
                gumbel_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        active = _active(self, deterministic)
        b, n, _ = x.shape
        if self.tp is not None:
            if active and self.attn_drop > 0.0:
                raise NotImplementedError("attention dropout in training under a model axis is "
                                          "not ported (K1's mask counter is the local head "
                                          "index; ROADMAP.md item 21)")
            x = meshlib.copy_to_model(x, self.tp)
        qkv_bias = None
        if self.q_bias is not None:
            qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.v_bias), self.v_bias])
        if _use_quant(self.quant, x, self.qkv.weight.shape[0], self.seq_shard):
            qkv = quant_ops.int8_dense(x, self.qkv.weight, qkv_bias,
                                       _quant_seed(x, active, generator))
        else:
            qkv = F.linear(x, self.qkv.weight.to(x.dtype),
                           None if qkv_bias is None else qkv_bias.to(x.dtype))

        shard = self.seq_shard
        bias = None
        if self.relative_position_bias_table is not None:
            bias = _table_bias(self.relative_position_bias_table,
                               self.relative_position_index[_query_rows(shard)])
        if rel_pos_bias is not None:
            bias = rel_pos_bias if bias is None else bias + rel_pos_bias

        drop = self.attn_drop if active else 0.0
        use_kernel = self.use_kernel
        if use_kernel and shard is not None:
            if drop > 0.0:
                raise ValueError("sequence-parallel attention requires attn_drop=0 (in-kernel "
                                 "dropout seeds are not defined across re-sharded grids)")
            out = seq_sharded_qkv_attention(qkv, bias, None, self.scale, self.num_heads,
                                            shard.group, shard.n)
        elif use_kernel:
            # the seed of the in-kernel mask, as the reference draws it from
            # the "dropout" rng (models/layers.py:344-349)
            seed = None
            if drop > 0.0:
                seed = philox.draw_seed(_require_generator(generator, "attention dropout"),
                                        x.device)
            out = fused_qkv_attention(qkv, bias, None, seed, self.scale, self.num_heads, drop)
        else:
            c = qkv.shape[-1] // 3
            kv = qkv[..., c:] if shard is None else seq.gather_tokens(qkv[..., c:], shard.group,
                                                                     shard.n)

            def heads(t):  # [B, rows, j·H·D] → [B, j·H, rows, D]
                return t.reshape(b, t.shape[1], -1, self.head_dim).transpose(1, 2)

            k, v = heads(kv).split(self.num_heads, dim=1)
            out = naive_attention(heads(qkv[..., :c]), k, v, self.scale, bias,
                                  variant=self.variant, dropout_rate=self.attn_drop,
                                  generator=_attention_generator(generator),
                                  deterministic=not active,
                                  query_rows=None if shard is None else (shard.start, shard.n),
                                  gumbel_generator=gumbel_generator,
                                  sinkformer_eps=self.sinkformer_eps,
                                  sinkformer_iters=self.sinkformer_iters)
            out = out.transpose(1, 2).reshape(b, n, -1)
        out = self.proj(out, out_scale, generator, active)
        return site_dropout(out, self.proj_drop, active, generator, shard)


class DualStoSelfAttention(nn.Module):
    """The "h_sto_trans" attention (modeling_finetune.py:191-260; JAX
    models/layers.py:405-469): the keys are hard-Gumbel-quantized onto a
    learned codebook of ``n_centroids`` centroids per head, and the
    attention weights are a hard Gumbel-softmax over q·k_sto; both
    temperatures are √h_size (:207-208). ``query``, ``key``, ``value`` and
    ``proj`` are plain dense layers (``--quant int8`` does not reach them,
    as JAX's nn.Dense) with the plain trunc_normal init and no layer-id
    rescale; ``centroid`` is [head_dim, n_centroids], uniform on
    [−0.5, 0.5) (:213-215). The rel-pos bias is ignored (:217-255); the
    weights' dropout is ``prob_attn``, the output's ``prob_h``. Both Gumbel
    draws come from the forward's ``gumbel_generator``: the keys' first,
    then the weights'."""

    def __init__(self, h_size: int, n_heads: int, prob_attn: float = 0.0, prob_h: float = 0.0,
                 n_centroids: int = 2, init_std: float = 0.02, init_trunc_abs: float = 2.0,
                 seq_shard: Optional[seq.SeqShard] = None, *, device=None, generator=None):
        super().__init__()
        if seq_shard is not None:
            raise NotImplementedError("the dual stochastic attention under a seq group is not "
                                      "ported (the reference runs it on whole sequences)")
        device = resolve_device(device)
        self.h_size, self.n_heads, self.head_dim = h_size, n_heads, h_size // n_heads
        self.prob_attn, self.prob_h = prob_attn, prob_h
        self.tau = float(h_size) ** 0.5
        tn = I.trunc_normal(init_std, init_trunc_abs)

        def dense():
            return _Params((h_size, h_size), tn, (h_size,), device=device, generator=generator)

        self.query, self.key, self.value = dense(), dense(), dense()
        self.centroid = _param((self.head_dim, n_centroids), _uniform_init(-0.5, 0.5), device,
                               generator)
        self.proj = dense()

    def forward(self, x: torch.Tensor, rel_pos_bias: Optional[torch.Tensor] = None,
                out_scale: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None,
                gumbel_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``out_scale`` (the layer scale) multiplies the output, as the
        reference's Block does for this attention (JAX :563-568)."""
        del rel_pos_bias
        active = _active(self, deterministic)
        b, n, _ = x.shape

        def dense(layer: _Params, t: torch.Tensor) -> torch.Tensor:
            return F.linear(t, layer.weight.to(t.dtype), layer.bias.to(t.dtype))

        def heads(t: torch.Tensor) -> torch.Tensor:  # [B, N, C] → [B, N, H, D]
            return t.reshape(b, n, self.n_heads, self.head_dim)

        qq, kk, vv = (heads(dense(layer, x)) for layer in (self.query, self.key, self.value))
        centroid = self.centroid.to(x.dtype)
        kk_logits = torch.einsum("bnhd,dc->bnhc", kk, centroid)
        prob = gumbel_softmax_probs(kk_logits, gumbel_generator, tau=self.tau, hard=True)
        sto_kk = torch.einsum("bnhc,cd->bnhd", prob, centroid.t())
        qh, kh, vh = (t.transpose(1, 2) for t in (qq, sto_kk, vv))
        work = at_least_f32(x.dtype)
        interact = torch.matmul(qh.to(work), kh.to(work).transpose(-1, -2))
        weights = gumbel_softmax_probs(interact, gumbel_generator, tau=self.tau,
                                       hard=True).to(x.dtype)
        weights = dropout(weights, self.prob_attn, active, generator)
        out = torch.matmul(weights, vh).transpose(1, 2).reshape(b, n, self.h_size)
        out = dropout(dense(self.proj, out), self.prob_h, active, generator)
        return out if out_scale is None else out_scale.to(out.dtype) * out


class Block(nn.Module):
    """Pre-norm transformer block returning (x, fc_feature)
    (modeling_finetune.py:263-299), with the layer scale γ folded into the
    attention projection and fc2 (exact: dropout and drop-path are diagonal
    maps)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path_rate: float = 0.0,
                 init_values: Optional[float] = None,
                 window_size: Optional[Tuple[int, int]] = None,
                 attn_head_dim: Optional[int] = None, variant: str = "softmax",
                 layer_id: int = 1, init_std: float = 0.02, init_trunc_abs: float = 2.0,
                 layer_norm_eps: float = 1e-6, use_flash: bool = True,
                 dtype: torch.dtype = torch.float32, quant: str = "none",
                 seq_shard: Optional[seq.SeqShard] = None, sinkformer_eps: float = 1.0,
                 sinkformer_iters: int = 3, dual_sto_n_centroids: int = 2, *,
                 mesh: Optional[meshlib.Mesh] = None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.drop_path_rate = dtype, drop_path_rate
        if variant == "dual_sto" and meshlib.active(mesh, meshlib.MODEL_AXIS):
            raise NotImplementedError("the dual stochastic attention under a model axis is not "
                                      "ported (ROADMAP.md item 21)")
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        if variant == "dual_sto":
            # the block dispatches on the variant (JAX models/layers.py:511-527)
            self.attn = DualStoSelfAttention(
                dim, num_heads, prob_attn=attn_drop, prob_h=drop,
                n_centroids=dual_sto_n_centroids, init_std=init_std,
                init_trunc_abs=init_trunc_abs, seq_shard=seq_shard, device=device,
                generator=generator)
        else:
            self.attn = Attention(
                dim, num_heads, qkv_bias=qkv_bias, qk_scale=qk_scale, attn_drop=attn_drop,
                proj_drop=drop, window_size=window_size, attn_head_dim=attn_head_dim,
                layer_id=layer_id, init_std=init_std, init_trunc_abs=init_trunc_abs,
                use_flash=use_flash, quant=quant, seq_shard=seq_shard, variant=variant,
                sinkformer_eps=sinkformer_eps, sinkformer_iters=sinkformer_iters,
                mesh=mesh, device=device, generator=generator,
            )
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop=drop, layer_id=layer_id,
                       init_std=init_std, init_trunc_abs=init_trunc_abs, dtype=dtype,
                       quant=quant, seq_shard=seq_shard, mesh=mesh, device=device,
                       generator=generator)
        if init_values is not None and init_values > 0:
            self.gamma_1 = _param((dim,), I.constant(init_values), device, generator)
            self.gamma_2 = _param((dim,), I.constant(init_values), device, generator)
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x: torch.Tensor, rel_pos_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None,
                gumbel_generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``generator`` supplies every draw of a forward that draws: the
        drop-path masks (one per sample) and the dropout masks or seeds;
        ``gumbel_generator`` the Gumbel noise of the gumbel and dual_sto
        attentions, on every forward."""
        active = _active(self, deterministic)
        attn_out = self.attn(layer_norm(self.norm1, x).to(self.dtype), rel_pos_bias,
                             out_scale=self.gamma_1, generator=generator,
                             deterministic=not active, gumbel_generator=gumbel_generator)
        x = x + drop_path(attn_out, self.drop_path_rate, active, generator)
        fc_feature = drop_path(
            self.mlp(layer_norm(self.norm2, x).to(self.dtype), out_scale=self.gamma_2,
                     generator=generator, deterministic=not active),
            self.drop_path_rate, active, generator,
        )
        return x + fc_feature, fc_feature
