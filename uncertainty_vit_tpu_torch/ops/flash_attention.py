"""Fused multi-head attention over packed qkv: forward (K1, K3) and backward
(K2, K4); attention of local query rows against gathered keys (K5), and the
sequence-parallel attention built on it.

Counterpart of ``fused_qkv_attention`` in uncertainty_vit_tpu/ops/
flash_attention.py (:1369-1424: the ``jax.custom_vjp`` over ``_fwd_kernel``
:188-241 and ``_bwd_kernel`` :244-326, and for large N over
``_stream_fwd_kernel`` :668-716 and the two streaming backward kernels
:744-852, picked by ``_route`` :1361-1366). Inputs are
the fused qkv activations [B, N, 3C] straight out of the qkv matmul (q|k|v
concatenated, heads interleaved as C = H·D); the per-head slabs are cut
inside the kernel, so no [B, H, N, D] copies and no [B, H, N, N] scores
reach device memory.

- On a CPU tensor the call runs ``fused_qkv_attention_plain`` (forward)
  and ``fused_qkv_attention_bwd_plain`` (backward), the same math in plain
  PyTorch.
- On a CUDA tensor ``route(N)`` picks the route, and both routes run the
  kernels of ``csrc/flash_attention_stream_fwd.cu`` (forward) and
  ``csrc/flash_attention_stream_bwd.cu`` (backward: two kernels back to
  back). Up to ``BWD_MAX_N`` tokens ("fused"; N = 197 at ViT-B/16 224) the
  forward is K1 and adds one to ``fused_qkv_attention.launches``, the
  backward K2 and adds one to ``fused_qkv_attention_bwd.launches``; above
  it ("stream"; N = 577 and 1025 at the 384 and 512 presets) they are K3
  and K4 and add one to ``fused_qkv_attention.stream_launches`` and
  ``fused_qkv_attention_bwd.stream_launches``. One threshold serves forward
  and backward. Either raises on what its kernel does not take. There is
  no fallback.

When grad mode is on and an input requires grad, the call goes through
``_FusedQKVAttention`` (a ``torch.autograd.Function``): its forward is K1
or K3 with the row log-sum-exp, its backward K2 or K4, which rebuild the
probabilities from that lse and take the forward's output, from which they
form the row sums of the softmax vjp (``rowsum_from_out``). Otherwise only
the forward runs.

``cross_qkv_attention`` (:1253-1288) is the local computation of token-
(sequence-)parallel attention: q [B, Nq, C], one shard's query rows, against
packed kv [B, Nk, 2C], all keys gathered. Its kernels are K3's and K4's own
entries given two token counts (K5, as ``_cross_fwd_impl`` :1136 and
``_cross_bwd_impl`` :1179 point the streaming bodies at two arrays), counted
on ``cross_qkv_attention.launches`` and ``cross_qkv_attention_bwd.launches``;
on a CPU tensor ``cross_fwd_plain`` / ``cross_bwd_dq_plain`` /
``cross_bwd_dkv_plain`` run, the same plain functions as K3's and K4's.
``seq_sharded_qkv_attention`` (:1291-1358) gathers k/v over a
``parallel.seq.SeqGroup`` and runs it.

Attention dropout (``dropout_rate > 0``) runs inside both kernels
(``_dropout_mask`` :156-162, applied at :233-234 and replayed at :298-301):
the keep mask is a pure function of the seed and of each entry's (image,
head, row, column) (``ops/philox.py``), so K2 replays K1's mask whatever
tiles either uses (K3 and K4's two kernels likewise), and the plain
versions draw the very same mask. On a data axis a rank's images are its
rows of the global batch: ``fold=(b, B, off)`` keys image g's mask as the
unsharded image (g // b)·B + off + g % b (its rows [off, off + b) of each
fold of B images; ``philox.fold_images``), in the forward and in the
backward's replay alike, so that a rank draws one process's masks. The
reference's TPU kernels seed a hardware generator per program instead, so
against it only distributions compare.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, Optional, Tuple, Union

import torch

from uncertainty_vit_tpu_torch.ops import _native, philox
from uncertainty_vit_tpu_torch.parallel import seq

# Nesting depth of ``plain_only()``, read at call time.
_PLAIN_ONLY = 0


@contextlib.contextmanager
def plain_only() -> Iterator[None]:
    """The counterpart of ``forward_ad_safe()`` / ``FORWARD_AD_ONLY`` of the
    reference package (ops/flash_attention.py:50-72). Inside it the models
    take their plain attention and dense paths, whatever their flags: the
    autograd Functions over K1-K7 have no double backward, which the
    AdaHessian pass (``train.optim.hutchinson_hessian_diag``) takes, so the
    kernel Functions refuse a call with grad inside it. Read at call time,
    not when a module is built; it nests."""
    global _PLAIN_ONLY
    _PLAIN_ONLY += 1
    try:
        yield
    finally:
        _PLAIN_ONLY -= 1


def in_plain_only() -> bool:
    """Whether a ``plain_only()`` context is open."""
    return _PLAIN_ONLY > 0


def _refuse_in_plain_only(what: str) -> None:
    if _PLAIN_ONLY:
        raise RuntimeError(f"{what} inside plain_only(): the kernel's autograd Function has "
                           "no double backward; the model takes its plain path there")


# Skip the softmax max pass: exp(s)/Σexp(s) equals the max-subtracted
# softmax whenever exp(s) does not overflow f32 (|s| ≲ 88). Safe for trained
# ViTs at these shapes, not for arbitrary inputs; the finetune driver turns
# it on for training and evaluation (cli/common.py:34-44 of the reference
# package). Read at call time when ``bounded_scores`` is not given.
BOUNDED_SCORES = False
# The head widths the kernels are built for: every multiple of 16 from 32 to
# 128 (ViT-B and ViT-L 64, ViT-H 80; a wgmma step is 16 deep). The same rule
# picks the instantiation at launch (csrc/attention_common.cuh:kHeadDimMin,
# kHeadDimMax, kHeadDimStep; a CPU test holds the two to each other).
HEAD_DIM_MIN, HEAD_DIM_MAX, HEAD_DIM_STEP = 32, 128, 16
KERNEL_HEAD_DIMS = tuple(range(HEAD_DIM_MIN, HEAD_DIM_MAX + 1, HEAD_DIM_STEP))
# The reference's kernels keep a head group's lanes 128-aligned
# (ops/flash_attention.py:_group_candidates of the reference package).
_LANE = 128


def reference_takes_kernels(num_heads: int, head_dim: int) -> bool:
    """Whether the reference's head-group rule admits its attention kernels
    at H heads of D: some head group g dividing H with g·D a multiple of 128
    (its ``kernel_supported`` holds there at N = 197, 577 and 1025)."""
    return any(num_heads % g == 0 and (g * head_dim) % _LANE == 0
               for g in range(1, num_heads + 1))
# The fused route (K1, K2: the TPU's whole-row kernels) takes N up to this
# (ViT 224 and below), the streaming route (K3, K4) above it (N=577/1025),
# forward and backward alike. On the card both routes run the streaming
# kernels, whose 64-row tiles need no whole row; the route decides which
# counter a launch adds to.
BWD_MAX_N = 256

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def route(n: int) -> str:
    """The route a call with N = n tokens takes on the card: "fused" (K1
    forward, K2 backward) up to ``BWD_MAX_N``, "stream" (K3, K4) above it.
    The threshold is fixed, not the TPU's VMEM budget (``_route``,
    :1361-1366), and is the same for forward and backward, so a saved lse
    always meets the backward that expects it."""
    return "fused" if n <= BWD_MAX_N else "stream"


def fused_qkv_attention_plain(
    qkv: torch.Tensor,
    bias: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    scale: float,
    num_heads: int,
    *,
    bounded_scores: bool,
    seed: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    fold: philox.Fold = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: returns (out [B, N, C] in
    qkv.dtype, lse [B, H, N] f32). ``fold`` = (b, B, off) places qkv's
    images in the batch whose dropout mask is drawn (see the module doc): a
    data rank's batch fold, or (b, i + b, i) for a slice of b images from
    image i, so that a large batch can be computed in slices.

    Mirrors ``_fwd_kernel``: q/v bias added in the input dtype; scores,
    softmax and the row sums in f32 from the (exactly upcast) inputs; with
    dropout the unnormalized probabilities times the scaled keep mask of
    ``seed``, after the row sum (the lse is the undropped softmax's); they
    are rounded to the input dtype before the product with v; the output
    scaled by 1/Σe."""
    return _attention_plain(*_split_qkv(qkv), bias, qv_bias, scale, num_heads, bounded_scores,
                            seed, dropout_rate, fold)


def _split_qkv(qkv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return qkv.split(qkv.shape[-1] // 3, dim=-1)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, H·D] → [B, H, N, D] f32."""
    b, n, c = t.shape
    return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2).float()


def _qv_biased(q, v, qv_bias):
    """q and v with the q/v bias rows added in their dtype."""
    if qv_bias is None:
        return q, v
    return q + qv_bias[0].to(q.dtype), v + qv_bias[2].to(v.dtype)


def _attention_plain(q, k, v, bias, qv_bias, scale, num_heads, bounded_scores, seed,
                     dropout_rate, fold):
    """The forward's plain version on q [B, Nq, C] and k, v [B, Nk, C]:
    (out [B, Nq, C], lse [B, H, Nq] f32). One function for K1, K3 (Nq = Nk)
    and K5."""
    b, nq, c = q.shape
    nk = k.shape[1]
    dt = q.dtype
    q, v = _qv_biased(q, v, qv_bias)
    q, k, v = _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads)
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if bounded_scores:
        e = torch.exp(s)
        r = 1.0 / e.sum(dim=-1, keepdim=True)
        lse = -torch.log(r)
    else:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        r = 1.0 / e.sum(dim=-1, keepdim=True)
        lse = m - torch.log(r)
    if dropout_rate > 0.0:
        e = e * _keep_scale(seed, dropout_rate, b, num_heads, nq, nk, fold)
    out = torch.matmul(e.to(dt).float(), v) * r
    return out.transpose(1, 2).reshape(b, nq, c).to(dt), lse[..., 0]


def _keep_scale(seed: torch.Tensor, rate: float, b: int, num_heads: int, nq: int, nk: int,
                fold: philox.Fold) -> torch.Tensor:
    """[B, H, Nq, Nk] f32: 1/(1 − rate) where the attention entry of the
    unsharded images of the batch ``fold`` is kept, 0 where it is dropped."""
    bits = philox.attention_bits(seed, b, num_heads, nq, nk, fold=fold)
    return philox.keep_scale(bits, rate)


def reduce_qv_bias_grad(dqkv: torch.Tensor) -> torch.Tensor:
    """d(q/v bias) [3, C] f32: the f32 sum of dqkv over (batch, tokens) per
    section, with the k row zeroed: no key bias is ever added, so its
    cotangent is 0 (``_reduce_qv_bias_grad``, :329-337)."""
    b, n, c3 = dqkv.shape
    dqvb = dqkv.reshape(b, n, 3, c3 // 3).float().sum(dim=(0, 1))
    return dqvb * torch.tensor([1.0, 0.0, 1.0], device=dqkv.device)[:, None]


def _recompute(q, k, v, bias, qv_bias, lse, g, scale, num_heads, seed, dropout_rate, fold):
    """What every backward kernel recomputes from the saved lse (``_bwd_kernel``
    :291-303, ``_stream_recompute_tile`` :719-741), for whole rows of q
    [B, Nq, C] against k, v [B, Nk, C]: the f32 head slabs q, g [B, H, Nq, D]
    and k [B, H, Nk, D] (q and v with the q/v bias added in the input dtype),
    p = exp(s − lse), p_d = p·mask (p itself without dropout) and t =
    (g vᵀ)·p_d. Products take the (exactly upcast) operands in f32."""
    b, nq, _ = q.shape
    nk = k.shape[1]
    dt = q.dtype
    q, v = _qv_biased(q, v, qv_bias)
    q, k, v, gh = (_heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads),
                   _heads(g.to(dt), num_heads))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - lse.float()[..., None])
    p_d = (p * _keep_scale(seed, dropout_rate, b, num_heads, nq, nk, fold)
           if dropout_rate > 0.0 else p)
    t = torch.matmul(gh, v.transpose(-1, -2)) * p_d
    return q, k, gh, p, p_d, t


def _tokens(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[B, H, N, D] f32 → [B, N, H·D] in dtype."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d).to(dtype)


def fused_qkv_attention_bwd_plain(
    qkv: torch.Tensor,
    bias: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: float,
    num_heads: int,
    *,
    out: Optional[torch.Tensor] = None,
    seed: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    fold: philox.Fold = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain PyTorch version of the backward kernel: returns (dqkv [B, N, 3C]
    in qkv.dtype, dbias [H, N, N] f32 or None, dqvb [3, C] f32 or None).
    ``fold`` as in the forward's plain version.

    Mirrors ``_bwd_kernel`` (:291-326): p = exp(s − lse) from the saved
    row log-sum-exp (no max or row-sum recompute); p_d = p·mask, the
    forward's keep mask replayed from ``seed`` (p_d = p without dropout);
    dv = p_dᵀg with p_d cast to g's dtype; t = (g vᵀ)·p_d; c, the row sums
    of the softmax vjp, formed from the forward's output ``out`` [B, N, C]
    as the CUDA kernels form them (``rowsum_from_out``), or without ``out``
    as rowsum(t), as the JAX kernel forms them; ds = t − p·c with the
    undropped p; dq = ds_c·k·scale and dk = ds_cᵀ·q·scale with ds_c = ds
    cast to the input dtype; dbias = Σ_b ds in f32. Products take the
    (exactly upcast) operands in f32."""
    dt = qkv.dtype
    q, k, gh, p, p_d, t = _recompute(*_split_qkv(qkv), bias, qv_bias, lse, g, scale, num_heads,
                                     seed, dropout_rate, fold)
    dv = torch.matmul(p_d.to(dt).float().transpose(-1, -2), gh)
    c = t.sum(dim=-1) if out is None else rowsum_from_out(out, g, num_heads)
    ds = t - p * c[..., None]
    ds_c = ds.to(dt).float()
    dq = torch.matmul(ds_c, k) * scale
    dk = torch.matmul(ds_c.transpose(-1, -2), q) * scale
    dqkv = torch.cat([_tokens(dq, dt), _tokens(dk, dt), _tokens(dv, dt)], dim=-1)
    dbias = ds.sum(dim=0) if bias is not None else None
    dqvb = reduce_qv_bias_grad(dqkv) if qv_bias is not None else None
    return dqkv, dbias, dqvb


def stream_bwd_dq_plain(
    qkv: torch.Tensor,
    bias: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: float,
    num_heads: int,
    *,
    out: Optional[torch.Tensor] = None,
    seed: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    fold: philox.Fold = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of the streaming backward's first kernel
    (``_stream_bwd_dq_kernel``, :744-790): returns (dq [B, N, C] in
    qkv.dtype, dbias [H, N, N] f32 summed over the batch or None, c
    [B, H, N] f32). c, the row sums of the softmax vjp, which the second
    kernel cannot form (it never sees a whole row) and takes from here, is
    formed from the forward's output ``out`` [B, N, C] as the CUDA kernel
    forms it (``rowsum_from_out``), or without ``out`` as rowsum(t) over the
    keys, as the JAX kernel and ``fused_qkv_attention_bwd_plain`` form it;
    ds = t − p·c, dq = ds_c·k·scale with ds_c = ds rounded to the input
    dtype. ``fold`` as in the forward's plain version."""
    return _bwd_dq_plain(*_split_qkv(qkv), bias, qv_bias, lse, out, g, scale, num_heads, seed,
                         dropout_rate, fold)


def rowsum_from_out(out: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """c [B, H, Nq] f32, the row sums of the softmax vjp, from the forward's
    output out [B, Nq, C] and its cotangent g: c_i = Σ_j p_d,ij (g_i·v_j) =
    g_i·o_i, since o = p_d v (dropout included). The streaming backward's
    kernels form c so, in f32 from out as the forward rounded it, and need
    no pass over the keys for it; the JAX kernels recompute rowsum(t) from
    whole rows (``_stream_recompute_tile``, :719-741), the same function."""
    return (_heads(g.to(out.dtype), num_heads) * _heads(out, num_heads)).sum(dim=-1)


def _bwd_dq_plain(q, k, v, bias, qv_bias, lse, out, g, scale, num_heads, seed, dropout_rate,
                  fold):
    """The first backward kernel's plain version on q [B, Nq, C] and k, v
    [B, Nk, C]: (dq [B, Nq, C], dbias [H, Nq, Nk] or None, c [B, H, Nq]),
    c from ``out`` or, when it is None, recomputed as rowsum(t)."""
    _, kh, _, p, _, t = _recompute(q, k, v, bias, qv_bias, lse, g, scale, num_heads, seed,
                                   dropout_rate, fold)
    c = t.sum(dim=-1) if out is None else rowsum_from_out(out, g, num_heads)
    ds = t - p * c[..., None]
    dq = torch.matmul(ds.to(q.dtype).float(), kh) * scale
    return _tokens(dq, q.dtype), ds.sum(dim=0) if bias is not None else None, c


def stream_bwd_dkv_plain(
    qkv: torch.Tensor,
    bias: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    lse: torch.Tensor,
    c: torch.Tensor,
    g: torch.Tensor,
    scale: float,
    num_heads: int,
    *,
    seed: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    fold: philox.Fold = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the streaming backward's second kernel
    (``_stream_bwd_dkv_kernel``, :793-852): returns (dk, dv), each [B, N, C]
    in qkv.dtype, from the lse and the first kernel's row sums c. dk =
    ds_cᵀ·q·scale and dv = p_dᵀ·g (p_d and ds rounded to the input dtype)
    are summed over all query rows in f32 and cast once at the end
    (:1032-1033). ``fold`` as in the forward's plain version."""
    return _bwd_dkv_plain(*_split_qkv(qkv), bias, qv_bias, lse, c, g, scale, num_heads, seed,
                          dropout_rate, fold)


def _bwd_dkv_plain(q, k, v, bias, qv_bias, lse, c, g, scale, num_heads, seed, dropout_rate,
                   fold):
    """The second backward kernel's plain version on q [B, Nq, C] and k, v
    [B, Nk, C]: (dk, dv), each [B, Nk, C]."""
    dt = q.dtype
    qh, _, gh, p, p_d, t = _recompute(q, k, v, bias, qv_bias, lse, g, scale, num_heads, seed,
                                      dropout_rate, fold)
    ds = t - p * c.float()[..., None]
    dk = torch.matmul(ds.to(dt).float().transpose(-1, -2), qh) * scale
    dv = torch.matmul(p_d.to(dt).float().transpose(-1, -2), gh)
    return _tokens(dk, dt), _tokens(dv, dt)


def _stream_bwd_plain(qkv, bias, qv_bias, lse, out, g, scale, num_heads, seed, dropout_rate,
                      fold=None):
    """The two plain halves put together as the streaming route returns them."""
    dq, dbias, c = stream_bwd_dq_plain(qkv, bias, qv_bias, lse, g, scale, num_heads, out=out,
                                       seed=seed, dropout_rate=dropout_rate, fold=fold)
    dk, dv = stream_bwd_dkv_plain(qkv, bias, qv_bias, lse, c, g, scale, num_heads, seed=seed,
                                  dropout_rate=dropout_rate, fold=fold)
    dqkv = torch.cat([dq, dk, dv], dim=-1)
    return dqkv, dbias, reduce_qv_bias_grad(dqkv) if qv_bias is not None else None


def cross_fwd_plain(
    q: torch.Tensor,
    kv: torch.Tensor,
    bias: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    scale: float,
    num_heads: int,
    *,
    bounded_scores: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5's forward: q [B, Nq, C] against packed kv
    [B, Nk, 2C] (k|v); returns (out [B, Nq, C] in q.dtype, lse [B, H, Nq]
    f32). The function K3 computes, with the query and key counts apart."""
    k, v = kv.split(q.shape[-1], dim=-1)
    return _attention_plain(q, k, v, bias, qv_bias, scale, num_heads, bounded_scores, None, 0.0,
                            None)


def cross_bwd_dq_plain(q, kv, bias, qv_bias, lse, g, scale, num_heads, *, out=None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Plain PyTorch version of K5's first backward kernel: (dq [B, Nq, C] in
    q.dtype, dbias [H, Nq, Nk] f32 summed over the batch or None, c
    [B, H, Nq] f32, formed from the forward's output ``out`` or, without
    it, recomputed as rowsum(t)), as ``stream_bwd_dq_plain``."""
    k, v = kv.split(q.shape[-1], dim=-1)
    return _bwd_dq_plain(q, k, v, bias, qv_bias, lse, out, g, scale, num_heads, None, 0.0, None)


def cross_bwd_dkv_plain(q, kv, bias, qv_bias, lse, c, g, scale, num_heads) -> torch.Tensor:
    """Plain PyTorch version of K5's second backward kernel: dkv [B, Nk, 2C]
    (dk|dv) in q.dtype from the lse and the first kernel's row sums c, as
    ``stream_bwd_dkv_plain``: dk and dv summed over all Nq query rows in f32
    and cast once (:1234, :1241-1242)."""
    k, v = kv.split(q.shape[-1], dim=-1)
    return torch.cat(_bwd_dkv_plain(q, k, v, bias, qv_bias, lse, c, g, scale, num_heads, None,
                                    0.0, None), dim=-1)


def cross_qv_bias_grad(dq: torch.Tensor, dkv: torch.Tensor) -> torch.Tensor:
    """d(q/v bias) [3, C] f32 of the cross attention: the q row the f32 sum
    of dq, the v row that of dkv's v half, the k row zero (:1243-1249)."""
    c = dq.shape[-1]
    dqb = dq.float().sum(dim=(0, 1))
    return torch.stack([dqb, torch.zeros_like(dqb), dkv[..., c:].float().sum(dim=(0, 1))])


_P, _I, _F, _U, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint,
                      ctypes.c_longlong)
# C signatures: pointers, then the ints, the scale and the dropout
# threshold and 1/(1 − rate), then the stream
_ARGTYPES = {
    # q, k, v, bias, qv_bias, out, lse, seed; ldq, ldkv, ldo; batch, nq, nk, num_heads,
    # head_dim, dtype, the batch fold (b, B, off); scale, bounded, threshold, inv_keep; stream
    "flash_attention_stream_fwd": [_P] * 8 + [_L] * 3 + [_I] * 9 + [_F, _I, _U, _F, _P],
    # q, k, v, g, out, bias, qv_bias, lse, c, dq, dk, dv, dbias, seed; ldq, ldkv, ldg, ldo,
    # lddq, lddkv; batch, nq, nk, ldb, num_heads, head_dim, dtype, the batch fold (b, B,
    # off); scale, threshold, inv_keep; stream
    "flash_attention_stream_bwd": [_P] * 14 + [_L] * 6 + [_I] * 10 + [_F, _U, _F, _P],
}
_ptr = _native.ptr


def _lib(name: str) -> ctypes.CDLL:
    return _native.typed(name, _ARGTYPES[name])


def _dropout_args(seed: Optional[torch.Tensor], rate: float, device: torch.device
                  ) -> Tuple[Optional[int], int, float]:
    """(seed pointer or None, threshold, 1/(1 − rate)) as the kernels take
    them; a null seed means no dropout."""
    if rate <= 0.0:
        return None, 0, 1.0
    if not rate < 1.0:
        raise ValueError(f"the attention dropout rate must be below 1, got {rate}")
    philox.check_seed(seed, device)
    return seed.data_ptr(), philox.threshold(rate), 1.0 / (1.0 - rate)


def _fold_args(batch: int, fold: philox.Fold, rate: float) -> Tuple[int, int, int]:
    """The kernels' batch fold (b, B, off) of a call on ``batch`` images:
    ``fold`` where a mask is drawn, else the identity (batch, batch, 0)."""
    return philox.check_fold(batch, fold if rate > 0.0 else None)


def _check_aux(name: str, t: Optional[torch.Tensor], shape, device) -> None:
    if t is None:
        return
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous float32 tensor of shape {shape} on {device}; "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}"
        )


def _check_tokens(name: str, x: torch.Tensor, sections: int, num_heads: int
                  ) -> Tuple[int, int, int]:
    """Checks what the kernels require of activations [B, N, sections·H·D]
    (packed qkv: 3; kv: 2; q: 1); returns (B, N, C = H·D)."""
    if not x.is_cuda:
        raise ValueError(f"the attention kernel runs on CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name} must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 3 or x.shape[-1] % (sections * num_heads) != 0:
        raise ValueError(f"{name} must be [B, N, {sections}·H·D] with H={num_heads}, "
                         f"got {tuple(x.shape)}")
    b, n, cs = x.shape
    c = cs // sections
    head_dim = c // num_heads
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the attention kernels take a head_dim that is a multiple of "
                         f"{HEAD_DIM_STEP} from {HEAD_DIM_MIN} to {HEAD_DIM_MAX}, got {head_dim}")
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return b, n, c


def _check_qkv(qkv: torch.Tensor, num_heads: int) -> Tuple[int, int, int]:
    """Checks what both kernels require of qkv; returns (B, N, C)."""
    return _check_tokens("qkv", qkv, 3, num_heads)


def _check_cross(q: torch.Tensor, kv: torch.Tensor, num_heads: int) -> Tuple[int, int, int, int]:
    """Checks what K5 requires of q [B, Nq, C] and kv [B, Nk, 2C]; returns
    (B, Nq, Nk, C)."""
    b, nq, c = _check_tokens("q", q, 1, num_heads)
    bk, nk, ck = _check_tokens("kv", kv, 2, num_heads)
    if (bk, ck) != (b, c) or kv.dtype != q.dtype or kv.device != q.device:
        raise ValueError(f"kv must be [{b}, Nk, {2 * c}] {q.dtype} on {q.device} beside q "
                         f"{tuple(q.shape)}; got {kv.dtype} {tuple(kv.shape)} on {kv.device}")
    return b, nq, nk, c


def _check_g(g: torch.Tensor, like: torch.Tensor, shape) -> None:
    """g, the output's cotangent: ``shape`` in like's dtype on its device."""
    if g.device != like.device or g.dtype != like.dtype or tuple(g.shape) != shape \
            or not g.is_contiguous() or g.data_ptr() % 16 != 0:
        raise ValueError(f"g must be a contiguous, 16-byte aligned {like.dtype} tensor of "
                         f"shape {shape} on {like.device}; got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")


def _stream_fwd(x, qkv_ptrs, pitches, b, nq, nk, c, bias, qv_bias, scale, num_heads, bounded,
                want_lse, dropout, fold, what):
    """The streaming forward's entry on q, k, v given as base pointers
    ``qkv_ptrs`` with row pitches ``pitches`` = (ldq, ldkv) and Nq query rows
    against Nk keys, for the tensor x they lie in: (out [B, Nq, C], lse
    [B, H, Nq] or None). ``dropout`` is ``_dropout_args``'s triple, ``fold``
    ``_fold_args``'s."""
    out = torch.empty((b, nq, c), dtype=x.dtype, device=x.device)
    lse = torch.empty((b, num_heads, nq), dtype=torch.float32, device=x.device) \
        if want_lse else None
    seed_ptr, threshold, inv_keep = dropout
    lib = _lib("flash_attention_stream_fwd")
    with torch.cuda.device(x.device):
        err = lib.uvit_flash_attention_stream_fwd(
            *qkv_ptrs, _ptr(bias), _ptr(qv_bias), out.data_ptr(), _ptr(lse), seed_ptr, *pitches,
            c, b, nq, nk, num_heads, c // num_heads, _DTYPES[x.dtype], *fold, float(scale),
            int(bounded), threshold, inv_keep, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _native.raise_on(lib, err, what)
    return out, lse


def _packed_fwd(qkv, bias, qv_bias, scale, num_heads, bounded_scores, want_lse, seed,
                dropout_rate, fold, what):
    """The streaming forward on packed qkv: (out, lse or None)."""
    b, n, c = _check_qkv(qkv, num_heads)
    _check_aux("bias", bias, (num_heads, n, n), qkv.device)
    _check_aux("qv_bias", qv_bias, (3, c), qkv.device)
    dropout = _dropout_args(seed, dropout_rate, qkv.device)
    # the packed layout as three base pointers and one row pitch
    q, slab = qkv.data_ptr(), c * qkv.element_size()
    return _stream_fwd(qkv, (q, q + slab, q + 2 * slab), (3 * c, 3 * c), b, n, n, c, bias,
                       qv_bias, scale, num_heads, bounded_scores, want_lse, dropout,
                       _fold_args(b, fold, dropout_rate), what)


def _launch(qkv, bias, qv_bias, scale, num_heads, bounded_scores, want_lse,
            seed=None, dropout_rate=0.0, fold=None):
    """K1 (``route(N)`` "fused") or K3 ("stream"): the streaming forward's
    kernel on packed qkv, counted on ``fused_qkv_attention.launches`` or
    ``.stream_launches``."""
    fused = route(qkv.shape[1]) == "fused"
    got = _packed_fwd(qkv, bias, qv_bias, scale, num_heads, bounded_scores, want_lse, seed,
                      dropout_rate, fold, "attention forward")
    if fused:
        fused_qkv_attention.launches += 1
    else:
        fused_qkv_attention.stream_launches += 1
    return got


def _launch_cross(q, kv, bias, qv_bias, scale, num_heads, bounded_scores, want_lse):
    """K5: the streaming forward on q [B, Nq, C] and packed kv [B, Nk, 2C]."""
    b, nq, nk, c = _check_cross(q, kv, num_heads)
    _check_aux("bias", bias, (num_heads, nq, nk), q.device)
    _check_aux("qv_bias", qv_bias, (3, c), q.device)
    k = kv.data_ptr()
    out, lse = _stream_fwd(q, (q.data_ptr(), k, k + c * kv.element_size()), (c, 2 * c), b, nq,
                           nk, c, bias, qv_bias, scale, num_heads, bounded_scores, want_lse,
                           (None, 0, 1.0), (b, b, 0), "cross attention forward")
    cross_qkv_attention.launches += 1
    return out, lse


def _check_bwd(qkv, bias, qv_bias, lse, g, num_heads) -> Tuple[int, int, int]:
    """Checks what both backward kernels require; returns (B, N, C)."""
    b, n, c = _check_qkv(qkv, num_heads)
    _check_aux("bias", bias, (num_heads, n, n), qkv.device)
    _check_aux("qv_bias", qv_bias, (3, c), qkv.device)
    _check_aux("lse", lse, (b, num_heads, n), qkv.device)
    _check_g(g, qkv, (b, n, c))
    return b, n, c


def _bias_buffers(bias, num_heads, nq, nk, want_dbias, device):
    """(ldb, dbias) as the streaming backward takes them: a zeroed
    [H, Nq, ldb] f32 dbias with the pitch ldb = Nk rounded up to a multiple
    of 4, into which kernel 1 adds each image's ds four columns at a time
    with 16-byte f32 atomics, or None. The kernels read the bias itself as it
    stands, through shared memory (kernel 2 transposed there): no copy of
    it, and no transposed copy, is built."""
    ldb = -(-nk // 4) * 4
    dbias = None
    if bias is not None and want_dbias:
        dbias = torch.zeros((num_heads, nq, ldb), dtype=torch.float32, device=device)
    return ldb, dbias


def _stream_bwd(x, ptrs, pitches, b, nq, nk, c, bias, qv_bias, lse, scale, num_heads,
                want_dbias, dropout, fold, what):
    """The streaming backward's two kernels on q, k, v, g, the forward's
    output o and dq, dk, dv given as base pointers ``ptrs`` with row pitches
    ``pitches`` = (ldq, ldkv, ldg, ldo, lddq, lddkv), Nq query rows against
    Nk keys of C = H·D columns, for the tensor x they lie in. Returns dbias
    [H, Nq, Nk] or None."""
    ldb, dbias = _bias_buffers(bias, num_heads, nq, nk, want_dbias, x.device)
    # the row sums of the softmax vjp, written by kernel 1 and read by kernel 2
    rowsum = torch.empty((b, num_heads, nq), dtype=torch.float32, device=x.device)
    q, k, v, g, o, dq, dk, dv = ptrs
    seed_ptr, threshold, inv_keep = dropout
    lib = _lib("flash_attention_stream_bwd")
    with torch.cuda.device(x.device):
        err = lib.uvit_flash_attention_stream_bwd(
            q, k, v, g, o, _ptr(bias), _ptr(qv_bias), lse.data_ptr(), rowsum.data_ptr(), dq, dk,
            dv, _ptr(dbias), seed_ptr, *pitches, b, nq, nk, ldb, num_heads, c // num_heads,
            _DTYPES[x.dtype], *fold, float(scale), threshold, inv_keep,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _native.raise_on(lib, err, what)
    # the sums without their padding column: a view, not a copy
    return None if dbias is None else dbias[..., :nk]


def _packed_bwd(qkv, bias, qv_bias, lse, out, g, scale, num_heads, want_dbias, seed,
                dropout_rate, fold, what):
    """The streaming backward's two kernels on packed qkv and dqkv: (dqkv,
    dbias, dqvb)."""
    b, n, c = _check_bwd(qkv, bias, qv_bias, lse, g, num_heads)
    _check_g(out, qkv, (b, n, c))
    dropout = _dropout_args(seed, dropout_rate, qkv.device)
    dqkv = torch.empty_like(qkv)
    slab = c * qkv.element_size()
    q, dq = qkv.data_ptr(), dqkv.data_ptr()
    dbias = _stream_bwd(qkv, (q, q + slab, q + 2 * slab, g.data_ptr(), out.data_ptr(), dq,
                              dq + slab, dq + 2 * slab), (3 * c, 3 * c, c, c, 3 * c, 3 * c), b, n,
                        n, c, bias, qv_bias, lse, scale, num_heads, want_dbias, dropout,
                        _fold_args(b, fold, dropout_rate), what)
    dqvb = reduce_qv_bias_grad(dqkv) if qv_bias is not None else None
    return dqkv, dbias, dqvb


def _launch_cross_bwd(q, kv, bias, qv_bias, lse, out, g, scale, num_heads, want_dbias):
    """K5's backward: the streaming backward's two kernels on q, kv, dq and
    dkv."""
    b, nq, nk, c = _check_cross(q, kv, num_heads)
    _check_aux("bias", bias, (num_heads, nq, nk), q.device)
    _check_aux("qv_bias", qv_bias, (3, c), q.device)
    _check_aux("lse", lse, (b, num_heads, nq), q.device)
    _check_g(g, q, (b, nq, c))
    _check_g(out, q, (b, nq, c))
    dq, dkv = torch.empty_like(q), torch.empty_like(kv)
    slab = c * kv.element_size()
    k, dk = kv.data_ptr(), dkv.data_ptr()
    dbias = _stream_bwd(q, (q.data_ptr(), k, k + slab, g.data_ptr(), out.data_ptr(),
                            dq.data_ptr(), dk, dk + slab), (c, 2 * c, c, c, c, 2 * c), b, nq, nk,
                        c, bias, qv_bias, lse, scale, num_heads, want_dbias, (None, 0, 1.0),
                        (b, b, 0), "cross attention backward")
    cross_qkv_attention_bwd.launches += 1
    dqvb = cross_qv_bias_grad(dq, dkv) if qv_bias is not None else None
    return dq, dkv, dbias, dqvb


def _launch_bwd(qkv, bias, qv_bias, lse, out, g, scale, num_heads, want_dbias,
                seed=None, dropout_rate=0.0, fold=None):
    """K2 (``route(N)`` "fused") or K4 ("stream"): the streaming backward's
    two kernels on packed qkv and dqkv, counted on
    ``fused_qkv_attention_bwd.launches`` or ``.stream_launches``."""
    fused = route(qkv.shape[1]) == "fused"
    got = _packed_bwd(qkv, bias, qv_bias, lse, out, g, scale, num_heads, want_dbias, seed,
                      dropout_rate, fold, "attention backward")
    if fused:
        fused_qkv_attention_bwd.launches += 1
    else:
        fused_qkv_attention_bwd.stream_launches += 1
    return got


def fused_qkv_attention_bwd(
    qkv: torch.Tensor,
    bias: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: float,
    num_heads: int,
    *,
    out: Optional[torch.Tensor] = None,
    want_dbias: bool = True,
    seed: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    fold: philox.Fold = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Backward of the fused attention from the forward's row log-sum-exp.

    qkv, bias, qv_bias, seed, dropout_rate and fold as given to the forward
    (the dropout mask is replayed from the seed); lse [B, H, N] f32 from it; g
    [B, N, C] the output's cotangent, in qkv.dtype; out [B, N, C] the
    forward's output, from which both routes form the row sums of the
    softmax vjp (``rowsum_from_out``): required, the call raises without it.
    Returns (dqkv [B, N, 3C] in qkv.dtype, dbias [H, N, N] f32 summed over
    the batch, dqvb [3, C] f32 with the k row zero); dbias is None without a
    bias or when ``want_dbias`` is False, dqvb None without a q/v bias."""
    if out is None:
        raise ValueError("the attention backward needs the forward's output out (the row sums "
                         "of the softmax vjp are formed from it)")
    stream = route(qkv.shape[1]) == "stream"
    if qkv.device.type == "cpu":
        if dropout_rate > 0.0:
            philox.check_seed(seed, qkv.device)
        if stream:
            dqkv, dbias, dqvb = _stream_bwd_plain(qkv, bias, qv_bias, lse, out, g, scale,
                                                  num_heads, seed, dropout_rate, fold)
        else:
            dqkv, dbias, dqvb = fused_qkv_attention_bwd_plain(
                qkv, bias, qv_bias, lse, g, scale, num_heads, out=out, seed=seed,
                dropout_rate=dropout_rate, fold=fold)
        return dqkv, dbias if want_dbias else None, dqvb
    return _launch_bwd(qkv, bias, qv_bias, lse, out, g.contiguous(), scale, num_heads,
                       want_dbias, seed, dropout_rate, fold)


class _FusedQKVAttention(torch.autograd.Function):
    """K1 or K3 with the row lse forward, K2 or K4 backward, by ``route(N)``
    (the ``jax.custom_vjp`` of :1369-1424 over ``_dispatch_fwd`` /
    ``_dispatch_bwd``, :1378-1406). The lse output is not differentiable. The seed and the
    rate are saved, and the backward replays the forward's dropout mask. The
    output is saved too, for the backward's row sums; the model's proj layer
    saves the same tensor, so it costs no memory there."""

    @staticmethod
    def forward(ctx, qkv, bias, qv_bias, scale, num_heads, bounded, seed, dropout_rate, fold):
        out, lse = _forward(qkv, bias, qv_bias, scale, num_heads, bounded, True, seed,
                            dropout_rate, fold)
        ctx.save_for_backward(qkv, bias, qv_bias, lse, seed, out)
        ctx.scale, ctx.num_heads, ctx.dropout_rate = scale, num_heads, dropout_rate
        ctx.fold = fold
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        qkv, bias, qv_bias, lse, seed, out = ctx.saved_tensors
        dqkv, dbias, dqvb = fused_qkv_attention_bwd(
            qkv, bias, qv_bias, lse, g, ctx.scale, ctx.num_heads, out=out,
            want_dbias=ctx.needs_input_grad[1], seed=seed, dropout_rate=ctx.dropout_rate,
            fold=ctx.fold,
        )
        return dqkv, dbias, dqvb, None, None, None, None, None, None


def _forward(qkv, bias, qv_bias, scale, num_heads, bounded, want_lse, seed, dropout_rate,
             fold=None):
    """The plain version for a CPU tensor (the streaming forward computes
    the same function, so it is ``stream_fwd_plain`` too); for a CUDA tensor
    the kernel ``route(N)`` names."""
    if qkv.device.type == "cpu":
        if dropout_rate > 0.0:
            philox.check_seed(seed, qkv.device)
        return fused_qkv_attention_plain(qkv, bias, qv_bias, scale, num_heads,
                                         bounded_scores=bounded, seed=seed,
                                         dropout_rate=dropout_rate, fold=fold)
    return _launch(qkv, bias, qv_bias, scale, num_heads, bounded, want_lse, seed, dropout_rate,
                   fold)


# K3 computes the function K1 computes: one plain version serves both.
stream_fwd_plain = fused_qkv_attention_plain


def fused_qkv_attention(
    qkv: torch.Tensor,
    bias: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    seed: Optional[torch.Tensor],
    scale: float,
    num_heads: int,
    dropout_rate: float = 0.0,
    *,
    bounded_scores: Optional[bool] = None,
    want_lse: bool = False,
    fold: philox.Fold = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused multi-head attention over packed qkv activations.

    qkv: [B, N, 3C] bf16 or f32; bias: [H, N, N] f32 or None; qv_bias:
    [3, C] f32 (rows q|k|v, the k row unused per the reference's no-key-bias
    rule) added to the q/v slabs in the input dtype, or None; seed: a
    one-element int64 tensor on qkv's device (``philox.draw_seed``), read
    only when ``dropout_rate > 0``: the probabilities are then dropped at
    that rate inside the kernel and the kept ones scaled by 1/(1 − rate).
    Returns out [B, N, C] in qkv.dtype, and with ``want_lse`` also the row
    log-sum-exp [B, H, N] f32 of the undropped softmax. ``bounded_scores``
    defaults to the module's BOUNDED_SCORES. ``fold`` = (b, B, off): qkv's
    images are a data rank's batch fold, and the mask is keyed on their
    unsharded images (see the module doc). Under grad mode with an input
    that requires grad, the output carries the K2 or K4 backward, which
    replays the same mask."""
    bounded = BOUNDED_SCORES if bounded_scores is None else bool(bounded_scores)
    dropout_rate = float(dropout_rate)
    if dropout_rate <= 0.0:
        seed, dropout_rate, fold = None, 0.0, None
    if fold is not None:
        fold = philox.check_fold(qkv.shape[0], fold)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (qkv, bias, qv_bias)):
        _refuse_in_plain_only("fused_qkv_attention")
        out, lse = _FusedQKVAttention.apply(qkv, bias, qv_bias, scale, num_heads, bounded,
                                            seed, dropout_rate, fold)
    else:
        out, lse = _forward(qkv, bias, qv_bias, scale, num_heads, bounded, want_lse, seed,
                            dropout_rate, fold)
    return (out, lse) if want_lse else out


def cross_qkv_attention_bwd(
    q: torch.Tensor,
    kv: torch.Tensor,
    bias: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: float,
    num_heads: int,
    *,
    out: torch.Tensor,
    want_dbias: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Backward of ``cross_qkv_attention`` from its row log-sum-exp.

    q, kv, bias and qv_bias as given to the forward; lse [B, H, Nq] f32 and
    out [B, Nq, C] (the output, for the row sums of the softmax vjp) from
    it; g [B, Nq, C] the output's cotangent, in q.dtype. Returns (dq
    [B, Nq, C], dkv [B, Nk, 2C], both in q.dtype, dbias [H, Nq, Nk] f32
    summed over the batch, dqvb [3, C] f32 with the k row zero); dbias is
    None without a bias or when ``want_dbias`` is False, dqvb None without a
    q/v bias. On a CUDA tensor K5's backward (K4's two kernels) runs."""
    if q.device.type == "cpu":
        dq, dbias, c = cross_bwd_dq_plain(q, kv, bias, qv_bias, lse, g, scale, num_heads, out=out)
        dkv = cross_bwd_dkv_plain(q, kv, bias, qv_bias, lse, c, g, scale, num_heads)
        dqvb = cross_qv_bias_grad(dq, dkv) if qv_bias is not None else None
        return dq, dkv, dbias if want_dbias else None, dqvb
    return _launch_cross_bwd(q, kv, bias, qv_bias, lse, out, g.contiguous(), scale, num_heads,
                             want_dbias)


class _CrossQKVAttention(torch.autograd.Function):
    """K5 forward with the row lse, K5 backward (the ``jax.custom_vjp`` of
    :1253-1288). The lse output is not differentiable; the output is saved
    for the backward's row sums."""

    @staticmethod
    def forward(ctx, q, kv, bias, qv_bias, scale, num_heads, bounded):
        out, lse = _cross_forward(q, kv, bias, qv_bias, scale, num_heads, bounded, True)
        ctx.save_for_backward(q, kv, bias, qv_bias, lse, out)
        ctx.scale, ctx.num_heads = scale, num_heads
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, kv, bias, qv_bias, lse, out = ctx.saved_tensors
        dq, dkv, dbias, dqvb = cross_qkv_attention_bwd(
            q, kv, bias, qv_bias, lse, g, ctx.scale, ctx.num_heads, out=out,
            want_dbias=ctx.needs_input_grad[2])
        return dq, dkv, dbias, dqvb, None, None, None


def _cross_forward(q, kv, bias, qv_bias, scale, num_heads, bounded, want_lse):
    """The plain version for a CPU tensor, K5 for a CUDA tensor."""
    if q.device.type == "cpu":
        return cross_fwd_plain(q, kv, bias, qv_bias, scale, num_heads, bounded_scores=bounded)
    return _launch_cross(q, kv, bias, qv_bias, scale, num_heads, bounded, want_lse)


def cross_qkv_attention(
    q: torch.Tensor,
    kv: torch.Tensor,
    bias: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    scale: float,
    num_heads: int,
    dropout_rate: float = 0.0,
    *,
    bounded_scores: Optional[bool] = None,
    want_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Attention of q [B, Nq, C] against packed kv [B, Nk, 2C] (k|v).

    The local computation of token- (sequence-)parallel attention: q rows are
    one shard, kv the gathered whole. bias: [H, Nq, Nk] f32 (the shard's
    query rows) or None; qv_bias: [3, C] f32 (the k row unused) added to q
    and v in the input dtype, or None. Returns out [B, Nq, C] in q.dtype,
    and with ``want_lse`` also the row log-sum-exp [B, H, Nq] f32.
    ``dropout_rate`` must be 0, as in the reference (:1263): its in-kernel
    mask is not defined across re-sharded grids. ``bounded_scores``
    defaults to the module's BOUNDED_SCORES. Under grad mode with an input
    that requires grad, the output carries K5's backward."""
    if dropout_rate != 0.0:
        raise ValueError("seq-sharded attention requires attn_drop=0, got dropout_rate "
                         f"{dropout_rate}")
    bounded = BOUNDED_SCORES if bounded_scores is None else bool(bounded_scores)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, kv, bias, qv_bias)):
        _refuse_in_plain_only("cross_qkv_attention")
        out, lse = _CrossQKVAttention.apply(q, kv, bias, qv_bias, scale, num_heads, bounded)
    else:
        out, lse = _cross_forward(q, kv, bias, qv_bias, scale, num_heads, bounded, want_lse)
    return (out, lse) if want_lse else out


def seq_sharded_qkv_attention(
    qkv_local: torch.Tensor,
    bias_rows: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    scale: float,
    num_heads: int,
    group: seq.SeqGroup,
    n: int,
) -> torch.Tensor:
    """Token- (sequence-)sharded fused attention over ``group``
    (:1291-1358).

    qkv_local [B, Nq, 3C] holds this rank's query rows ``group.rows(n)`` of
    the n tokens; bias_rows [H, Nq, n] f32 the bias of those rows, or None.
    Each rank gathers k/v over the group (``seq.gather_tokens``: padded to
    ceil(n / S) rows for the gather and cut back to the n real keys, so no
    key mask and no dense [H, n_pad, n_pad] bias is built) and runs
    ``cross_qkv_attention`` on its query rows; dk/dv go back through the
    gather's backward, a reduce-scatter. Returns out [B, Nq, C]. With one
    rank it is ``fused_qkv_attention`` (:1322-1324)."""
    if group.size == 1:
        return fused_qkv_attention(qkv_local, bias_rows, qv_bias, None, scale, num_heads)
    c = qkv_local.shape[-1] // 3
    kv = seq.gather_tokens(qkv_local[..., c:], group, n)
    return cross_qkv_attention(qkv_local[..., :c].contiguous(), kv, bias_rows, qv_bias, scale,
                               num_heads)


# Kernel launches since the last reset (a run sets them to 0 to count its own).
# ``launches`` counts K1 and K2, ``stream_launches`` K3 and K4 (one per call
# of K4's pair of kernels), ``cross_qkv_attention.launches`` and
# ``cross_qkv_attention_bwd.launches`` K5's forward and backward (one per call
# of its pair of kernels).
fused_qkv_attention.launches = 0
fused_qkv_attention_bwd.launches = 0
fused_qkv_attention.stream_launches = 0
fused_qkv_attention_bwd.stream_launches = 0
cross_qkv_attention.launches = 0
cross_qkv_attention_bwd.launches = 0
