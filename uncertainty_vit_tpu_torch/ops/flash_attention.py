"""Fused multi-head attention over packed qkv: forward (K1) and backward (K2).

Counterpart of ``fused_qkv_attention`` in uncertainty_vit_tpu/ops/
flash_attention.py (:1369-1424: the ``jax.custom_vjp`` over ``_fwd_kernel``
:188-241 and ``_bwd_kernel`` :244-326). Inputs are
the fused qkv activations [B, N, 3C] straight out of the qkv matmul (q|k|v
concatenated, heads interleaved as C = H·D); the per-head slabs are cut
inside the kernel, so no [B, H, N, D] copies and no [B, H, N, N] scores
reach device memory.

- On a CPU tensor the call runs ``fused_qkv_attention_plain`` (forward)
  and ``fused_qkv_attention_bwd_plain`` (backward), the same math in plain
  PyTorch.
- On a CUDA tensor the forward launches the Hopper kernel of
  ``csrc/flash_attention_fwd.cu`` and adds one to
  ``fused_qkv_attention.launches``; the backward launches
  ``csrc/flash_attention_bwd.cu`` and adds one to
  ``fused_qkv_attention_bwd.launches``. Either raises on what its kernel
  does not take. There is no fallback.

When grad mode is on and an input requires grad, the call goes through
``_FusedQKVAttention`` (a ``torch.autograd.Function``): its forward is K1
with the row log-sum-exp, its backward K2, which rebuilds the
probabilities from that lse. Otherwise only the forward runs.

Attention dropout (``dropout_rate > 0``) runs inside both kernels
(``_dropout_mask`` :156-162, applied at :233-234 and replayed at :298-301):
the keep mask is a pure function of the seed and of each entry's (image,
head, row, column) (``ops/philox.py``), so K2 replays K1's mask whatever
tiles either uses, and the plain versions draw the very same mask. The
reference's TPU kernels seed a hardware generator per program instead, so
against it only distributions compare.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from uncertainty_vit_tpu_torch.ops import _native, philox

# Skip the softmax max pass: exp(s)/Σexp(s) equals the max-subtracted
# softmax whenever exp(s) does not overflow f32 (|s| ≲ 88). Safe for trained
# ViTs at these shapes, not for arbitrary inputs; the finetune driver turns
# it on for training and evaluation (cli/common.py:34-44 of the reference
# package). Read at call time when ``bounded_scores`` is not given.
BOUNDED_SCORES = False
# The kernel's only head width (ViT-B and ViT-L).
KERNEL_HEAD_DIM = 64
# The backward kernel keeps a whole (image, head) of two of q/k/v/g in
# shared memory: it takes N up to this (ViT 224 and below; N=577/1025 are
# the streaming kernels' shapes).
BWD_MAX_N = 256

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


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
    image0: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: returns (out [B, N, C] in
    qkv.dtype, lse [B, H, N] f32). ``image0`` is the index of qkv's first
    image in the batch whose dropout mask is drawn, so that a large batch
    can be computed in slices.

    Mirrors ``_fwd_kernel``: q/v bias added in the input dtype; scores,
    softmax and the row sums in f32 from the (exactly upcast) inputs; with
    dropout the unnormalized probabilities times the scaled keep mask of
    ``seed``, after the row sum (the lse is the undropped softmax's); they
    are rounded to the input dtype before the product with v; the output
    scaled by 1/Σe."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    dt = qkv.dtype
    q, k, v = qkv.split(c, dim=-1)
    if qv_bias is not None:
        q = q + qv_bias[0].to(dt)
        v = v + qv_bias[2].to(dt)

    def heads(t):
        return t.reshape(b, n, num_heads, d).transpose(1, 2).float()

    q, k, v = heads(q), heads(k), heads(v)
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
        e = e * _keep_scale(seed, dropout_rate, b, num_heads, n, image0)
    out = torch.matmul(e.to(dt).float(), v) * r
    return out.transpose(1, 2).reshape(b, n, c).to(dt), lse[..., 0]


def _keep_scale(seed: torch.Tensor, rate: float, b: int, num_heads: int, n: int,
                image0: int = 0) -> torch.Tensor:
    """[B, H, N, N] f32: 1/(1 − rate) where the attention entry of images
    [image0, image0 + B) is kept, 0 where it is dropped."""
    bits = philox.attention_bits(seed, b, num_heads, n, n, image0=image0)
    return philox.keep_scale(bits, rate)


def reduce_qv_bias_grad(dqkv: torch.Tensor) -> torch.Tensor:
    """d(q/v bias) [3, C] f32: the f32 sum of dqkv over (batch, tokens) per
    section, with the k row zeroed: no key bias is ever added, so its
    cotangent is 0 (``_reduce_qv_bias_grad``, :329-337)."""
    b, n, c3 = dqkv.shape
    dqvb = dqkv.reshape(b, n, 3, c3 // 3).float().sum(dim=(0, 1))
    return dqvb * torch.tensor([1.0, 0.0, 1.0], device=dqkv.device)[:, None]


def fused_qkv_attention_bwd_plain(
    qkv: torch.Tensor,
    bias: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: float,
    num_heads: int,
    *,
    seed: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    image0: int = 0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain PyTorch version of the backward kernel: returns (dqkv [B, N, 3C]
    in qkv.dtype, dbias [H, N, N] f32 or None, dqvb [3, C] f32 or None).
    ``image0`` as in the forward's plain version.

    Mirrors ``_bwd_kernel`` (:291-326): p = exp(s − lse) from the saved
    row log-sum-exp (no max or row-sum recompute); p_d = p·mask, the
    forward's keep mask replayed from ``seed`` (p_d = p without dropout);
    dv = p_dᵀg with p_d cast to g's dtype; t = (g vᵀ)·p_d, c = rowsum(t),
    ds = t − p·c with the undropped p; dq = ds_c·k·scale and dk =
    ds_cᵀ·q·scale with ds_c = ds cast to the input dtype; dbias = Σ_b ds in
    f32. Products take the (exactly upcast) operands in f32."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    dt = qkv.dtype
    q, k, v = qkv.split(c, dim=-1)
    if qv_bias is not None:
        q = q + qv_bias[0].to(dt)
        v = v + qv_bias[2].to(dt)

    def heads(t):
        return t.reshape(b, n, num_heads, d).transpose(1, 2).float()

    q, k, v, gh = heads(q), heads(k), heads(v), heads(g.to(dt))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - lse.float()[..., None])
    p_d = p * _keep_scale(seed, dropout_rate, b, num_heads, n, image0) if dropout_rate > 0.0 else p
    dv = torch.matmul(p_d.to(dt).float().transpose(-1, -2), gh)
    t = torch.matmul(gh, v.transpose(-1, -2)) * p_d
    ds = t - p * t.sum(dim=-1, keepdim=True)
    ds_c = ds.to(dt).float()
    dq = torch.matmul(ds_c, k) * scale
    dk = torch.matmul(ds_c.transpose(-1, -2), q) * scale

    def tokens(t):
        return t.transpose(1, 2).reshape(b, n, c).to(dt)

    dqkv = torch.cat([tokens(dq), tokens(dk), tokens(dv)], dim=-1)
    dbias = ds.sum(dim=0) if bias is not None else None
    dqvb = reduce_qv_bias_grad(dqkv) if qv_bias is not None else None
    return dqkv, dbias, dqvb


_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
# C signatures: pointers, then the ints, the scale and the dropout
# threshold and 1/(1 − rate), then the stream
_ARGTYPES = {
    # qkv, bias, qv_bias, out, lse, seed; batch, n, num_heads, dtype, scale, bounded,
    # threshold, inv_keep; stream
    "flash_attention_fwd": [_P] * 6 + [_I] * 4 + [_F, _I, _U, _F, _P],
    # qkv, bias, bias_t, qv_bias, lse, g, dqkv, dbias, seed; batch, n, ldb, num_heads,
    # dtype, scale, threshold, inv_keep; stream
    "flash_attention_bwd": [_P] * 9 + [_I] * 5 + [_F, _U, _F, _P],
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


def _check_qkv(qkv: torch.Tensor, num_heads: int) -> Tuple[int, int, int]:
    """Checks what both kernels require of qkv; returns (B, N, C)."""
    if not qkv.is_cuda:
        raise ValueError(f"the attention kernel runs on CUDA tensors, got {qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"qkv must be bfloat16 or float32, got {qkv.dtype}")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads) != 0:
        raise ValueError(f"qkv must be [B, N, 3·H·D] with H={num_heads}, got {tuple(qkv.shape)}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    head_dim = c // num_heads
    if head_dim != KERNEL_HEAD_DIM:
        raise ValueError(f"the attention kernel takes head_dim {KERNEL_HEAD_DIM}, got {head_dim}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16 != 0:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    return b, n, c


def _launch(qkv, bias, qv_bias, scale, num_heads, bounded_scores, want_lse,
            seed=None, dropout_rate=0.0):
    b, n, c = _check_qkv(qkv, num_heads)
    _check_aux("bias", bias, (num_heads, n, n), qkv.device)
    _check_aux("qv_bias", qv_bias, (3, c), qkv.device)
    seed_ptr, threshold, inv_keep = _dropout_args(seed, dropout_rate, qkv.device)

    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device) \
        if want_lse else None
    lib = _lib("flash_attention_fwd")
    with torch.cuda.device(qkv.device):
        err = lib.uvit_flash_attention_fwd(
            qkv.data_ptr(), _ptr(bias), _ptr(qv_bias), out.data_ptr(), _ptr(lse), seed_ptr,
            b, n, num_heads, _DTYPES[qkv.dtype], float(scale), int(bounded_scores),
            threshold, inv_keep, torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _native.raise_on(lib, err, "attention forward")
    fused_qkv_attention.launches += 1
    return out, lse


def _launch_bwd(qkv, bias, qv_bias, lse, g, scale, num_heads, want_dbias,
                seed=None, dropout_rate=0.0):
    b, n, c = _check_qkv(qkv, num_heads)
    seed_ptr, threshold, inv_keep = _dropout_args(seed, dropout_rate, qkv.device)
    if n > BWD_MAX_N:
        raise ValueError(f"the attention backward kernel takes N <= {BWD_MAX_N}, got {n}")
    _check_aux("bias", bias, (num_heads, n, n), qkv.device)
    _check_aux("qv_bias", qv_bias, (3, c), qkv.device)
    _check_aux("lse", lse, (b, num_heads, n), qkv.device)
    if g.device != qkv.device or g.dtype != qkv.dtype or tuple(g.shape) != (b, n, c) \
            or not g.is_contiguous() or g.data_ptr() % 16 != 0:
        raise ValueError(f"g must be a contiguous, 16-byte aligned {qkv.dtype} tensor of "
                         f"shape {(b, n, c)} on {qkv.device}; got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")

    dqkv = torch.empty_like(qkv)
    # The kernel reads bias pairs as 8-byte loads, from [H, N, ldb] copies of
    # the bias and of its transpose with an even pitch ldb (1.9 MB each at
    # ViT-B/16 224), and adds each image's ds pairs into a zeroed dbias of the
    # same pitch with 8-byte f32 atomics.
    ldb = n + n % 2
    bias_p = bias_t = dbias = None
    if bias is not None:
        shape = (num_heads, n, ldb)
        bias_p = torch.zeros(shape, dtype=torch.float32, device=qkv.device)
        bias_t = torch.zeros(shape, dtype=torch.float32, device=qkv.device)
        bias_p[..., :n] = bias
        bias_t[..., :n] = bias.transpose(1, 2)
        if want_dbias:
            dbias = torch.zeros(shape, dtype=torch.float32, device=qkv.device)
    lib = _lib("flash_attention_bwd")
    with torch.cuda.device(qkv.device):
        err = lib.uvit_flash_attention_bwd(
            qkv.data_ptr(), _ptr(bias_p), _ptr(bias_t), _ptr(qv_bias), lse.data_ptr(),
            g.data_ptr(), dqkv.data_ptr(), _ptr(dbias), seed_ptr, b, n, ldb, num_heads,
            _DTYPES[qkv.dtype], float(scale), threshold, inv_keep,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _native.raise_on(lib, err, "attention backward")
    fused_qkv_attention_bwd.launches += 1
    dqvb = reduce_qv_bias_grad(dqkv) if qv_bias is not None else None
    return dqkv, None if dbias is None else dbias[..., :n].contiguous(), dqvb


def fused_qkv_attention_bwd(
    qkv: torch.Tensor,
    bias: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: float,
    num_heads: int,
    *,
    want_dbias: bool = True,
    seed: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Backward of the fused attention from the forward's row log-sum-exp.

    qkv, bias, qv_bias, seed and dropout_rate as given to the forward (the
    dropout mask is replayed from the seed); lse [B, H, N] f32 from it; g
    [B, N, C] the output's cotangent, in qkv.dtype. Returns (dqkv
    [B, N, 3C] in qkv.dtype, dbias [H, N, N] f32 summed over the batch,
    dqvb [3, C] f32 with the k row zero); dbias is None without a bias or
    when ``want_dbias`` is False, dqvb None without a q/v bias."""
    if qkv.device.type == "cpu":
        if dropout_rate > 0.0:
            philox.check_seed(seed, qkv.device)
        dqkv, dbias, dqvb = fused_qkv_attention_bwd_plain(
            qkv, bias, qv_bias, lse, g, scale, num_heads, seed=seed, dropout_rate=dropout_rate)
        return dqkv, dbias if want_dbias else None, dqvb
    return _launch_bwd(qkv, bias, qv_bias, lse, g.contiguous(), scale, num_heads, want_dbias,
                       seed, dropout_rate)


class _FusedQKVAttention(torch.autograd.Function):
    """K1 with the row lse forward, K2 backward (the ``jax.custom_vjp`` of
    :1369-1424). The lse output is not differentiable. The seed and the
    rate are saved, and the backward replays the forward's dropout mask."""

    @staticmethod
    def forward(ctx, qkv, bias, qv_bias, scale, num_heads, bounded, seed, dropout_rate):
        out, lse = _forward(qkv, bias, qv_bias, scale, num_heads, bounded, True, seed,
                            dropout_rate)
        ctx.save_for_backward(qkv, bias, qv_bias, lse, seed)
        ctx.scale, ctx.num_heads, ctx.dropout_rate = scale, num_heads, dropout_rate
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        qkv, bias, qv_bias, lse, seed = ctx.saved_tensors
        dqkv, dbias, dqvb = fused_qkv_attention_bwd(
            qkv, bias, qv_bias, lse, g, ctx.scale, ctx.num_heads,
            want_dbias=ctx.needs_input_grad[1], seed=seed, dropout_rate=ctx.dropout_rate,
        )
        return dqkv, dbias, dqvb, None, None, None, None, None


def _forward(qkv, bias, qv_bias, scale, num_heads, bounded, want_lse, seed, dropout_rate):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if qkv.device.type == "cpu":
        if dropout_rate > 0.0:
            philox.check_seed(seed, qkv.device)
        return fused_qkv_attention_plain(qkv, bias, qv_bias, scale, num_heads,
                                         bounded_scores=bounded, seed=seed,
                                         dropout_rate=dropout_rate)
    return _launch(qkv, bias, qv_bias, scale, num_heads, bounded, want_lse, seed, dropout_rate)


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
    defaults to the module's BOUNDED_SCORES. Under grad mode with an input
    that requires grad, the output carries the K2 backward."""
    bounded = BOUNDED_SCORES if bounded_scores is None else bool(bounded_scores)
    dropout_rate = float(dropout_rate)
    if dropout_rate <= 0.0:
        seed, dropout_rate = None, 0.0
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (qkv, bias, qv_bias)):
        out, lse = _FusedQKVAttention.apply(qkv, bias, qv_bias, scale, num_heads, bounded,
                                            seed, dropout_rate)
    else:
        out, lse = _forward(qkv, bias, qv_bias, scale, num_heads, bounded, want_lse, seed,
                            dropout_rate)
    return (out, lse) if want_lse else out


# Kernel launches since the last reset (a run sets them to 0 to count its own).
fused_qkv_attention.launches = 0
fused_qkv_attention_bwd.launches = 0
