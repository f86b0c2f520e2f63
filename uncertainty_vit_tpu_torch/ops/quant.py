"""Int8 matmuls of the ViT trunk with dynamic quantization (K6, K7).

Counterpart of uncertainty_vit_tpu/ops/quant.py (``int8_dense`` :359-421
over ``_qmm`` :144-177 and ``_wgrad`` :249-287), same names, same scheme:

  forward   y = x @ w        x per-row scales,    w per-column scales
  dgrad    dx = g @ wᵀ       g per-row scales,    a second int8 copy of w
                             with per-row scales
  wgrad    dw = xᵀ @ g       x and g per-column scales (taken outside the
                             kernel; they factor out of the token sum)

Activations and weights round to nearest (half to even); gradients round
stochastically, ``floor(v + u)`` with u in [0, 1), so that dgrad and wgrad
stay unbiased. Weights stay f32 masters and are quantized in every call.

- On a CPU tensor ``qmm`` and ``wgrad`` run ``qmm_plain`` / ``wgrad_plain``.
- On a CUDA tensor ``qmm`` launches the two kernels of ``csrc/quant_fwd.cu``
  (K6: the rows of x quantized once into an int8 copy, then the product
  int8 x int8 -> int32 on the tensor cores, dequantized and biased in f32
  and rounded once to the output type) and adds one to ``qmm.launches``;
  ``wgrad`` launches the two kernels of ``csrc/quant_wgrad.cu`` (K7:
  quantize-and-transpose, then the int32 product over the tokens) and adds
  one to ``wgrad.launches``. Either raises on what its kernel does not
  take. There is no fallback.

The rounding uniforms are a function of (seed, row, column) of the rounded
matrix (``ops/philox.py``), so the kernels and their plain versions round
every entry alike and agree to the last bit of the int32 sums. The TPU
kernels seed a hardware generator per program: against the reference only
distributions compare.

Under sequence parallelism (``int8_dense(..., shard=...)``) each rank holds
rows [start, start + rows) of every image's n tokens, and on a data axis
(``image0``, ``group``) its images are images image0, image0 + 1, ... of
the global batch; either way its layer equals one process's over the whole
trunk: the stochastic rounding of dgrad and wgrad draws the bits of the
unsharded row (a row window (rows, start, n, image0), ``philox.RowWindow``:
local row b·rows + r is row (image0 + b)·n + start + r), and wgrad takes
its column scales as a max over the ranks that hold the trunk's rows (the
data × seq group, ``parallel.seq.all_reduce_max``), so that the ranks'
int32 sums add up to one process's exactly and the gradient sum of the
train step adds their dequantized shares. Forward and dgrad scale per row
and need nothing more.
The reference's kernels see the global trunk (no shard_map; its interpret
mode computes the layer over all rows).

Out of range: ``v · 127/amax`` can exceed 127 by an ulp, so ``floor(v + u)``
can reach 128. The reference leaves that cast to XLA; here kernel and plain
version both saturate to [-128, 127].

Layouts. The reference's weight is [K, N] = [in, out] and "per-column" means
per output feature; the port's parameters are torch's [out, in]. ``qmm`` and
``quantize_cols`` keep the reference's logical shapes, and the kernel reads
the int8 weight with the contraction contiguous: ``quantize_cols(weight.t())``
of a torch parameter is already so (an elementwise result keeps its input's
strides), anything else is copied once. ``int8_dense`` takes the torch
layout.

Not ported: the reference's ablation switches ``FWD`` / ``DGRAD`` / ``WGRAD``
/ ``STATIC_SCALE`` and their ``_xla_*`` versions (:48-61, :290-356), and the
VMEM budgeting of ``_wgrad_plan`` / ``_split`` / ``_tm``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from uncertainty_vit_tpu_torch.ops import _native, philox
from uncertainty_vit_tpu_torch.ops.flash_attention import _refuse_in_plain_only
from uncertainty_vit_tpu_torch.ops.philox import RowWindow
from uncertainty_vit_tpu_torch.parallel import seq

# The wgrad kernel sums raw int8 products in int32; |sum| <= 127 * 127 * M
# stays below 2^31 only for M <= 133,152. The cap is the power of two below
# (uncertainty_vit_tpu/ops/quant.py:66-70); above it the layer is bf16.
_MAX_M_INT32_ACC = 131_072

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, wq, ws, bias, seed, y, xq, row scale; m, k, n, x dtype, y dtype, sr,
# window rows, start, n, image0; stream
_QMM_ARGTYPES = [_P] * 8 + [_I] * 10 + [_P]
# x, g, inv_x, inv_g, seed, xq, gq, acc; m, m_pad, k, n, dtype, window rows,
# start, n, image0; stream
_WGRAD_ARGTYPES = [_P] * 8 + [_I] * 9 + [_P]
# Token rows are padded with zeros to a multiple of this in K7's int8 copies.
_WGRAD_M_ALIGN = 128


def supported(m: int, k: int, n: int) -> bool:
    """Which matmuls are int8: K and N multiples of 128, 8 <= M <= 131072
    (the reference's rule, :73-77). It is part of what the model computes:
    where it says no, the layer is the bf16 matmul."""
    return k % 128 == 0 and n % 128 == 0 and 8 <= m <= _MAX_M_INT32_ACC


def quantize_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column symmetric int8 quantization of a [K, N] matrix: (wq int8
    [K, N], scale f32 [1, N]) with scale = max(amax, 1e-30) / 127 and
    wq = round(w / scale) (:84-91). wq keeps w's strides."""
    wf = w.float()
    scale = _col_amax(wf).clamp_min(1e-30) * (1.0 / 127.0)
    return torch.round(wf / scale).to(torch.int8), scale


def _col_amax(t: torch.Tensor) -> torch.Tensor:
    """[1, C]: the largest |entry| of every column, in t's dtype (exact): one
    reduction, no copy of |t|."""
    return torch.linalg.vector_norm(t, ord=float("inf"), dim=0, keepdim=True)


def _to_int8(t: torch.Tensor) -> torch.Tensor:
    return t.clamp(-128.0, 127.0).to(torch.int8)


def quantize_rows(x: torch.Tensor, seed: Optional[torch.Tensor] = None, sr: bool = False,
                  window: RowWindow = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row quantization of [M, K] as K6 does it (``_quantize_rows_tile``
    :116-125): (xq int8, row scale f32 [M, 1]). The values are multiplied by
    inv = 127 / max(amax, 1e-30) (a true division, not a reciprocal), then
    rounded to nearest even, or ``floor(x · inv + u)`` with the uniforms of
    ``seed`` (those of the unsharded rows under ``window``) when ``sr``."""
    xf = x.float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    inv = torch.full_like(amax, 127.0) / amax.clamp_min(1e-30)
    t = xf * inv
    if sr:
        t = torch.floor(t + philox.quant_uniform(seed, *x.shape, window=window))
    else:
        t = torch.round(t)
    return _to_int8(t), amax * (1.0 / 127.0)


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact product of two int8 matrices, in f64 (sums stay below 2⁵³;
    f32 would be exact only while K · 127² < 2²⁴)."""
    return a.double() @ b.double()


def qmm_plain(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
              bias: Optional[torch.Tensor], seed: Optional[torch.Tensor], sr: bool,
              out_dtype: torch.dtype, window: RowWindow = None) -> torch.Tensor:
    """Plain PyTorch version of K6: y[M, N] = (quant_rows(x) · wq) · row scale
    · ws (+ bias), the sum exact, converted to f32 (round to nearest), the
    two products and the bias add in f32 in this order, one rounding to
    ``out_dtype`` (``_fwd_kernel`` :128-141)."""
    philox.check_window(window, x.shape[0])
    xq, sa = quantize_rows(x, seed, sr, window)
    y = _int_mm(xq, wq).float() * sa * ws.reshape(1, -1)
    if bias is not None:
        y = y + bias.float().reshape(1, -1)
    return y.to(out_dtype)


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return amax.float().clamp_min(1e-30) * (1.0 / 127.0)


def _col_scales(t: torch.Tensor) -> torch.Tensor:
    """[1, C] f32: max(column amax, 1e-30) / 127 (:258-259). |.| and max are
    exact in the input type."""
    return _scale_of(_col_amax(t))


def wgrad_scales(x: torch.Tensor, g: torch.Tensor, group: Optional[seq.SeqGroup] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sx [1, K], sg [1, N]): the column scales of x and g, under ``group``
    over every rank's rows (one all-reduce of both amaxes: a max is exact,
    so each rank holds one process's scales)."""
    if group is None:
        return _col_scales(x), _col_scales(g)
    k = x.shape[1]
    amax = seq.all_reduce_max(torch.cat([_col_amax(x).float(), _col_amax(g).float()], dim=1),
                              group)
    return _scale_of(amax[:, :k]), _scale_of(amax[:, k:])


def wgrad_acc_plain(x: torch.Tensor, g: torch.Tensor, inv_x: torch.Tensor, inv_g: torch.Tensor,
                    seed: torch.Tensor, window: RowWindow = None) -> torch.Tensor:
    """Plain PyTorch version of K7: the raw int32 sums [K, N] of
    round(x · inv_x)ᵀ · floor(g · inv_g + u) over the tokens
    (``_wgrad_kernel`` :216-246), u those of the unsharded rows under
    ``window``."""
    philox.check_window(window, g.shape[0])
    xq = _to_int8(torch.round(x.float() * inv_x))
    gq = _to_int8(torch.floor(g.float() * inv_g
                              + philox.quant_uniform(seed, *g.shape, window=window)))
    return _int_mm(xq.t(), gq).to(torch.int32)


def _dequant_wgrad(acc: torch.Tensor, sx: torch.Tensor, sg: torch.Tensor) -> torch.Tensor:
    return acc.float() * sx.reshape(-1, 1) * sg


def wgrad_plain(x: torch.Tensor, g: torch.Tensor, seed: torch.Tensor, window: RowWindow = None,
                group: Optional[seq.SeqGroup] = None) -> torch.Tensor:
    """dw[K, N] = xᵀ · g through per-column int8 quantization, f32: round to
    nearest on x, stochastic on g, dequantized outside the sum (:249-287).
    Under a seq shard (``window``, ``group``) this rank's share of it."""
    sx, sg = wgrad_scales(x, g, group)
    acc = wgrad_acc_plain(x, g, sx.reciprocal(), sg.reciprocal(), seed, window)
    return _dequant_wgrad(acc, sx, sg)


def _check_act(name: str, t: torch.Tensor) -> torch.Tensor:
    if t.dim() != 2 or t.dtype not in _DTYPES:
        raise ValueError(f"{name} must be a bfloat16 or float32 matrix, got {t.dtype} "
                         f"{tuple(t.shape)}")
    t = t.contiguous()
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t


def _check_supported(m: int, k: int, n: int) -> None:
    if not supported(m, k, n):
        raise ValueError(f"the int8 kernels take K and N multiples of 128 and 8 <= M <= "
                         f"{_MAX_M_INT32_ACC}; got M={m}, K={k}, N={n}")


def _window_args(window: RowWindow, m: int) -> Tuple[int, int, int, int]:
    """The kernels' (rows, start, n, image0): (m, 0, m, 0) draws every
    row's own bits."""
    philox.check_window(window, m)
    return (m, 0, m, 0) if window is None else tuple(window)


def _launch_qmm(x, wq, ws, bias, seed, sr, out_dtype, window: RowWindow = None) -> torch.Tensor:
    x = _check_act("x", x)
    m, k = x.shape
    n = wq.shape[1]
    _check_supported(m, k, n)
    win = _window_args(window, m)
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if wq.dtype != torch.int8 or tuple(wq.shape) != (k, n) or wq.device != x.device:
        raise ValueError(f"wq must be int8 [{k}, {n}] on {x.device}, got {wq.dtype} "
                         f"{tuple(wq.shape)} on {wq.device}")
    wq_t = wq.t().contiguous()  # [N, K]: the contraction contiguous; no copy if it is so
    if wq_t.data_ptr() % 16 != 0:  # TMA reads it from a 16-byte aligned base
        wq_t = wq_t.clone()
    ws = ws.reshape(-1).float().contiguous()
    if ws.numel() != n or ws.device != x.device:
        raise ValueError(f"ws must hold {n} scales on {x.device}")
    if bias is not None:
        bias = bias.reshape(-1).float().contiguous()
        if bias.numel() != n or bias.device != x.device:
            raise ValueError(f"bias must hold {n} values on {x.device}")
    if sr:
        philox.check_seed(seed, x.device)
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    # the first kernel's int8 rows and their scales, which the second reads
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    row_scale = torch.empty(m, dtype=torch.float32, device=x.device)
    lib = _native.typed("quant_fwd", _QMM_ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.uvit_quant_fwd(
            x.data_ptr(), wq_t.data_ptr(), ws.data_ptr(), _native.ptr(bias),
            seed.data_ptr() if sr else None, y.data_ptr(), xq.data_ptr(), row_scale.data_ptr(),
            m, k, n, _DTYPES[x.dtype], _DTYPES[out_dtype], int(sr), *win,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _native.raise_on(lib, err, "int8 matmul")
    qmm.launches += 1
    return y


def qmm(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, bias: Optional[torch.Tensor],
        seed: Optional[torch.Tensor], sr: bool, out_dtype: torch.dtype,
        window: RowWindow = None) -> torch.Tensor:
    """K6: y[M, N] = dequant(quant_rows(x) · wq) (+ bias) in ``out_dtype``.

    x [M, K] bf16 or f32; wq int8 [K, N] and ws f32 [1, N] from
    ``quantize_cols``; bias f32 [N] or None; ``sr`` rounds x stochastically
    with the uniforms of ``seed`` (a one-element int64 tensor on x's device),
    else to nearest; ``window`` (rows, start, n, image0): x holds a seq
    shard's rows of a data rank's images, which draw the unsharded rows'
    uniforms."""
    if x.device.type == "cpu":
        if sr:
            philox.check_seed(seed, x.device)
        return qmm_plain(x, wq, ws, bias, seed, sr, out_dtype, window)
    return _launch_qmm(x, wq, ws, bias, seed, sr, out_dtype, window)


def wgrad_acc(x: torch.Tensor, g: torch.Tensor, inv_x: torch.Tensor, inv_g: torch.Tensor,
              seed: torch.Tensor, window: RowWindow = None) -> torch.Tensor:
    """K7's launcher: the raw int32 sums as a [K, N] view of an [N, K]
    buffer (the layout of a torch weight's gradient); g's rounding draws the
    unsharded rows' uniforms under ``window``."""
    x, g = _check_act("x", x), _check_act("g", g)
    m, k = x.shape
    n = g.shape[1]
    if g.shape[0] != m or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must be {x.dtype} [{m}, N] on {x.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    _check_supported(m, k, n)
    philox.check_seed(seed, x.device)
    win = _window_args(window, m)
    inv_x = inv_x.reshape(-1).float().contiguous()
    inv_g = inv_g.reshape(-1).float().contiguous()
    if inv_x.numel() != k or inv_g.numel() != n:
        raise ValueError("inv_x and inv_g must hold one value per column of x and of g")
    m_pad = -(-m // _WGRAD_M_ALIGN) * _WGRAD_M_ALIGN
    # the int8 copies, tokens contiguous; the second kernel adds its share of
    # the tokens into acc with integer atomics
    xq = torch.empty((k, m_pad), dtype=torch.int8, device=x.device)
    gq = torch.empty((n, m_pad), dtype=torch.int8, device=x.device)
    acc = torch.zeros((n, k), dtype=torch.int32, device=x.device)
    lib = _native.typed("quant_wgrad", _WGRAD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.uvit_quant_wgrad(
            x.data_ptr(), g.data_ptr(), inv_x.data_ptr(), inv_g.data_ptr(), seed.data_ptr(),
            xq.data_ptr(), gq.data_ptr(), acc.data_ptr(), m, m_pad, k, n, _DTYPES[x.dtype],
            *win, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _native.raise_on(lib, err, "int8 wgrad")
    wgrad.launches += 1
    return acc.t()


def wgrad(x: torch.Tensor, g: torch.Tensor, seed: torch.Tensor, window: RowWindow = None,
          group: Optional[seq.SeqGroup] = None) -> torch.Tensor:
    """K7: dw[K, N] = xᵀ · g, f32, with x [M, K] and g [M, N] quantized per
    column (x to nearest, g stochastically from ``seed``). On a CUDA tensor
    the result is a transposed view of an [N, K] buffer. Under a seq shard
    (``window`` and its ``group``) the column scales are the whole trunk's
    and the result is this rank's share of one process's sums."""
    if x.device.type == "cpu":
        philox.check_seed(seed, x.device)
        return wgrad_plain(x, g, seed, window, group)
    sx, sg = wgrad_scales(x, g, group)
    acc = wgrad_acc(x, g, sx.reciprocal(), sg.reciprocal(), seed, window)
    return _dequant_wgrad(acc, sx, sg)


# Kernel launches since the last reset (a run sets them to 0 to count its
# own); one per call of K7's pair of kernels.
qmm.launches = 0
wgrad.launches = 0


class _Int8Dense(torch.autograd.Function):
    """K6 forward, K6 (dgrad) and K7 (wgrad) backward: the ``jax.custom_vjp``
    of :359-421. Saves x and w, not their int8 copies."""

    @staticmethod
    def forward(ctx, x, w, bias, seed, window, group):
        x2d = x.reshape(-1, x.shape[-1])
        wq, ws = quantize_cols(w.t())
        y = qmm(x2d, wq, ws, bias, seed, False, x.dtype)
        ctx.save_for_backward(x2d, w, seed)
        ctx.shape, ctx.has_bias = x.shape, bias is not None
        ctx.window, ctx.group = window, group
        return y.reshape(x.shape[:-1] + (w.shape[0],))

    @staticmethod
    def backward(ctx, g):
        x2d, w, seed = ctx.saved_tensors
        g2d = g.reshape(-1, w.shape[0])
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # dx = g · w: the second int8 copy of w, scales per input feature
            # (constant along the new contraction), stochastic rounding on g
            wtq, wts = quantize_cols(w)
            dx = qmm(g2d, wtq, wts, None, seed, True, g.dtype, ctx.window).reshape(ctx.shape)
        if ctx.needs_input_grad[1]:
            # other bits than dgrad's: seed + 1, added on the device
            dw = wgrad(x2d, g2d, seed + 1, ctx.window, ctx.group).t().to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g2d.sum(dim=0, dtype=torch.float32)  # summed in f32, no f32 copy of g
        return dx, dw, db, None, None, None


def int8_dense(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
               seed: torch.Tensor, shard: Optional[seq.SeqShard] = None, *, image0: int = 0,
               group: Optional[seq.SeqGroup] = None) -> torch.Tensor:
    """y = x · wᵀ (+ bias) with the forward, dgrad and wgrad matmuls in int8.

    x: [..., K] bf16 or f32; w: [N, K] f32 master weights in torch's
    [out, in] layout (the reference's ``w`` is its transpose, [K, N], so the
    reference's per-column weight scale is per row of ``w`` here); bias: [N]
    or None, added in f32 in the kernel's epilogue; seed: a one-element int64
    tensor on x's device for the gradients' stochastic rounding (dgrad uses
    it, wgrad seed + 1). y has x's dtype. Gradients flow to x, w (in w's
    dtype) and bias (the f32 sum of the upstream gradient); seed gets none.
    Under a seq ``shard`` x is [B, rows, K], this rank's rows of the shard's
    n tokens; on a data axis x [B, rows, K] holds images image0 .. image0 +
    B − 1 of the global batch (``image0``), and ``group`` (by default the
    shard's) is every rank that holds rows of the global trunk (data × seq):
    the gradients' rounding draws the unsharded rows' bits and wgrad's
    column scales span ``group``, so that the ranks' summed weight gradients
    are one process's (see the module doc). Refused inside
    ``flash_attention.plain_only()`` (no double backward)."""
    _refuse_in_plain_only("int8_dense")
    if shard is not None and (x.dim() != 3 or not 0 < x.shape[1] == shard.stop - shard.start):
        raise ValueError(f"under a seq shard of rows [{shard.start}, {shard.stop}) x must be "
                         f"[B, {shard.stop - shard.start}, K], got {tuple(x.shape)}")
    window = None
    if shard is not None:  # x [B, rows, K]: rows [start, stop) of n tokens
        window = (x.shape[1], shard.start, shard.n, image0)
        group = shard.group if group is None else group
    elif image0 or group is not None:  # x [B, n, K]: whole images of the global batch
        if x.dim() != 3:
            raise ValueError(f"on a data axis x must be [B, N, K], got {tuple(x.shape)}")
        window = (x.shape[1], 0, x.shape[1], image0)
    return _Int8Dense.apply(x, w, bias, seed, window, group)
