"""Fused inverted dropout with in-kernel random bits (K8).

Counterpart of ``fused_dropout`` in uncertainty_vit_tpu/ops/dropout.py
(:78-104, kernel body :43-51): the dropout of the MC-dropout evaluation at
the attention-projection and MLP-fc2 sites. The mask bits are drawn inside
the kernel, so the call costs one read and one write of x and no mask tensor
reaches device memory. Forward only, as in the reference (:18-20): training
keeps the framework's own dropout.

- On a CPU tensor the call runs ``fused_dropout_plain``.
- On a CUDA tensor it launches the Hopper kernel of ``csrc/dropout.cu`` and
  adds one to ``fused_dropout.launches``, or raises on what the kernel does
  not take (``supported``). There is no fallback.

Kernel and plain version draw the same mask: a pure function of the seed and
of each element's flat index (``ops/philox.py``), so they agree to the bit,
and a run is reproducible from its generator seed. Under sequence
parallelism a rank holds rows [start, start + rows) of a sequence of n
tokens: with ``window=(start, n)`` element (g, r, c) of x [G, rows, C]
takes the bits of the unsharded index (g·n + start + r)·C + c, so the
rank's mask is the unsharded run's over its rows. Under data parallelism
a rank holds rows [off, off + b) of each fold of B rows of the unsharded
batch (the folded MC-dropout batch tiles the global batch K times): with
``fold=(b, B, off)`` group g of x stands for the unsharded group
(g // b)·B + off + g % b, before the window's map (without a window each
group is one row of x [G, ...]). The reference's 128-lane
gate and row-block budget (:54-75) are artifacts of the TPU compiler and
have no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from uncertainty_vit_tpu_torch.ops import _native, philox

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# One thread per 16 bytes in a grid of at most 2³¹ − 1 blocks of 256 threads
# bounds the kernel near 2⁴¹ elements; the wrapper states a round limit
# below it.
MAX_NUMEL = 2**40

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
# x, y, groups, slab, stride, base, fold_b, fold_B, fold_off, seed, dtype,
# threshold, inv_keep, stream
_ARGTYPES = [_P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _P, ctypes.c_int, ctypes.c_uint,
             ctypes.c_float, _P]

Window = Optional[Tuple[int, int]]


def _window_shape(x: torch.Tensor, window: Window) -> Tuple[int, int, int]:
    """(G, rows, C) of x [G, rows, ...] under ``window`` = (start, n): C is the
    product of the trailing dimensions. Raises unless rows [start, start +
    rows) lie in [0, n)."""
    start, n = window
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"a dropout window takes a non-empty [G, rows, ...] tensor; got "
                         f"{tuple(x.shape)}")
    g, rows = x.shape[0], x.shape[1]
    if not 0 <= start <= n - rows:
        raise ValueError(f"rows [{start}, {start + rows}) do not lie in a sequence of {n}")
    return g, rows, x.numel() // (g * rows)


def fused_dropout_plain(x: torch.Tensor, rate: float, seed: torch.Tensor,
                        window: Window = None, fold: philox.Fold = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same mask, the product in
    f32, one rounding to x.dtype. Under ``window`` it draws the unsharded
    [G, n, C] bits and keeps the window's rows; under the batch ``fold``
    the unsharded groups' bits (``philox.fold_images``)."""
    if window is None and fold is None:
        bits = philox.dropout_bits(seed, x.numel()).reshape(x.shape)
    else:
        g, r, c = _window_shape(x, window or (0, x.shape[1]))
        start, n = window or (0, r)
        index = philox.fold_images(g, fold).to(x.device)
        total = int(index.max()) + 1
        bits = philox.dropout_bits(seed, total * n * c).reshape(total, n, c)
        bits = bits[index, start:start + r].reshape(x.shape)
    return (x.float() * philox.keep_scale(bits, rate)).to(x.dtype)


def supported(x: torch.Tensor, window: Window = None, fold: philox.Fold = None) -> bool:
    """What the Hopper kernel takes: a contiguous, non-empty bfloat16 or
    float32 CUDA tensor of any shape with fewer than 2⁴⁰ elements; under a
    ``window`` or a ``fold`` one of at least two dimensions whose
    unsharded G · n · C is below 2⁴⁰."""
    if not (x.is_cuda and x.dtype in _DTYPES and x.is_contiguous()
            and 0 < x.numel() < MAX_NUMEL):
        return False
    if window is None and fold is None:
        return True
    g, r, c = _window_shape(x, window or (0, x.shape[1]))
    b, total, _ = philox.check_fold(g, fold)
    return g // b * total * (window or (0, r))[1] * c < MAX_NUMEL


def fused_dropout(x: torch.Tensor, rate: float, seed: torch.Tensor,
                  window: Window = None, fold: philox.Fold = None) -> torch.Tensor:
    """Inverted dropout: keep probability 1 − rate, kept values scaled by
    1/(1 − rate). ``seed`` is a one-element int64 tensor on x's device
    (``philox.draw_seed``); rate 0 returns x itself. ``window`` = (start, n):
    x [G, rows, ...] holds rows [start, start + rows) of n, and draws the
    unsharded mask's rows; ``fold`` = (b, B, off): x's groups are a data
    rank's rows of a batch folded by B (see the module doc)."""
    if rate <= 0.0:
        return x
    if not rate < 1.0:
        raise ValueError(f"the dropout rate must be below 1, got {rate}")
    philox.check_seed(seed, x.device)
    if x.device.type == "cpu":
        return fused_dropout_plain(x, rate, seed, window, fold)
    if not supported(x, window, fold):
        raise ValueError(
            "the dropout kernel takes a contiguous, non-empty bfloat16 or float32 CUDA tensor "
            "with fewer than 2^40 elements (under a window, unsharded); got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}")
    # x as [groups, slab]: element (g, j) draws flat index G·stride + base + j,
    # G the unsharded group of g under the fold
    groups, slab, stride, base = 1, x.numel(), 0, 0
    if window is not None or fold is not None:
        groups, r, c = _window_shape(x, window or (0, x.shape[1]))
        start, n = window or (0, r)
        slab, stride, base = r * c, n * c, start * c
    fold = philox.check_fold(groups, fold)
    y = torch.empty_like(x)
    lib = _native.typed("dropout", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.uvit_dropout(
            x.data_ptr(), y.data_ptr(), groups, slab, stride, base, *fold, seed.data_ptr(),
            _DTYPES[x.dtype], philox.threshold(rate), 1.0 / (1.0 - rate),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _native.raise_on(lib, err, "dropout")
    fused_dropout.launches += 1
    return y


# Kernel launches since the last reset (a run sets it to 0 to count its own).
fused_dropout.launches = 0
