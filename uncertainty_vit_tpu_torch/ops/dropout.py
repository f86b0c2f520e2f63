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
and a run is reproducible from its generator seed. The reference's 128-lane
gate and row-block budget (:54-75) are artifacts of the TPU compiler and
have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from uncertainty_vit_tpu_torch.ops import _native, philox

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# One thread per 16 bytes in a grid of at most 2³¹ − 1 blocks of 256 threads
# bounds the kernel near 2⁴¹ elements; the wrapper states a round limit
# below it.
MAX_NUMEL = 2**40

_P = ctypes.c_void_p
# x, y, numel, seed, dtype, threshold, inv_keep, stream
_ARGTYPES = [_P, _P, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_uint, ctypes.c_float, _P]


def fused_dropout_plain(x: torch.Tensor, rate: float, seed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same mask, the product in
    f32, one rounding to x.dtype."""
    bits = philox.dropout_bits(seed, x.numel()).reshape(x.shape)
    return (x.float() * philox.keep_scale(bits, rate)).to(x.dtype)


def supported(x: torch.Tensor) -> bool:
    """What the Hopper kernel takes: a contiguous, non-empty bfloat16 or
    float32 CUDA tensor of any shape with fewer than 2⁴⁰ elements."""
    return (x.is_cuda and x.dtype in _DTYPES and x.is_contiguous()
            and 0 < x.numel() < MAX_NUMEL)


def fused_dropout(x: torch.Tensor, rate: float, seed: torch.Tensor) -> torch.Tensor:
    """Inverted dropout: keep probability 1 − rate, kept values scaled by
    1/(1 − rate). ``seed`` is a one-element int64 tensor on x's device
    (``philox.draw_seed``); rate 0 returns x itself."""
    if rate <= 0.0:
        return x
    if not rate < 1.0:
        raise ValueError(f"the dropout rate must be below 1, got {rate}")
    philox.check_seed(seed, x.device)
    if x.device.type == "cpu":
        return fused_dropout_plain(x, rate, seed)
    if not supported(x):
        raise ValueError(
            "the dropout kernel takes a contiguous, non-empty bfloat16 or float32 CUDA tensor "
            f"with fewer than 2^40 elements; got {x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}")
    y = torch.empty_like(x)
    lib = _native.typed("dropout", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.uvit_dropout(
            x.data_ptr(), y.data_ptr(), x.numel(), seed.data_ptr(), _DTYPES[x.dtype],
            philox.threshold(rate), 1.0 / (1.0 - rate),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _native.raise_on(lib, err, "dropout")
    fused_dropout.launches += 1
    return y


# Kernel launches since the last reset (a run sets it to 0 to count its own).
fused_dropout.launches = 0
