"""Fused multi-head attention forward over packed qkv (kernel K1).

Counterpart of ``fused_qkv_attention`` in uncertainty_vit_tpu/ops/
flash_attention.py (:1369-1393, kernel ``_fwd_kernel`` :188-241). Inputs are
the fused qkv activations [B, N, 3C] straight out of the qkv matmul (q|k|v
concatenated, heads interleaved as C = H·D); the per-head slabs are cut
inside the kernel, so no [B, H, N, D] copies and no [B, H, N, N] scores
reach device memory.

- On a CPU tensor the call runs ``fused_qkv_attention_plain``, the same
  math in plain PyTorch.
- On a CUDA tensor it launches the Hopper kernel of
  ``csrc/flash_attention_fwd.cu`` and adds one to
  ``fused_qkv_attention.launches``, or raises. There is no fallback.

Only the forward exists (the evaluation path); the backward and the
in-kernel attention dropout come with the training slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from uncertainty_vit_tpu_torch.ops import _native

# Skip the softmax max pass: exp(s)/Σexp(s) equals the max-subtracted
# softmax whenever exp(s) does not overflow f32 (|s| ≲ 88). Safe for trained
# ViTs at these shapes, not for arbitrary inputs; the finetune driver turns
# it on for training and evaluation (cli/common.py:34-44 of the reference
# package). Read at call time when ``bounded_scores`` is not given.
BOUNDED_SCORES = False
# The kernel's only head width (ViT-B and ViT-L).
KERNEL_HEAD_DIM = 64

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def fused_qkv_attention_plain(
    qkv: torch.Tensor,
    bias: Optional[torch.Tensor],
    qv_bias: Optional[torch.Tensor],
    scale: float,
    num_heads: int,
    *,
    bounded_scores: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: returns (out [B, N, C] in
    qkv.dtype, lse [B, H, N] f32).

    Mirrors ``_fwd_kernel``: q/v bias added in the input dtype; scores,
    softmax and the row sums in f32 from the (exactly upcast) inputs; the
    unnormalized probabilities rounded to the input dtype before the
    product with v; the output scaled by 1/Σe."""
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
    out = torch.matmul(e.to(dt).float(), v) * r
    return out.transpose(1, 2).reshape(b, n, c).to(dt), lse[..., 0]


def _lib() -> ctypes.CDLL:
    lib = _native.load("flash_attention_fwd")
    fn = lib.uvit_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        lib.uvit_cuda_error_string.argtypes = [ctypes.c_int]
        lib.uvit_cuda_error_string.restype = ctypes.c_char_p
    return lib


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


def _launch(qkv, bias, qv_bias, scale, num_heads, bounded_scores, want_lse):
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
    _check_aux("bias", bias, (num_heads, n, n), qkv.device)
    _check_aux("qv_bias", qv_bias, (3, c), qkv.device)

    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device) \
        if want_lse else None
    lib = _lib()
    with torch.cuda.device(qkv.device):
        err = lib.uvit_flash_attention_fwd(
            qkv.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            qv_bias.data_ptr() if qv_bias is not None else None,
            out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, n, num_heads, _DTYPES[qkv.dtype], float(scale), int(bounded_scores),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"attention kernel launch failed: {lib.uvit_cuda_error_string(err).decode()} ({err})"
        )
    fused_qkv_attention.launches += 1
    return out, lse


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
    rule) added to the q/v slabs in the input dtype, or None; seed: unused
    until in-kernel dropout exists. Returns out [B, N, C] in qkv.dtype, and
    with ``want_lse`` also the row log-sum-exp [B, H, N] f32.
    ``bounded_scores`` defaults to the module's BOUNDED_SCORES."""
    del seed
    if dropout_rate > 0.0:
        raise NotImplementedError("in-kernel attention dropout is not ported yet")
    bounded = BOUNDED_SCORES if bounded_scores is None else bool(bounded_scores)
    if qkv.device.type == "cpu":
        out, lse = fused_qkv_attention_plain(
            qkv, bias, qv_bias, scale, num_heads, bounded_scores=bounded
        )
    else:
        out, lse = _launch(qkv, bias, qv_bias, scale, num_heads, bounded, want_lse)
    return (out, lse) if want_lse else out


# Kernel launches since the last reset (a run sets it to 0 to count its own).
fused_qkv_attention.launches = 0
