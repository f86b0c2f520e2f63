"""The kernels' random bits in plain PyTorch, exact to the bit.

``csrc/philox.cuh`` makes a dropout mask a pure function of (seed, position):
Philox4x32-10 keyed on the 64-bit seed, with the position as the counter.
This module is the same function on integer tensors (CPU or CUDA), so that
each kernel's plain version draws the very mask its kernel draws, and the
attention backward replays the forward's mask whatever tiles either uses.

- dropout (``ops/dropout.py``): counter (i >> 2 low, i >> 2 high, 0,
  STREAM_DROPOUT), word i & 3, for the flat element index i;
- attention (``ops/flash_attention.py``): counter (col >> 1, row >> 1,
  image · H + head, STREAM_ATTENTION), word 2 · (row & 1) + (col & 1);
- stochastic rounding (``ops/quant.py``): entry (row, col) of an [M, N]
  matrix takes counter (col >> 2, row, 0, STREAM_QUANT), word col & 3, and
  its uniform is (bits >> 8) · 2⁻²⁴ in f32, in [0, 1): the top 24 bits, as
  ``_sr_uniform`` of uncertainty_vit_tpu/ops/quant.py:94-99 makes it.

``keep = bits >= min(int(rate · 2³²), 2³² − 1)`` and kept values are scaled
by 1/(1 − rate), the thresholding of the reference's TPU kernels
(uncertainty_vit_tpu/ops/flash_attention.py:156-162, ops/dropout.py:45-50).
The TPU draws its bits from the core's hardware generator, seeded per
program, so no bits here equal the reference's: against it only
distributions compare.

A seed is a one-element int64 tensor on the activations' device, drawn from
the forward's ``torch.Generator`` (``draw_seed``) and handed to the kernels
by pointer, so drawing it forces no host sync. Words are held as int64
tensors with values in [0, 2³²).
"""

from __future__ import annotations

from typing import Tuple

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
STREAM_DROPOUT, STREAM_ATTENTION, STREAM_QUANT = 0, 1, 2
_MASK32 = 0xFFFFFFFF


def threshold(rate: float) -> int:
    """The keep threshold on 32 random bits: an entry is kept when its bits
    are at least this."""
    return min(int(rate * (2**32)), 2**32 - 1)


def draw_seed(generator: torch.Generator, device) -> torch.Tensor:
    """A fresh seed from ``generator`` (which lies on ``device``): one int64
    in [0, 2⁶³ − 1) on the device."""
    return torch.randint(0, 2**63 - 1, (1,), generator=generator, device=device,
                         dtype=torch.int64)


def check_seed(seed: torch.Tensor, device: torch.device) -> None:
    if not isinstance(seed, torch.Tensor) or seed.dtype != torch.int64 or seed.numel() != 1 \
            or seed.device != device:
        raise ValueError(f"the dropout seed must be a one-element int64 tensor on {device}; "
                         f"got {seed!r}")


def _mulhilo(m: int, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m · c for a 32-bit constant m and 32-bit
    values c in int64. The 64-bit product overflows a signed int64, so c is
    split into 16-bit halves: m·c = (m·c_hi)·2¹⁶ + m·c_lo, each under 2⁴⁸."""
    a = m * (c >> 16)
    b = m * (c & 0xFFFF)
    hi = (a + (b >> 16)) >> 16
    lo = (b + ((a & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor, c3: torch.Tensor,
               k0: torch.Tensor, k1: torch.Tensor, rounds: int = 10
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Philox4x32 (Salmon et al., SC'11) on broadcastable int64 tensors of
    32-bit values: counter (c0..c3), key (k0, k1) → four output words."""
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + W0) & _MASK32
        k1 = (k1 + W1) & _MASK32
    return c0, c1, c2, c3


def _key(seed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    s = seed.reshape(())
    return s & _MASK32, (s >> 32) & _MASK32


def dropout_bits(seed: torch.Tensor, numel: int, offset: int = 0) -> torch.Tensor:
    """The bits of flat elements [offset, offset + numel) of a dropout call,
    as int64 [numel] on the seed's device."""
    first, last = offset >> 2, (offset + numel + 3) >> 2
    group = torch.arange(first, last, dtype=torch.int64, device=seed.device)
    zero = torch.zeros((), dtype=torch.int64, device=seed.device)
    words = philox4x32(group & _MASK32, group >> 32, zero, zero + STREAM_DROPOUT, *_key(seed))
    flat = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(-1)
    start = offset - 4 * first
    return flat[start:start + numel]


def attention_bits(seed: torch.Tensor, batch: int, num_heads: int, rows: int, cols: int,
                   *, image0: int = 0, row0: int = 0, col0: int = 0) -> torch.Tensor:
    """The bits of the attention mask entries (image0 + b, h, row0 + r,
    col0 + c) for b < batch, h < num_heads, r < rows, c < cols, as int64
    [batch, num_heads, rows, cols] on the seed's device. The head count
    enters the position (image · num_heads + head)."""
    dev = seed.device
    rb0, rb1 = row0 >> 1, (row0 + rows + 1) >> 1
    cb0, cb1 = col0 >> 1, (col0 + cols + 1) >> 1
    bh = torch.arange(image0 * num_heads, (image0 + batch) * num_heads, dtype=torch.int64,
                      device=dev)[:, None, None]
    rb = torch.arange(rb0, rb1, dtype=torch.int64, device=dev)[None, :, None]
    cb = torch.arange(cb0, cb1, dtype=torch.int64, device=dev)[None, None, :]
    stream = torch.full((), STREAM_ATTENTION, dtype=torch.int64, device=dev)
    words = philox4x32(cb, rb, bh, stream, *_key(seed))
    # [BH, RB, CB, 4] → word 2·(row & 1) + (col & 1) → [BH, 2·RB, 2·CB]
    bh_n, rb_n, cb_n = batch * num_heads, rb1 - rb0, cb1 - cb0
    blocks = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(bh_n, rb_n, cb_n, 2, 2)
    full = blocks.permute(0, 1, 3, 2, 4).reshape(bh_n, 2 * rb_n, 2 * cb_n)
    r, c = row0 - 2 * rb0, col0 - 2 * cb0
    return full[:, r:r + rows, c:c + cols].reshape(batch, num_heads, rows, cols)


def quant_bits(seed: torch.Tensor, rows: int, cols: int, *, row0: int = 0, col0: int = 0
               ) -> torch.Tensor:
    """The rounding bits of entries (row0 + r, col0 + c) of a matrix, r < rows,
    c < cols, as int64 [rows, cols] on the seed's device: a function of the
    seed and of (row, col) only, whatever tile or thread rounds the entry."""
    dev = seed.device
    g0, g1 = col0 >> 2, (col0 + cols + 3) >> 2
    row = torch.arange(row0, row0 + rows, dtype=torch.int64, device=dev)[:, None]
    group = torch.arange(g0, g1, dtype=torch.int64, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32(group, row, zero, zero + STREAM_QUANT, *_key(seed))
    full = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(rows, 4 * (g1 - g0))
    start = col0 - 4 * g0
    return full[:, start:start + cols]


def quant_uniform(seed: torch.Tensor, rows: int, cols: int, *, row0: int = 0, col0: int = 0
                  ) -> torch.Tensor:
    """The [0, 1) uniforms of stochastic rounding, f32 [rows, cols]: the top
    24 of each entry's ``quant_bits`` times 2⁻²⁴ (exact in f32)."""
    return (quant_bits(seed, rows, cols, row0=row0, col0=col0) >> 8).float() * (1.0 / (1 << 24))


def keep_scale(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """f32 tensor: 1/(1 − rate) where the entry is kept, else 0."""
    scale = torch.full((), 1.0 / (1.0 - rate), dtype=torch.float32, device=bits.device)
    return torch.where(bits >= threshold(rate), scale, torch.zeros_like(scale))
