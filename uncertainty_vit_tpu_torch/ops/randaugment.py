"""RandAugment on the device (timm 'rand-m9-mstd0.5-inc1').

Counterpart of uncertainty_vit_tpu/ops/randaugment.py, over planar
[B, C, H, W] images in [0, 1]:

- per sample and round (two rounds), one of 15 ops with timm's
  increasing-severity parameter maps; magnitude ~ N(9, 0.5) clipped to
  [0, 10]; each applies with probability 0.5 (``_one_round`` :302);
- the eight pointwise ops are evaluated on the 256 uint8 levels and applied
  as one per-(sample, channel) lookup a round (``apply_lut`` :53,
  ``equalize_lut`` :74): the JAX package's table holds bf16 values, and so
  does this one. The JAX package reads its table through a two-level
  one-hot product in which exactly one product is nonzero; a gather reads
  the same value;
- colour and sharpness are evaluated on the whole image, and the geometric
  ops (rotate, shear, translate) return an affine matrix; the matrices of
  all rounds compose into one per sample, applied once after the rounds by
  the three-shear warp (``shear_warp`` :240, ``_shift_pass`` :209) whose
  per-line shifts are gathers here (the JAX package composes binary rolls;
  the same source pixels, the same blend);
- ``rand_augment_batch`` (:386) casts the images to bf16 before the first
  round, as the JAX package does. Its first round's colour and sharpness
  blends are f32, so the rounds after it run in f32, as there.

The draws are split from the ops: ``draw_rand_augment`` takes each round's op
index, normal, and sign and apply uniforms from a ``torch.Generator``, and
``_one_round`` / ``rand_augment_batch`` apply given draws. The divergences the
JAX package documents stay (PARITY.md): equalize from a strided histogram;
posterize keeps max(4 − ⌊4m/10⌋, 1) bits; the stats-dependent ops see the
unwarped image; sequential shears fill the border slightly unlike one warp.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.ops.augment import _gray_planar as _gray
from uncertainty_vit_tpu_torch.ops.augment import _on_device

NUM_OPS = 15
(AUTOCONTRAST, EQUALIZE, INVERT, ROTATE, POSTERIZE, SOLARIZE, SOLARIZE_ADD,
 COLOR, CONTRAST, BRIGHTNESS, SHARPNESS, SHEAR_X, SHEAR_Y, TRANSLATE_X,
 TRANSLATE_Y) = range(NUM_OPS)
_GEOMETRIC = (ROTATE, SHEAR_X, SHEAR_Y, TRANSLATE_X, TRANSLATE_Y)
# pointwise ops evaluated as a 256-entry table, in the JAX package's order
_LUT_OPS = (AUTOCONTRAST, EQUALIZE, INVERT, POSTERIZE, SOLARIZE, SOLARIZE_ADD, CONTRAST,
            BRIGHTNESS)
_SMOOTH = ((1.0, 1.0, 1.0), (1.0, 5.0, 1.0), (1.0, 1.0, 1.0))  # PIL's SMOOTH, × 13


def _bc(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def _levels(device) -> torch.Tensor:
    """The 256 levels k/255 in f32, as jnp.linspace(0, 1, 256) gives them."""
    return torch.arange(256, dtype=torch.float32, device=device) * np.float32(1.0 / 255.0)


# ---------------------------------------------------------------------------
# Pixel ops (planar [B, C, H, W], values in [0, 1])
# ---------------------------------------------------------------------------

def autocontrast(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=(2, 3), keepdim=True)
    hi = x.amax(dim=(2, 3), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.ones_like(hi))
    return torch.clamp((x - lo) * scale, 0.0, 1.0)


def _quantize(x: torch.Tensor) -> torch.Tensor:
    """x ∈ [0, 1] → its uint8 level as int64."""
    return torch.clamp(torch.round(x.to(torch.float32) * 255.0), 0, 255).to(torch.int64)


def apply_lut(x: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """A per-(sample, channel) 256-entry table [B, C, 256] applied to the
    uint8 level of each pixel of [B, C, H, W]; the table's values in bf16,
    the result in x's dtype."""
    b, c, h, w = x.shape
    q = _quantize(x).reshape(b, c, h * w)
    out = torch.gather(lut.to(torch.bfloat16), 2, q)
    return out.reshape(b, c, h, w).to(x.dtype)


def equalize_lut(x: torch.Tensor, hist_stride: int = 4) -> torch.Tensor:
    """Per-(sample, channel) equalization table [B, C, 256] (the cdf of the
    levels of a strided subsample, over its last entry)."""
    b, c = x.shape[0], x.shape[1]
    q = _quantize(x[:, :, ::hist_stride, ::hist_stride]).reshape(b, c, -1)
    hist = torch.zeros(b, c, 256, dtype=torch.float32, device=x.device)
    hist.scatter_add_(2, q, torch.ones(q.shape, dtype=torch.float32, device=x.device))
    cdf = torch.cumsum(hist, dim=-1)
    return cdf / cdf[..., -1:]


def equalize(x: torch.Tensor, hist_stride: int = 4) -> torch.Tensor:
    return apply_lut(x, equalize_lut(x, hist_stride))


def invert(x: torch.Tensor) -> torch.Tensor:
    return 1.0 - x


def posterize(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Keep ``bits`` ([B] ints) bits of each channel."""
    levels = _bc(2.0 ** bits.to(torch.float32))
    return torch.floor(x * 255.0 / (256.0 / levels)) * (256.0 / levels) / 255.0


def solarize(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= _bc(thresh), 1.0 - x, x)


def solarize_add(x: torch.Tensor, add: torch.Tensor, thresh: float = 128.0 / 255.0
                 ) -> torch.Tensor:
    return torch.where(x < thresh, torch.clamp(x + _bc(add), 0.0, 1.0), x)


def color(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    f = _bc(f)
    return torch.clamp(x * f + _gray(x) * (1.0 - f), 0.0, 1.0)


def contrast(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    f = _bc(f)
    mean = _gray(x).mean(dim=(2, 3), keepdim=True)
    return torch.clamp(x * f + mean * (1.0 - f), 0.0, 1.0)


def brightness(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x * _bc(f), 0.0, 1.0)


def sharpness(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Blend with PIL's SMOOTH kernel [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13
    (zero padding, in f32)."""
    c = x.shape[1]
    kernel = _on_device(_SMOOTH, x.device) / 13.0
    smooth = F.conv2d(x.to(torch.float32), kernel.expand(c, 1, 3, 3), padding=1, groups=c)
    f = _bc(f)
    return torch.clamp(x * f + smooth * (1.0 - f), 0.0, 1.0)


# ---------------------------------------------------------------------------
# Warps
# ---------------------------------------------------------------------------

def _source_coords(mats: torch.Tensor, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each output pixel's input (y, x) under mats [B, 2, 3] (output
    coordinates around the centre → input coordinates): [B, H·W] each."""
    dev = mats.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w) - (h - 1) / 2.0
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w) - (w - 1) / 2.0
    coords = torch.stack([yy, xx, torch.ones_like(yy)]).reshape(3, -1)
    src = torch.einsum("bij,jp->bip", mats, coords)
    return src[:, 0] + (h - 1) / 2.0, src[:, 1] + (w - 1) / 2.0


def _tap(flat: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor, h: int, w: int):
    """(the pixels at (yi, xi), clamped into the image; where they lie in it)."""
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    idx = (torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)).to(torch.int64)
    return flat.gather(2, idx[:, None, :].expand(-1, flat.shape[1], -1)), valid


def affine_warp(x: torch.Tensor, mats: torch.Tensor, method: str = "nearest") -> torch.Tensor:
    """Affine warp with zero fill; mats [B, 2, 3] map output (y, x, 1) around
    the centre to input coordinates. 'nearest' (the JAX package's default)
    or 'bilinear'."""
    b, c, h, w = x.shape
    sy, sx = _source_coords(mats, h, w)
    flat = x.reshape(b, c, h * w)
    if method == "nearest":
        tap, valid = _tap(flat, torch.round(sy), torch.round(sx), h, w)
        return (tap * valid[:, None, :].to(x.dtype)).reshape(b, c, h, w)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    out = torch.zeros((b, c, h * w), dtype=x.dtype, device=x.device)
    for dy in (0, 1):
        for dx in (0, 1):
            tap, valid = _tap(flat, y0 + dy, x0 + dx, h, w)
            wgt = ((wy if dy else 1 - wy) * (wx if dx else 1 - wx) * valid)[:, None, :]
            out = out + tap * wgt.to(x.dtype)
    return out.reshape(b, c, h, w)


def _shift_pass(x: torch.Tensor, delta: torch.Tensor, axis: int) -> torch.Tensor:
    """out[..., i, ...] = x[..., i + delta, ...] along ``axis`` (2 or 3),
    bilinear, zero fill; delta [B, L]: one shift per sample and line across
    the axis (lines indexed by y for axis 3, by x for axis 2)."""
    n = x.shape[axis]
    k = torch.floor(delta)
    frac = (delta - k).to(x.dtype)
    pos = torch.arange(n, device=x.device)
    ki = k.to(torch.int64)
    if axis == 3:
        line = lambda t: t[:, None, :, None]  # noqa: E731
        src_i = pos[None, None, :] + ki[:, :, None]  # [B, H, W]
        src = pos.to(torch.float32)[None, None, :] + delta[:, :, None]
    else:
        line = lambda t: t[:, None, None, :]  # noqa: E731
        src_i = pos[None, :, None] + ki[:, None, :]
        src = pos.to(torch.float32)[None, :, None] + delta[:, None, :]
    shape = x.shape
    out = x.gather(axis, torch.remainder(src_i, n)[:, None].expand(shape))
    tap1 = x.gather(axis, torch.remainder(src_i + 1, n)[:, None].expand(shape))
    f = line(frac)
    res = out * (1 - f) + tap1 * f
    valid = ((src >= 0) & (src <= n - 1))[:, None, :, :]
    return res * valid.to(x.dtype)


def shear_warp(x: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """The bilinear warp of unimodular mats [B, 2, 3] (output (y, x, 1)
    around the centre → input (y, x)) as three axis-aligned shear passes
    (Paeth): M = Shx(αL) · Shy(β, tC) · Shx(αR, tR)."""
    _, _, h, w = x.shape
    m00, m01, m02 = mats[:, 0, 0], mats[:, 0, 1], mats[:, 0, 2]
    m10, m11, m12 = mats[:, 1, 0], mats[:, 1, 1], mats[:, 1, 2]
    tiny = m01.abs() < 1e-6
    safe = torch.where(tiny, torch.ones_like(m01), m01)
    beta = m01
    a_l = torch.where(tiny, m10, (m11 - 1.0) / safe)
    a_r = torch.where(tiny, torch.zeros_like(m00), (m00 - 1.0) / safe)
    t_r = m12 - a_l * m02
    t_c = m02 - beta * t_r
    yy = torch.arange(h, dtype=torch.float32, device=x.device) - (h - 1) / 2.0
    xx = torch.arange(w, dtype=torch.float32, device=x.device) - (w - 1) / 2.0
    x1 = _shift_pass(x, a_l[:, None] * yy[None, :], axis=3)
    x2 = _shift_pass(x1, beta[:, None] * xx[None, :] + t_c[:, None], axis=2)
    return _shift_pass(x2, a_r[:, None] * yy[None, :] + t_r[:, None], axis=3)


def _affine_for_op(op_idx: torch.Tensor, magnitude: torch.Tensor, sign: torch.Tensor,
                   h: int, w: int) -> torch.Tensor:
    """Per-sample output → input matrix [B, 2, 3] of the drawn geometric op;
    the identity for the other ops."""
    m = magnitude * sign
    rot = torch.deg2rad(m / 10.0 * 30.0)
    shear = m / 10.0 * 0.3
    tx = m / 10.0 * 0.45 * w
    ty = m / 10.0 * 0.45 * h
    cos, sin = torch.cos(rot), torch.sin(rot)
    zeros, ones = torch.zeros_like(m), torch.ones_like(m)

    def mat(a, b_, c_, d, e, f):
        return torch.stack([torch.stack([a, b_, c_], -1), torch.stack([d, e, f], -1)], dim=-2)

    mats = mat(ones, zeros, zeros, zeros, ones, zeros)
    for op, target in ((ROTATE, mat(cos, -sin, zeros, sin, cos, zeros)),
                       (SHEAR_X, mat(ones, zeros, zeros, shear, ones, zeros)),
                       (SHEAR_Y, mat(ones, shear, zeros, zeros, ones, zeros)),
                       (TRANSLATE_X, mat(ones, zeros, zeros, zeros, ones, tx)),
                       (TRANSLATE_Y, mat(ones, zeros, ty, zeros, ones, zeros))):
        mats = torch.where((op_idx == op)[:, None, None], target, mats)
    return mats


# ---------------------------------------------------------------------------
# Draws and rounds
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RoundDraws:
    """One round's draws per sample [B]: the op index, the magnitude's
    normal, and the raw uniforms of the sign and of the apply gate."""

    op: torch.Tensor
    z: torch.Tensor
    sign_u: torch.Tensor
    apply_u: torch.Tensor


def draw_round(generator: torch.Generator, b: int) -> RoundDraws:
    dev = generator.device
    return RoundDraws(torch.randint(0, NUM_OPS, (b,), generator=generator, device=dev),
                      torch.randn(b, generator=generator, device=dev),
                      torch.rand(b, generator=generator, device=dev),
                      torch.rand(b, generator=generator, device=dev))


def draw_rand_augment(generator: torch.Generator, b: int, num_layers: int = 2
                      ) -> List[RoundDraws]:
    return [draw_round(generator, b) for _ in range(num_layers)]


def _round_luts(x: torch.Tensor, op: torch.Tensor, frac: torch.Tensor,
                enhance_f: torch.Tensor) -> torch.Tensor:
    """[B, C, 256] f32: each sample's table of its drawn pointwise op, the
    identity for the other ops."""
    b, c = x.shape[0], x.shape[1]
    v = _levels(x.device)[None, None, :]
    flat = x.reshape(b, c, -1).to(torch.float32)
    lo = flat.amin(-1)[..., None]
    hi = flat.amax(-1)[..., None]
    ac_scale = torch.where(hi > lo, 1.0 / (hi - lo), torch.ones_like(hi))
    gray_mean = _gray(x).to(torch.float32).mean(dim=(2, 3))  # [B, 1]
    f1 = enhance_f[:, None, None].to(torch.float32)
    bits = torch.clamp_min(4 - torch.floor(frac * 4), 1.0)[:, None, None]
    keep = 256.0 / 2.0 ** bits
    fr = frac[:, None, None]
    luts = {
        AUTOCONTRAST: lambda: torch.clamp((v - lo) * ac_scale, 0.0, 1.0),
        EQUALIZE: lambda: equalize_lut(x),
        INVERT: lambda: 1.0 - v,
        POSTERIZE: lambda: torch.floor(v * 255.0 / keep) * keep / 255.0,
        SOLARIZE: lambda: torch.where(v >= 1.0 - fr, 1.0 - v, v),
        SOLARIZE_ADD: lambda: torch.where(v < 128.0 / 255.0,
                                          torch.clamp(v + fr * 110.0 / 255.0, 0.0, 1.0), v),
        CONTRAST: lambda: torch.clamp(v * f1 + gray_mean[:, :, None] * (1.0 - f1), 0.0, 1.0),
        BRIGHTNESS: lambda: torch.clamp(v * f1, 0.0, 1.0),
    }
    lut = v.expand(b, c, 256)
    for i in _LUT_OPS:
        lut = torch.where((op == i)[:, None, None], luts[i]().expand(b, c, 256), lut)
    return lut


def _one_round(draws: RoundDraws, x: torch.Tensor, magnitude_mean: float,
               magnitude_std: float, prob: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One RandAugment round over x: (the pixel ops' result, [B, 2, 3] the
    round's geometric matrices). The pointwise ops go through one table
    lookup; colour and sharpness are computed on the whole image and
    selected; a geometric op leaves the pixels as they are and returns its
    matrix; a sample whose gate is off keeps x and the identity. The result
    is f32 (the colour and sharpness blends are), as in the JAX package."""
    _, _, h, w = x.shape
    op = draws.op
    mag = torch.clamp(magnitude_mean + magnitude_std * draws.z, 0.0, 10.0)
    sign = torch.where(draws.sign_u < np.float32(0.5), 1.0, -1.0)
    apply = draws.apply_u < np.float32(prob)
    frac = mag / 10.0
    enhance_f = 1.0 + sign * 0.9 * frac  # timm's increasing enhance factor

    out = apply_lut(x, _round_luts(x, op, frac, enhance_f))
    out = torch.where(_bc(op == COLOR), color(x, enhance_f), out)
    out = torch.where(_bc(op == SHARPNESS), sharpness(x, enhance_f), out)
    is_geo = op == _GEOMETRIC[0]
    for g in _GEOMETRIC[1:]:
        is_geo = is_geo | (op == g)
    out = torch.where(_bc(is_geo), x.to(out.dtype), out)
    out = torch.where(_bc(apply), out, x.to(out.dtype))

    mats = _affine_for_op(op, mag, sign, h, w)
    identity = _on_device(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0)), x.device)
    mats = torch.where((is_geo & apply)[:, None, None], mats, identity.expand_as(mats))
    return out, mats


def rand_augment_batch(draws: List[RoundDraws], imgs: torch.Tensor, magnitude: float = 9.0,
                       magnitude_std: float = 0.5, prob: float = 0.5) -> torch.Tensor:
    """timm rand-m{magnitude}-mstd{magnitude_std} over planar [B, C, H, W],
    one round per entry of ``draws``: bf16 into the first round, the rounds'
    matrices composed and applied as one warp after the last."""
    orig_dtype = imgs.dtype
    x = imgs.to(torch.bfloat16)
    b = x.shape[0]
    hom_row = _on_device(((0.0, 0.0, 1.0),), x.device).expand(b, 1, 3)
    total = torch.eye(3, device=x.device).expand(b, 3, 3)
    for rd in draws:
        x, mats = _one_round(rd, x, magnitude, magnitude_std, prob)
        # warp_{A2}(warp_{A1}(x)) = warp_{A1·A2}(x) for output → input maps
        total = torch.einsum("bij,bjk->bik", total, torch.cat([mats, hom_row], dim=1))
    return shear_warp(x, total[:, :2, :]).to(orig_dtype)

