"""Image augmentation on the device: the finetune and pretrain train
transforms and the eval transform.

Counterpart of uncertainty_vit_tpu/ops/augment.py. The train half, on planar
[B, C, H, W] f32 in [0, 1]: ``to_planar`` / ``from_planar`` /
``_gray_planar`` (:363-376), the random resized crop (``_rrc_params`` :135,
``_cubic_weights`` :190, ``_linear_weights`` :201,
``_batched_resample_planar`` :430, ``crop_and_resize_batch`` :468,
``random_resized_crop_batch`` :479), ``color_jitter_batch`` (:377),
``random_hflip_batch`` (:424), ``random_erasing_batch`` (:508, ``_erase_one``
:535), ``finetune_train_augment_batch`` (:675-727), the pretrain ladder
and BEiT's two-view ``pretrain_two_view_batch`` (:728-800, with
``map_pixels`` / ``unmap_pixels`` :35-47). Each random op is
split in two: ``draw_*`` takes its raw values (uniforms in [0, 1), normals,
integers) from an explicit ``torch.Generator`` on that generator's device,
and the op applies given draws, so that the tests can hand it the JAX
package's draws and the card's result can be held against the CPU's on the
same draws. Nothing reads a value back to the host: the colour jitter's
order, drawn per batch, selects its ops on the device.

The crop's resampler is the JAX package's, not ``F.interpolate``: the Keys
cubic with a = -0.5 (or the linear kernel), taps at floor(pos) - 1 ... + 2
clamped to the edge and not renormalized, the kernel never widened when
downsampling, pos = start + (i + 0.5)·size/out - 0.5, the output clipped to
[0, 1]; per-sample boxes as one [B, out, in] interpolation matrix per axis.

The eval half: the mean/std constants (:28-31), ``to_float`` / ``normalize``
(:49-57), ``eval_resize_center_crop`` (:329-346) and ``eval_transform_batch``
(:804-814). Its images are NHWC, so the channel constants broadcast over
the last axis.

The eval resize is ``jax.image.resize(..., "bicubic")``'s, which is not
``F.interpolate(mode="bicubic")``'s either: the Keys cubic with a = -0.5
(torch takes -0.75), widened by 1/scale when it downsamples (antialiasing),
taps that fall outside the input dropped and the rest renormalized to sum 1
(no border clamp), and an output whose sample position lies outside
[-0.5, in - 0.5] zeroed. ``_resize_weights`` builds that [out, in] matrix on
the host with numpy; the rows that the centre crop keeps go to the device
once per (in, out, crop, device), and the resize is one product per axis
there, in f32. An axis whose size does not change is left as it is, as
jax.image.resize skips it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# timm.data.constants
IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)


DALLE_LOGIT_LAPLACE_EPS = 0.1


def map_pixels(x: torch.Tensor) -> torch.Tensor:
    """The DALL-E tokenizer's input map (1 − 2ε)·x + ε (dall_e.map_pixels,
    which the reference applies to the tokenizer view, datasets.py:86-102)."""
    return (1.0 - 2.0 * DALLE_LOGIT_LAPLACE_EPS) * x + DALLE_LOGIT_LAPLACE_EPS


def unmap_pixels(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``map_pixels``, clipped to [0, 1]."""
    return torch.clamp((x - DALLE_LOGIT_LAPLACE_EPS) / (1.0 - 2.0 * DALLE_LOGIT_LAPLACE_EPS),
                       0.0, 1.0)


def to_float(images_u8: torch.Tensor) -> torch.Tensor:
    return images_u8.to(torch.float32) / 255.0


@functools.lru_cache(maxsize=32)
def _on_device(values: tuple, device: torch.device, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """A small constant on ``device``, copied there once (a copy from
    pageable host memory waits for the device's queue). Made outside
    inference mode, so autograd may use it later."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype).to(device)


def normalize(img: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    return (img - _on_device(tuple(mean), img.device)) / _on_device(tuple(std), img.device)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic (a = -0.5) at |x| (jax's _fill_keys_cubic_kernel)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] f32 matrix of jax.image.resize's antialiased bicubic along
    one axis (compute_weight_mat of jax/_src/image/scale.py)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)  # widen the kernel when downsampling
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    w = _keys_cubic(np.abs(sample[:, None] - np.arange(in_size)[None, :]) / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _crop_weights(in_size: int, out_size: int, start: int, length: int,
                  device: torch.device) -> torch.Tensor:
    """Rows [start, start + length) of ``_resize_weights`` on ``device``,
    built and copied once (outside inference mode, as ``_on_device``)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_resize_weights(in_size, out_size)[start:start + length]
                                ).to(device)


def _resized_axis(img: torch.Tensor, dim: int, in_size: int, out_size: int,
                  start: int, length: int) -> torch.Tensor:
    """Rows [start, start + length) of the resize of ``img`` along ``dim``
    from in_size to out_size."""
    if in_size == out_size:
        return img.narrow(dim, start, length)
    w = _crop_weights(in_size, out_size, start, length, img.device)
    return torch.movedim(torch.tensordot(img, w, dims=([dim], [1])), -1, dim)


def eval_resize_center_crop(img: torch.Tensor, out_size: int, crop_pct: float = 0.9
                            ) -> torch.Tensor:
    """Resize the shorter side to int(out_size / crop_pct) (torchvision's
    Resize(size)), centre-crop out_size × out_size and clip to [0, 1].
    img: [..., H, W, C] float in [0, 1], one image or a batch; only the
    cropped rows and columns of the resize are computed. A crop larger than
    the resize raises, as the JAX package's slice does (ops/augment.py:342):
    CIFAR-P frames (``evals.robustness.process_p_frames``, resized to 256)
    at an input size above 256."""
    h, w = img.shape[-3], img.shape[-2]
    size = int(out_size / crop_pct)
    if out_size > size:
        raise ValueError(f"a centre crop of {out_size} from a resize to {size} "
                         f"(crop_pct {crop_pct} above 1)")
    if h <= w:
        nh, nw = size, max(int(round(size * w / h)), size)
    else:
        nw, nh = size, max(int(round(size * h / w)), size)
    top, left = (nh - out_size) // 2, (nw - out_size) // 2
    out = _resized_axis(img, img.ndim - 3, h, nh, top, out_size)
    out = _resized_axis(out, img.ndim - 2, w, nw, left, out_size)
    return out.clamp(0.0, 1.0)


def eval_transform_batch(images_u8: torch.Tensor, out_size: int = 224, crop_pct: float = 0.9,
                         imagenet_default_mean_and_std: bool = True) -> torch.Tensor:
    """uint8 [B, H, W, C] → normalized f32 [B, out, out, C] on the images'
    device: to [0, 1], resize and centre crop, normalize."""
    mean = IMAGENET_DEFAULT_MEAN if imagenet_default_mean_and_std else IMAGENET_INCEPTION_MEAN
    std = IMAGENET_DEFAULT_STD if imagenet_default_mean_and_std else IMAGENET_INCEPTION_STD
    return normalize(eval_resize_center_crop(to_float(images_u8), out_size, crop_pct), mean, std)


# ---------------------------------------------------------------------------
# The train half: planar [B, C, H, W] f32 in [0, 1]
# ---------------------------------------------------------------------------

_GRAY_W = (0.299, 0.587, 0.114)


def to_planar(images_u8: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] uint8 → [B, C, H, W] f32 in [0, 1]."""
    return images_u8.permute(0, 3, 1, 2).to(torch.float32) / 255.0


def from_planar(imgs: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → [B, H, W, C] (a view)."""
    return imgs.permute(0, 2, 3, 1)


def _gray_planar(imgs: torch.Tensor) -> torch.Tensor:
    return (imgs * _on_device(_GRAY_W, imgs.device).view(1, 3, 1, 1)).sum(dim=1, keepdim=True)


def _uniform_in(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jax.random.uniform's map of raw u ∈ [0, 1) onto [lo, hi), in f32:
    max(lo, u·(hi − lo) + lo)."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp_min(u * (hi32 - lo32) + lo32, float(lo32))


def _draw_u(generator: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device)


# --- random resized crop ---------------------------------------------------

@dataclasses.dataclass
class RRCDraws:
    """Per sample and attempt: the area fraction's and the log aspect's raw
    uniforms [B, attempts]; the offsets' raw uniforms [B]."""

    area_u: torch.Tensor
    ratio_u: torch.Tensor
    iu: torch.Tensor
    ju: torch.Tensor


def draw_rrc(generator: torch.Generator, b: int, attempts: int = 10) -> RRCDraws:
    return RRCDraws(_draw_u(generator, b, attempts), _draw_u(generator, b, attempts),
                    _draw_u(generator, b), _draw_u(generator, b))


def _rrc_params(draws: RRCDraws, h, w, scale: Tuple[float, float], ratio: Tuple[float, float]
                ) -> Tuple[torch.Tensor, ...]:
    """torchvision's RandomResizedCrop.get_params over the attempts: the
    first attempt whose box fits, else the centre crop clamped to the ratio
    range. h, w: ints or [B] int tensors (a letterboxed sample's valid
    extent). Returns (top, left, crop_h, crop_w), [B] int32 each."""
    b, device = draws.iu.shape[0], draws.iu.device

    def per_sample(v):  # an int filled on the device: no copy from the host
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.int32)
        return torch.full((b,), v, dtype=torch.int32, device=device)

    h, w = per_sample(h), per_sample(w)
    area = (h * w).to(torch.float32)[:, None]
    target_area = area * _uniform_in(draws.area_u, *scale)
    log_lo, log_hi = np.log(np.float32(ratio[0])), np.log(np.float32(ratio[1]))
    aspect = torch.exp(_uniform_in(draws.ratio_u, log_lo, log_hi))
    ws = torch.round(torch.sqrt(target_area * aspect)).to(torch.int32)
    hs = torch.round(torch.sqrt(target_area / aspect)).to(torch.int32)
    valid = (ws > 0) & (ws <= w[:, None]) & (hs > 0) & (hs <= h[:, None])
    first = valid.to(torch.uint8).argmax(dim=1, keepdim=True)  # the first valid attempt
    any_valid = valid.any(dim=1)
    ch = hs.gather(1, first)[:, 0]
    cw = ws.gather(1, first)[:, 0]
    top = torch.floor(draws.iu * (h - ch + 1).to(torch.float32)).to(torch.int32)
    left = torch.floor(draws.ju * (w - cw + 1).to(torch.float32)).to(torch.int32)
    # the fallback: the aspect clamped to the ratio range, centred
    in_ratio = w.to(torch.float32) / h.to(torch.float32)
    too_tall, too_wide = in_ratio < np.float32(ratio[0]), in_ratio > np.float32(ratio[1])
    fw = torch.where(too_wide, torch.round(h * np.float32(ratio[1])).to(torch.int32), w)
    fh = torch.where(too_tall, torch.round(w / np.float32(ratio[0])).to(torch.int32), h)
    f_top = torch.div(h - fh, 2, rounding_mode="floor")
    f_left = torch.div(w - fw, 2, rounding_mode="floor")
    return (torch.where(any_valid, top, f_top), torch.where(any_valid, left, f_left),
            torch.where(any_valid, ch, fh), torch.where(any_valid, cw, fw))


def _cubic_weights(frac: torch.Tensor) -> torch.Tensor:
    """Keys cubic (a = -0.5) weights of the taps at offsets -1 .. 2 from
    floor(position); frac ∈ [0, 1). Returns [..., 4]."""
    a = -0.5
    x = torch.stack([frac + 1.0, frac, 1.0 - frac, 2.0 - frac], dim=-1)
    ax = x.abs()
    w1 = (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0
    w2 = a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a
    return torch.where(ax <= 1.0, w1, torch.where(ax < 2.0, w2, torch.zeros_like(ax)))


def _linear_weights(frac: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(frac)
    return torch.stack([zero, 1.0 - frac, frac, zero], dim=-1)


def _batched_resample_planar(imgs: torch.Tensor, axis: int, out_size: int,
                             in_start: torch.Tensor, in_size: torch.Tensor,
                             method: str) -> torch.Tensor:
    """Resample planar [B, C, H, W] along axis 2 (H) or 3 (W) from the
    per-sample window [in_start, in_start + in_size) ([B] ints) to out_size:
    one [B, out, n] interpolation matrix (each tap's weight at its clamped
    index, the taps added in order) and a batched product."""
    n = imgs.shape[axis]
    step = in_size.to(torch.float32) / out_size
    pos = (in_start.to(torch.float32)[:, None]
           + (torch.arange(out_size, dtype=torch.float32, device=imgs.device)[None, :] + 0.5)
           * step[:, None] - 0.5)
    base = torch.floor(pos)
    frac = pos - base
    weights = _cubic_weights(frac) if method == "bicubic" else _linear_weights(frac)
    taps = torch.arange(-1, 3, device=imgs.device)
    idx = torch.clamp(base.to(torch.int64)[..., None] + taps, 0, n - 1)  # [B, O, 4]
    cols = torch.arange(n, device=imgs.device)
    interp = None
    for t in range(4):
        term = (idx[..., t, None] == cols).to(torch.float32) * weights[..., t, None]
        interp = term if interp is None else interp + term  # [B, O, N]
    if axis == 2:
        return torch.einsum("bon,bcnw->bcow", interp, imgs)
    if axis == 3:
        return torch.einsum("bon,bchn->bcho", interp, imgs)
    raise ValueError(axis)


def crop_and_resize_batch(imgs: torch.Tensor, top, left, crop_h, crop_w,
                          out_size: Tuple[int, int], method: str = "bicubic") -> torch.Tensor:
    """Each sample's box [top, top + crop_h) × [left, left + crop_w)
    resampled to out_size (the crop never materializes)."""
    oh, ow = out_size
    out = _batched_resample_planar(imgs, 2, oh, top, crop_h, method)
    return _batched_resample_planar(out, 3, ow, left, crop_w, method)


def random_resized_crop_batch(draws: RRCDraws, imgs: torch.Tensor, out_size: int,
                              scale: Tuple[float, float] = (0.08, 1.0),
                              ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
                              method: str = "bicubic",
                              valid_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RandomResizedCrop of planar [B, C, H, W] with per-sample boxes;
    valid_hw [B, 2] limits each sample to its letterboxed valid extent."""
    _, _, h, w = imgs.shape
    if valid_hw is not None:
        h, w = valid_hw[:, 0], valid_hw[:, 1]
    top, left, ch, cw = _rrc_params(draws, h, w, scale, ratio)
    return crop_and_resize_batch(imgs, top, left, ch, cw, (out_size, out_size),
                                 method).clamp(0.0, 1.0)


# --- horizontal flip ---------------------------------------------------------

def draw_hflip(generator: torch.Generator, b: int) -> torch.Tensor:
    return _draw_u(generator, b)


def random_hflip_batch(flip_u: torch.Tensor, imgs: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """Reverse the W axis of the samples whose raw uniform is below p."""
    flips = (flip_u < np.float32(p)).view(-1, 1, 1, 1)
    return torch.where(flips, imgs.flip(3), imgs)


# --- colour jitter -----------------------------------------------------------

# the six orders of (brightness, contrast, saturation), indexed as the JAX
# package indexes its lax.switch branches
JITTER_ORDERS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


@dataclasses.dataclass
class ColorJitterDraws:
    """Per-sample raw uniforms of the brightness, contrast and saturation
    factors [B], and the batch's order (an index into JITTER_ORDERS, a
    one-element int64 tensor, or an int)."""

    fb_u: torch.Tensor
    fc_u: torch.Tensor
    fs_u: torch.Tensor
    order: torch.Tensor


def draw_color_jitter(generator: torch.Generator, b: int) -> ColorJitterDraws:
    order = torch.randint(0, len(JITTER_ORDERS), (), generator=generator,
                          device=generator.device)
    return ColorJitterDraws(_draw_u(generator, b), _draw_u(generator, b), _draw_u(generator, b),
                            order)


def color_jitter_batch(draws: ColorJitterDraws, imgs: torch.Tensor, brightness: float = 0.4,
                       contrast: float = 0.4, saturation: float = 0.4) -> torch.Tensor:
    """torchvision ColorJitter with per-sample factors U[max(0, 1 − v), 1 + v]
    and one op order per batch (the JAX package's documented divergence from
    torchvision's per-sample order). Every op is clip(x·f + m·(1 − f)) with
    m = 0 (brightness), the grey image's mean (contrast) or the grey image
    (saturation); the order picks f and m of each position on the device."""
    def factor(u, v):
        return _uniform_in(u, max(0.0, 1.0 - v), 1.0 + v).view(-1, 1, 1, 1)

    f = (factor(draws.fb_u, brightness), factor(draws.fc_u, contrast),
         factor(draws.fs_u, saturation))
    # the batch's order as a row gathered on the device: indexing with a 0-d
    # tensor would read it back to the host
    order = torch.as_tensor(draws.order, device=imgs.device).reshape(1)
    ops = _on_device(JITTER_ORDERS, imgs.device, torch.int64).index_select(0, order)[0]
    x = imgs
    for position in range(3):
        op = ops[position]
        gray = _gray_planar(x)
        m = torch.where(op == 1, gray.mean(dim=(2, 3), keepdim=True), gray)
        m = torch.where(op == 0, torch.zeros_like(m), m)
        fp = torch.where(op == 0, f[0], torch.where(op == 1, f[1], f[2]))
        x = torch.clamp(x * fp + m * (1.0 - fp), 0.0, 1.0)
    return x


# --- random erasing ----------------------------------------------------------

@dataclasses.dataclass
class EraseDraws:
    """One rectangle's draws: the area's and the log aspect's raw uniforms
    [B, attempts], the offsets' [B], and the fill's normals [B, C, H, W]
    (None for mode 'const')."""

    area_u: torch.Tensor
    ratio_u: torch.Tensor
    iu: torch.Tensor
    ju: torch.Tensor
    noise: Optional[torch.Tensor]


@dataclasses.dataclass
class ErasingDraws:
    """The per-image gate's raw uniforms [B] and ``count`` rectangles."""

    gate_u: torch.Tensor
    rects: List[EraseDraws]


def draw_random_erasing(generator: torch.Generator, shape: Sequence[int], count: int = 1,
                        attempts: int = 10, mode: str = "pixel") -> ErasingDraws:
    b = shape[0]
    rects = [EraseDraws(_draw_u(generator, b, attempts), _draw_u(generator, b, attempts),
                        _draw_u(generator, b), _draw_u(generator, b),
                        torch.randn(tuple(shape), generator=generator, device=generator.device)
                        if mode == "pixel" else None)
             for _ in range(max(count, 0))]
    return ErasingDraws(_draw_u(generator, b), rects)


def random_erasing_batch(draws: ErasingDraws, imgs: torch.Tensor, prob: float = 0.25,
                         scale: Tuple[float, float] = (0.02, 1.0 / 3.0),
                         ratio: Tuple[float, float] = (0.3, 10.0 / 3.0),
                         mode: str = "pixel", count: int = 1) -> torch.Tensor:
    """timm RandomErasing on planar [B, C, H, W] (normalized images): one
    gate per image of probability ``prob``, then ``count`` rectangles, each
    of target area uniform(scale)·area/count, filled with normals ('pixel')
    or zeros ('const')."""
    if count <= 0:
        return imgs
    apply = draws.gate_u < np.float32(prob)
    for rect in draws.rects[:count]:
        imgs = _erase_one(rect, imgs, apply, (scale[0] / count, scale[1] / count), ratio, mode)
    return imgs


def _erase_one(draws: EraseDraws, imgs: torch.Tensor, apply: torch.Tensor,
               scale: Tuple[float, float], ratio: Tuple[float, float], mode: str) -> torch.Tensor:
    _, _, h, w = imgs.shape
    target = _uniform_in(draws.area_u, *scale) * np.float32(h * w)
    log_lo, log_hi = np.log(np.float32(ratio[0])), np.log(np.float32(ratio[1]))
    aspect = torch.exp(_uniform_in(draws.ratio_u, log_lo, log_hi))
    hs = torch.round(torch.sqrt(target * aspect)).to(torch.int32)
    ws = torch.round(torch.sqrt(target / aspect)).to(torch.int32)
    valid = (hs < h) & (ws < w)
    first = valid.to(torch.uint8).argmax(dim=1, keepdim=True)
    eh, ew = hs.gather(1, first)[:, 0], ws.gather(1, first)[:, 0]
    ok = valid.any(dim=1) & apply
    top = torch.floor(draws.iu * (h - eh).to(torch.float32)).to(torch.int32)
    left = torch.floor(draws.ju * (w - ew).to(torch.float32)).to(torch.int32)
    rows = torch.arange(h, device=imgs.device).view(1, 1, h, 1)
    cols = torch.arange(w, device=imgs.device).view(1, 1, 1, w)

    def bc(v):
        return v.view(-1, 1, 1, 1)

    region = ((rows >= bc(top)) & (rows < bc(top + eh))
              & (cols >= bc(left)) & (cols < bc(left + ew)))
    fill = torch.zeros_like(imgs) if mode == "const" else draws.noise.to(imgs.dtype)
    return torch.where(bc(ok) & region, fill, imgs)


# --- the finetune train transform --------------------------------------------

def _rows_of(v, start: int, stop: int, total: int):
    """Draws (a tensor, a list, a dataclass of them) made for a batch of
    ``total`` rows, cut to rows [start, stop); a draw for the whole batch
    (a 0-d tensor, an int) stays."""
    if isinstance(v, torch.Tensor):
        return v[start:stop] if v.dim() > 0 and v.shape[0] == total else v
    if isinstance(v, list):
        return [_rows_of(x, start, stop, total) for x in v]
    if dataclasses.is_dataclass(v):
        return type(v)(**{f.name: _rows_of(getattr(v, f.name), start, stop, total)
                          for f in dataclasses.fields(v)})
    return v


def _moved(v, device):
    """Draws (a tensor, a list, a dataclass of them) on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, list):
        return [_moved(x, device) for x in v]
    if dataclasses.is_dataclass(v):
        return type(v)(**{f.name: _moved(getattr(v, f.name), device)
                          for f in dataclasses.fields(v)})
    return v


@dataclasses.dataclass
class TrainAugmentDraws:
    """All draws of one batch of ``finetune_train_augment_batch``: the crop,
    the flip, RandAugment's rounds or the colour jitter (the other None),
    and the erasing (None when reprob is 0)."""

    rrc: RRCDraws
    flip_u: torch.Tensor
    rand_augment: Optional[list] = None
    color_jitter: Optional[ColorJitterDraws] = None
    erasing: Optional[ErasingDraws] = None

    def to(self, device) -> "TrainAugmentDraws":
        """The same draws on ``device`` (to hold the card's result against
        the CPU's)."""
        return _moved(self, device)


def draw_finetune_train_augment(generator: torch.Generator, b: int, out_size: int,
                                color_jitter_strength: float = 0.4, reprob: float = 0.25,
                                auto_augment: bool = False, re_mode: str = "pixel",
                                re_count: int = 1) -> TrainAugmentDraws:
    """The draws ``finetune_train_augment_batch`` takes for a batch of b
    images, with its flags."""
    from uncertainty_vit_tpu_torch.ops import randaugment

    rrc = draw_rrc(generator, b)
    flip_u = draw_hflip(generator, b)
    ra = randaugment.draw_rand_augment(generator, b) if auto_augment else None
    cj = (draw_color_jitter(generator, b)
          if not auto_augment and color_jitter_strength else None)
    erasing = (draw_random_erasing(generator, (b, 3, out_size, out_size), re_count, mode=re_mode)
               if reprob > 0 else None)
    return TrainAugmentDraws(rrc, flip_u, ra, cj, erasing)


def finetune_train_augment_batch(
    draws: TrainAugmentDraws,
    images_u8: torch.Tensor,
    out_size: int = 224,
    color_jitter_strength: float = 0.4,
    reprob: float = 0.25,
    imagenet_default_mean_and_std: bool = True,
    hflip: float = 0.5,
    auto_augment: bool = False,
    aa_magnitude: float = 9.0,
    aa_magnitude_std: float = 0.5,
    valid_hw: Optional[torch.Tensor] = None,
    interpolation: str = "bicubic",
    re_mode: str = "pixel",
    re_count: int = 1,
) -> torch.Tensor:
    """The finetune train transform (timm create_transform as
    run_class_finetuning.py:117 invokes it): random resized crop, hflip,
    RandAugment (auto_augment) or else colour jitter, normalize, random
    erasing. uint8 [B, H, W, C] → normalized f32 [B, out, out, C] (a view
    of a planar tensor)."""
    from uncertainty_vit_tpu_torch.ops import randaugment

    mean = IMAGENET_DEFAULT_MEAN if imagenet_default_mean_and_std else IMAGENET_INCEPTION_MEAN
    std = IMAGENET_DEFAULT_STD if imagenet_default_mean_and_std else IMAGENET_INCEPTION_STD
    imgs = to_planar(images_u8)
    imgs = random_resized_crop_batch(draws.rrc, imgs, out_size, method=interpolation,
                                     valid_hw=valid_hw)
    imgs = random_hflip_batch(draws.flip_u, imgs, hflip)
    if auto_augment:
        imgs = randaugment.rand_augment_batch(draws.rand_augment, imgs, magnitude=aa_magnitude,
                                              magnitude_std=aa_magnitude_std)
    elif color_jitter_strength:
        imgs = color_jitter_batch(draws.color_jitter, imgs, color_jitter_strength,
                                  color_jitter_strength, color_jitter_strength)
    imgs = ((imgs - _on_device(tuple(mean), imgs.device).view(1, 3, 1, 1))
            / _on_device(tuple(std), imgs.device).view(1, 3, 1, 1))
    if reprob > 0:
        imgs = random_erasing_batch(draws.erasing, imgs, prob=reprob, mode=re_mode,
                                    count=re_count)
    return from_planar(imgs)


def make_finetune_train_augment(out_size: int, mesh=None, **flags) -> Callable[..., torch.Tensor]:
    """aug_fn(generator, images_u8, valid_hw) of the train step: the draws of
    ``finetune_train_augment_batch`` with ``flags`` from ``generator``, then
    the transform. Under a ``parallel.mesh.Mesh`` whose data axis splits the
    batch the images are this rank's rows of the global batch: the draws are
    made for the global batch and the rank's rows kept, as one process
    draws them (the colour jitter's order is the batch's, the same on every
    rank)."""
    from uncertainty_vit_tpu_torch.parallel import mesh as meshlib

    draw_flags = {k: flags[k] for k in ("color_jitter_strength", "reprob", "auto_augment",
                                        "re_mode", "re_count") if k in flags}

    def aug_fn(generator: torch.Generator, images_u8: torch.Tensor,
               valid_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
        rows = meshlib.data_rows(mesh, images_u8.shape[0])
        total = images_u8.shape[0] if rows is None else rows[2]
        draws = draw_finetune_train_augment(generator, total, out_size, **draw_flags)
        if rows is not None:
            draws = _rows_of(draws, *rows)
        return finetune_train_augment_batch(draws, images_u8, out_size, valid_hw=valid_hw,
                                            **flags)

    return aug_fn


# --- the pretrain transform --------------------------------------------------

@dataclasses.dataclass
class PretrainAugmentDraws:
    """All draws of one batch of ``pretrain_augment_batch`` at its
    aug_level: the colour jitter (levels 4 / -1), the flip (2, 3, 4, -1) and
    the crop (3, 4, -1); None where the level takes none."""

    color_jitter: Optional[ColorJitterDraws] = None
    flip_u: Optional[torch.Tensor] = None
    rrc: Optional[RRCDraws] = None

    def to(self, device) -> "PretrainAugmentDraws":
        """The same draws on ``device``."""
        return _moved(self, device)


def draw_pretrain_augment(generator: torch.Generator, b: int, aug_level: int = -1
                          ) -> PretrainAugmentDraws:
    """The draws ``pretrain_augment_batch`` takes for a batch of b images."""
    return PretrainAugmentDraws(
        draw_color_jitter(generator, b) if aug_level in (4, -1) else None,
        draw_hflip(generator, b) if aug_level in (2, 3, 4, -1) else None,
        draw_rrc(generator, b) if aug_level in (3, 4, -1) else None)


def pretrain_augment_batch(draws: PretrainAugmentDraws, images_u8: torch.Tensor,
                           out_size: int = 224, aug_level: int = -1,
                           imagenet_default_mean_and_std: bool = True,
                           color_jitter_strength: float = 0.4,
                           valid_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The DataAugmentationForBEiT ladder (datasets.py:38-84): aug_level 0
    centre crop, 1 resize the shorter side to out/0.875 and centre crop, 2
    also the flip, 3 flip and random resized crop, 4 / -1 (the default)
    colour jitter, flip and random resized crop. uint8 [B, H, W, C] →
    normalized f32 [B, out, out, C] (a view of a planar tensor).

    valid_hw [B, 2] (letterboxed extents, --decode_letterbox): the crop
    stays inside each sample's valid region, which lies at the canvas's top
    left, so the flip comes after the crop (the JAX package's documented
    order: the same distribution as flip-then-crop, with no zero fill
    mirrored into view), and levels 0–2 take one centred square box of side
    min(out, shorter) (level 0) or 0.875·shorter over the valid extent,
    resampled to out."""
    mean = IMAGENET_DEFAULT_MEAN if imagenet_default_mean_and_std else IMAGENET_INCEPTION_MEAN
    std = IMAGENET_DEFAULT_STD if imagenet_default_mean_and_std else IMAGENET_INCEPTION_STD
    imgs = to_planar(images_u8)
    flips = aug_level in (2, 3, 4, -1)
    rrc = aug_level in (3, 4, -1)
    if aug_level in (4, -1):
        imgs = color_jitter_batch(draws.color_jitter, imgs, color_jitter_strength,
                                  color_jitter_strength, color_jitter_strength)
    if valid_hw is not None:
        if rrc:
            out = random_resized_crop_batch(draws.rrc, imgs, out_size, valid_hw=valid_hw)
        else:
            vh = valid_hw[:, 0].to(torch.float32)
            vw = valid_hw[:, 1].to(torch.float32)
            shorter = torch.minimum(vh, vw)
            side = (torch.clamp_max(shorter, float(out_size)) if aug_level == 0
                    else 0.875 * shorter)
            sidei = torch.round(side).to(torch.int32)
            top = ((vh - side) / 2.0).to(torch.int32)
            left = ((vw - side) / 2.0).to(torch.int32)
            out = crop_and_resize_batch(imgs, top, left, sidei, sidei,
                                        (out_size, out_size)).clamp(0.0, 1.0)
        if flips:
            out = random_hflip_batch(draws.flip_u, out)
        return normalize(from_planar(out), mean, std)
    if flips:
        imgs = random_hflip_batch(draws.flip_u, imgs)
    if rrc:
        imgs = random_resized_crop_batch(draws.rrc, imgs, out_size)
    elif aug_level == 0:
        h, w = imgs.shape[2], imgs.shape[3]
        top, left = (h - out_size) // 2, (w - out_size) // 2
        imgs = imgs[:, :, top:top + out_size, left:left + out_size]
    else:  # levels 1, 2: the shorter side to out/0.875, then the centre crop
        b, _, h, w = imgs.shape
        size = int(out_size / 0.875)
        nh = size if h <= w else int(round(size * h / w))
        nw = int(round(size * w / h)) if h <= w else size
        zeros = torch.zeros((b,), dtype=torch.int32, device=imgs.device)
        imgs = _batched_resample_planar(imgs, 2, nh, zeros, torch.full_like(zeros, h), "bicubic")
        imgs = _batched_resample_planar(imgs, 3, nw, zeros, torch.full_like(zeros, w), "bicubic")
        top, left = (nh - out_size) // 2, (nw - out_size) // 2
        imgs = imgs[:, :, top:top + out_size, left:left + out_size].clamp(0.0, 1.0)
    return normalize(from_planar(imgs), mean, std)


def make_pretrain_augment(out_size: int, aug_level: int = -1, **flags
                          ) -> Callable[..., torch.Tensor]:
    """aug_fn(generator, images_u8, valid_hw) of the cyclical train step:
    the draws of ``pretrain_augment_batch`` at ``aug_level`` from
    ``generator``, then the transform with ``flags``."""

    def aug_fn(generator: torch.Generator, images_u8: torch.Tensor,
               valid_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
        draws = draw_pretrain_augment(generator, images_u8.shape[0], aug_level)
        return pretrain_augment_batch(draws, images_u8, out_size, aug_level, valid_hw=valid_hw,
                                      **flags)

    return aug_fn


# --- the BEiT two-view transform ----------------------------------------------

DISCRETE_VAE_TYPES = ("none", "dall-e", "customized")


@dataclasses.dataclass
class TwoViewDraws:
    """All draws of one batch of ``pretrain_two_view_batch``: the colour
    jitter, the flip (one per sample, shared by both views) and the crop
    (one box per sample, shared by both views)."""

    color_jitter: ColorJitterDraws
    flip_u: torch.Tensor
    rrc: RRCDraws

    def to(self, device) -> "TwoViewDraws":
        """The same draws on ``device``."""
        return _moved(self, device)


def draw_pretrain_two_view(generator: torch.Generator, b: int) -> TwoViewDraws:
    """The draws ``pretrain_two_view_batch`` takes for a batch of b images."""
    return TwoViewDraws(draw_color_jitter(generator, b), draw_hflip(generator, b),
                        draw_rrc(generator, b))


def pretrain_two_view_batch(draws: TwoViewDraws, images_u8: torch.Tensor, out_size: int = 224,
                            second_size: int = 112,
                            imagenet_default_mean_and_std: bool = True,
                            color_jitter_strength: float = 0.4, discrete_vae_type: str = "none",
                            second_interpolation: str = "bicubic",
                            valid_hw: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DataAugmentationForBEiT's two-picture path (datasets.py:70-118;
    JAX ops/augment.py:728-800): colour jitter and the flip on the common
    image, then one random resized crop box a sample over (0.08, 1) and
    (3/4, 4/3), resampled at ``out_size`` (bicubic) and at ``second_size``
    (``second_interpolation``; the reference's lanczos default runs as
    bicubic, ``cli.builders.interp_method``), each clipped to [0, 1]
    (RandomResizedCropAndInterpolationWithTwoPic, transforms.py:164-183).
    The student view is normalized; the tokenizer view by
    ``discrete_vae_type``: "none" stays in [0, 1], "dall-e" goes through
    ``map_pixels``, "customized" is Inception-normalized. uint8 [B, H, W, C]
    → (f32 [B, out, out, C], f32 [B, second, second, C]).

    valid_hw [B, 2] (letterboxed extents, --decode_letterbox): the box stays
    inside each sample's valid region and the flip, one draw for both
    views, comes after the crop (see ``pretrain_augment_batch``)."""
    if discrete_vae_type not in DISCRETE_VAE_TYPES:
        raise ValueError(f"discrete_vae_type must be one of {DISCRETE_VAE_TYPES}, "
                         f"got {discrete_vae_type!r}")
    mean = IMAGENET_DEFAULT_MEAN if imagenet_default_mean_and_std else IMAGENET_INCEPTION_MEAN
    std = IMAGENET_DEFAULT_STD if imagenet_default_mean_and_std else IMAGENET_INCEPTION_STD
    imgs = to_planar(images_u8)
    imgs = color_jitter_batch(draws.color_jitter, imgs, color_jitter_strength,
                              color_jitter_strength, color_jitter_strength)
    if valid_hw is None:
        imgs = random_hflip_batch(draws.flip_u, imgs)
        h, w = imgs.shape[2], imgs.shape[3]
    else:
        h, w = valid_hw[:, 0], valid_hw[:, 1]
    top, left, ch, cw = _rrc_params(draws.rrc, h, w, (0.08, 1.0), (3.0 / 4.0, 4.0 / 3.0))
    first = crop_and_resize_batch(imgs, top, left, ch, cw, (out_size, out_size)).clamp(0.0, 1.0)
    second = crop_and_resize_batch(imgs, top, left, ch, cw, (second_size, second_size),
                                   second_interpolation).clamp(0.0, 1.0)
    if valid_hw is not None:
        first = random_hflip_batch(draws.flip_u, first)
        second = random_hflip_batch(draws.flip_u, second)
    first = normalize(from_planar(first), mean, std)
    second = from_planar(second)
    if discrete_vae_type == "dall-e":
        second = map_pixels(second)
    elif discrete_vae_type == "customized":
        second = normalize(second, IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD)
    return first, second


def make_pretrain_two_view(out_size: int, second_size: int, **flags
                           ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """aug_fn(generator, images_u8, valid_hw) of the MIM and joint train
    steps: the draws of ``pretrain_two_view_batch`` from ``generator``, then
    the transform with ``flags``."""

    def aug_fn(generator: torch.Generator, images_u8: torch.Tensor,
               valid_hw: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        draws = draw_pretrain_two_view(generator, images_u8.shape[0])
        return pretrain_two_view_batch(draws, images_u8, out_size, second_size,
                                       valid_hw=valid_hw, **flags)

    return aug_fn
