"""Image preparation on the device: the eval transform and normalization.

Counterpart of the eval half of uncertainty_vit_tpu/ops/augment.py: the
mean/std constants (:28-31), ``to_float`` / ``normalize`` (:49-57),
``eval_resize_center_crop`` (:329-346) and ``eval_transform_batch``
(:804-814). Images are NHWC, so the channel constants broadcast over the
last axis.

The resize is ``jax.image.resize(..., "bicubic")``'s, which is not
``F.interpolate(mode="bicubic")``'s: the Keys cubic with a = -0.5 (torch
takes -0.75), widened by 1/scale when it downsamples (antialiasing), taps
that fall outside the input dropped and the rest renormalized to sum 1 (no
border clamp), and an output whose sample position lies outside
[-0.5, in - 0.5] zeroed. ``_resize_weights`` builds that [out, in] matrix on
the host with numpy; the rows that the centre crop keeps go to the device
once per (in, out, crop, device), and the resize is one product per axis
there, in f32. An axis whose size does not change is left as it is, as
jax.image.resize skips it.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

# timm.data.constants
IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)


def to_float(images_u8: torch.Tensor) -> torch.Tensor:
    return images_u8.to(torch.float32) / 255.0


@functools.lru_cache(maxsize=16)
def _on_device(values: tuple, device: torch.device) -> torch.Tensor:
    """A small f32 constant on ``device``, copied there once (a copy from
    pageable host memory waits for the device's queue). Made outside
    inference mode, so autograd may use it later."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32).to(device)


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
    cropped rows and columns of the resize are computed."""
    h, w = img.shape[-3], img.shape[-2]
    size = int(out_size / crop_pct)
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
