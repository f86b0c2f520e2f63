"""Image preparation for batches already at the model's input size.

Counterpart of the eval subset of uncertainty_vit_tpu/ops/augment.py
(:29-57): uint8 → float in [0, 1], then per-channel normalization. Images
are NHWC, so the channel constants broadcast over the last axis.
"""

from __future__ import annotations

from typing import Sequence

import torch

# timm.data.constants
IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)


def to_float(images_u8: torch.Tensor) -> torch.Tensor:
    return images_u8.to(torch.float32) / 255.0


def normalize(img: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    mean_t = torch.tensor(mean, dtype=torch.float32, device=img.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=img.device)
    return (img - mean_t) / std_t
