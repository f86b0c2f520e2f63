"""The OpenAI DALL-E discrete VAE tokenizer.

Counterpart of uncertainty_vit_tpu/models/dalle_vae.py (``DalleEncoder``,
``DalleDecoder``, ``DalleVAE`` :52-187), the network the reference's
``Dalle_VAE`` (modeling_discrete_vae.py:203-237) loads from OpenAI's pickled
``encoder.pkl`` / ``decoder.pkl``.

Encoder: a 7×7 conv (3 → n_hid), four groups of ``n_blk_per_group``
bottleneck blocks at widths (1, 2, 4, 8)·n_hid with a 2×2 max-pool between
groups, then ReLU and a 1×1 conv onto the vocabulary. A block is an identity
path (a 1×1 conv where the width changes) plus ``post_gain`` = 1/n_layers²
times ReLU→3×3(n_out/4) → ReLU→3×3 → ReLU→3×3 → ReLU→1×1(n_out). The decoder
mirrors it: a 1×1 conv (vocab → n_init), groups at (8, 4, 2, 1)·n_hid with a
nearest 2× upsample between groups (its blocks 1×1, 3×3, 3×3, 3×3), then ReLU
and a 1×1 conv onto 2·3 planes (the mean and the logit-Laplace scale). Every
conv pads (k − 1)/2.

The modules carry the ``dall_e`` package's names, so the pickles' state
dicts load with ``strict=True`` (JAX utils/checkpoint.py:_dalle_torch_key_for,
:450-465): ``blocks.input.{w,b}``, ``blocks.group_{g}.block_{b}.id_path.{w,b}``,
``blocks.group_{g}.block_{b}.res_path.conv_{k}.{w,b}``,
``blocks.output.conv.{w,b}``; ``w`` is OIHW. ``utils.checkpoint.
load_dalle_pickle_state_dict`` reads those pickles without the package.

Images enter NHWC (map_pixels'ed, as the reference feeds them) and results
come back NHWC. Forwards run in float32 (``models.dvae.f32_scope``).
Parameters take flax's default init, as the JAX package draws them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.core import init as I
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.models.dvae import _nchw, _nhwc, f32_scope
from uncertainty_vit_tpu_torch.ops.augment import unmap_pixels


class Conv2d(nn.Module):
    """dall_e.utils.Conv2d: a conv with "same" padding whose parameters are
    ``w`` (OIHW) and ``b``."""

    def __init__(self, n_in: int, n_out: int, kw: int, *, device, generator):
        super().__init__()
        self.kw = kw
        self.w = nn.Parameter(I.lecun_normal(n_in * kw * kw)(
            torch.empty((n_out, n_in, kw, kw), device=device), generator))
        self.b = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.w, self.b, padding=(self.kw - 1) // 2)


class _Block(nn.Module):
    def __init__(self, n_in: int, n_out: int, post_gain: float, kernels: Tuple[int, ...], *,
                 device, generator):
        super().__init__()
        n_hid = n_out // 4
        self.post_gain = post_gain
        self.id_path = (Conv2d(n_in, n_out, 1, device=device, generator=generator)
                        if n_in != n_out else nn.Identity())
        widths = (n_in, n_hid, n_hid, n_hid, n_out)
        layers = []
        for i, k in enumerate(kernels):
            layers += [(f"relu_{i + 1}", nn.ReLU()),
                       (f"conv_{i + 1}", Conv2d(widths[i], widths[i + 1], k, device=device,
                                                generator=generator))]
        self.res_path = nn.Sequential(OrderedDict(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.id_path(x) + self.post_gain * self.res_path(x)


def _groups(widths, n_in: int, n_blk: int, post_gain: float, kernels, between, *, device,
            generator):
    groups = []
    for g, w in enumerate(widths):
        layers = []
        for b in range(n_blk):
            layers.append((f"block_{b + 1}", _Block(n_in if b == 0 else w, w, post_gain, kernels,
                                                    device=device, generator=generator)))
        if g < len(widths) - 1:
            layers.append(between())
        groups.append((f"group_{g + 1}", nn.Sequential(OrderedDict(layers))))
        n_in = w
    return groups


class DalleEncoder(nn.Module):
    """dall_e's encoder (JAX :77-106): [B, H, W, 3] → [B, H/8, W/8, vocab]
    logits."""

    def __init__(self, group_count: int = 4, n_hid: int = 256, n_blk_per_group: int = 2,
                 input_channels: int = 3, vocab_size: int = 8192, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        post_gain = 1.0 / (group_count * n_blk_per_group) ** 2
        widths = [n_hid * m for m in (1, 2, 4, 8)[:group_count]]
        self.blocks = nn.Sequential(OrderedDict(
            [("input", Conv2d(input_channels, n_hid, 7, device=device, generator=generator))]
            + _groups(widths, n_hid, n_blk_per_group, post_gain, (3, 3, 3, 1),
                      lambda: ("pool", nn.MaxPool2d(kernel_size=2)), device=device,
                      generator=generator)
            + [("output", nn.Sequential(OrderedDict([
                ("relu", nn.ReLU()),
                ("conv", Conv2d(widths[-1], vocab_size, 1, device=device, generator=generator))
            ])))]))

    def logits_nchw(self, images: torch.Tensor) -> torch.Tensor:
        return self.blocks(_nchw(images, self.blocks.input.w.dtype))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.logits_nchw(images))


class DalleDecoder(nn.Module):
    """dall_e's decoder (JAX :128-153): [B, h, w, vocab] one-hot or
    probabilities → [B, 8h, 8w, 6] (the mean and logit-Laplace scale
    planes)."""

    def __init__(self, group_count: int = 4, n_init: int = 128, n_hid: int = 256,
                 n_blk_per_group: int = 2, output_channels: int = 3, vocab_size: int = 8192, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        post_gain = 1.0 / (group_count * n_blk_per_group) ** 2
        widths = [n_hid * m for m in (8, 4, 2, 1)[-group_count:]]
        self.blocks = nn.Sequential(OrderedDict(
            [("input", Conv2d(vocab_size, n_init, 1, device=device, generator=generator))]
            + _groups(widths, n_init, n_blk_per_group, post_gain, (1, 3, 3, 3),
                      lambda: ("upsample", nn.Upsample(scale_factor=2, mode="nearest")),
                      device=device, generator=generator)
            + [("output", nn.Sequential(OrderedDict([
                ("relu", nn.ReLU()),
                ("conv", Conv2d(widths[-1], 2 * output_channels, 1, device=device,
                                generator=generator))
            ])))]))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.blocks(_nchw(z, self.blocks.input.w.dtype)))


class DalleVAE(nn.Module):
    """The ``Dalle_VAE`` surface (modeling_discrete_vae.py:203-237; JAX
    :156-187) on the encoder and decoder above. ``image_size`` is the
    tokenizer view's side (the reference's second_input_size); tokens are
    (image_size/8)²."""

    def __init__(self, image_size: int = 112, vocab_size: int = 8192, n_hid: int = 256,
                 n_init: int = 128, n_blk_per_group: int = 2, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.image_size, self.vocab_size = image_size, vocab_size
        self.encoder = DalleEncoder(n_hid=n_hid, n_blk_per_group=n_blk_per_group,
                                    vocab_size=vocab_size, device=device, generator=generator)
        self.decoder = DalleDecoder(n_init=n_init, n_hid=n_hid, n_blk_per_group=n_blk_per_group,
                                    vocab_size=vocab_size, device=device, generator=generator)

    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] (map_pixels'ed) → [B, (S/8)²] int64 (:223-225)."""
        with f32_scope():
            idx = self.encoder.logits_nchw(images).argmax(dim=1)
        return idx.reshape(idx.shape[0], -1)

    def get_codebook_probs(self, images: torch.Tensor) -> torch.Tensor:
        """The softmax over the vocabulary (:227-229), [B, h, w, vocab]."""
        with f32_scope():
            return torch.softmax(self.encoder(images), dim=-1)

    def _reconstruct(self, idx: torch.Tensor) -> torch.Tensor:
        out = self.decoder(F.one_hot(idx.long(), self.vocab_size))
        return unmap_pixels(torch.sigmoid(out[..., :3]))

    def decode(self, img_seq: torch.Tensor) -> torch.Tensor:
        """[B, (S/8)²] int codes → [B, S, S, 3] reconstruction in [0, 1]
        (:217-221, with the sigmoid and unmap_pixels of its callers)."""
        s = self.image_size // 8
        with f32_scope():
            return self._reconstruct(img_seq.reshape(-1, s, s))

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The round trip: (codebook indices [B, h·w], reconstruction)."""
        with f32_scope():
            idx = self.encoder.logits_nchw(images).argmax(dim=1)
            return idx.reshape(idx.shape[0], -1), self._reconstruct(idx)
