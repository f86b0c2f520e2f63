"""The in-repo discrete VAE image tokenizer.

Counterpart of uncertainty_vit_tpu/models/dvae.py (``DiscreteVAE`` :89-163),
which mirrors the reference's DiscreteVAE (modeling_discrete_vae.py:79-237):
an encoder of [stride-2 4×4 conv + ReLU, ResBlock] × num_layers and a 1×1
conv onto the codebook vocabulary; a decoder of [ConvTranspose2d(4, 2, 1) +
ReLU, ResBlock] × num_layers and a 1×1 conv onto the image channels.

The modules sit in the reference's ``nn.Sequential`` layout, so their
parameters carry its names (JAX utils/checkpoint.py:_dvae_torch_key_for,
:372-409): ``encoder.{2i}.0`` the strided conv, ``encoder.{2i+1}.net.{0,2,4}``
the ResBlock's convs, ``encoder.{2L}`` the head, the decoder alike with
ConvTranspose2d at the even slots, and ``codebook.weight``; a reference
state dict loads with ``strict=True``. The decoder's upsampling is torch's
own ``nn.ConvTranspose2d(…, 4, 2, 1)``, which the JAX package's
``TorchConvTranspose`` (:32-72) emulates.

Images enter NHWC in [0, 1] (or normalized, as the tokenizer view is) and
are made NCHW inside; logits and reconstructions come back NHWC, as in the
JAX package. Every forward runs in float32 (``f32_scope``), the JAX
package's rule, whatever a caller set for TF32 elsewhere in the process.

Parameters are drawn as flax draws them (``core.init``): the convs
``lecun_normal``, the transposed convs U(±1/sqrt(fan_in)) (the JAX module's
variance_scaling(1/3, fan_in, uniform)), the codebook N(0, 1/codebook_dim),
biases zero.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple, Union

import torch
import torch.nn as nn

from uncertainty_vit_tpu_torch.core import init as I
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device

@contextlib.contextmanager
def f32_scope() -> Iterator[None]:
    """Run a tokenizer's convolutions and matmuls in float32, the JAX
    package's rule: TF32 off in cuDNN and cuBLAS inside, the process's flags
    restored on exit, so the scope neither takes nor leaves a setting of
    another caller. The flags are global, so the scope also holds for a
    backward pass run inside it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def conv2d(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0, *, device,
           generator: Optional[torch.Generator]) -> nn.Conv2d:
    """nn.Conv2d with flax's default init (lecun_normal kernel, zero bias),
    drawn from ``generator``; torch's own init is skipped."""
    conv = torch.nn.utils.skip_init(nn.Conv2d, cin, cout, k, stride, padding, device=device)
    I.lecun_normal(cin * k * k)(conv.weight, generator)
    I.zeros(conv.bias)
    return conv


def conv_transpose2d(cin: int, cout: int, *, device, generator: Optional[torch.Generator]
                     ) -> nn.ConvTranspose2d:
    """nn.ConvTranspose2d(cin, cout, 4, 2, 1), its weight [cin, cout, 4, 4]
    U(±1/sqrt(16·cin)), its bias zero."""
    conv = torch.nn.utils.skip_init(nn.ConvTranspose2d, cin, cout, 4, 2, 1, device=device)
    I.torch_linear_default(cin * 16)(conv.weight, generator)
    I.zeros(conv.bias)
    return conv


def draw_gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel draws −log(−log u), u uniform in [tiny, 1), as
    jax.random.gumbel makes them, on the generator's device."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class ResBlock(nn.Module):
    """modeling_discrete_vae.py:64-76: x + conv1×1(relu(conv3×3(relu(conv3×3(x)))))."""

    def __init__(self, chan: int, hidden: int, *, device, generator):
        super().__init__()
        self.net = nn.Sequential(
            conv2d(chan, hidden, 3, padding=1, device=device, generator=generator), nn.ReLU(),
            conv2d(hidden, hidden, 3, padding=1, device=device, generator=generator), nn.ReLU(),
            conv2d(hidden, chan, 1, device=device, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x) + x


def _nchw(images: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC images → NCHW in the parameters' dtype (f32; f64 for a float64
    copy of a tokenizer)."""
    return images.to(dtype).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class DiscreteVAE(nn.Module):
    """The discrete VAE (JAX :89-163); its forwards run in float32."""

    def __init__(self, image_size: int = 256, num_tokens: int = 8192, codebook_dim: int = 512,
                 num_layers: int = 3, hidden_dim: int = 64, channels: int = 3,
                 temperature: float = 0.9, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.image_size, self.num_tokens, self.num_layers = image_size, num_tokens, num_layers
        self.temperature = temperature
        self.codebook = torch.nn.utils.skip_init(nn.Embedding, num_tokens, codebook_dim,
                                                 device=device)
        I.normal(codebook_dim ** -0.5)(self.codebook.weight, generator)
        enc, dec = [], []
        enc_in, dec_in = channels, codebook_dim
        for _ in range(num_layers):
            enc.append(nn.Sequential(conv2d(enc_in, hidden_dim, 4, 2, 1, device=device,
                                            generator=generator), nn.ReLU()))
            enc.append(ResBlock(hidden_dim, hidden_dim, device=device, generator=generator))
            dec.append(nn.Sequential(conv_transpose2d(dec_in, hidden_dim, device=device,
                                                      generator=generator), nn.ReLU()))
            dec.append(ResBlock(hidden_dim, hidden_dim, device=device, generator=generator))
            enc_in = dec_in = hidden_dim
        enc.append(conv2d(hidden_dim, num_tokens, 1, device=device, generator=generator))
        dec.append(conv2d(hidden_dim, channels, 1, device=device, generator=generator))
        self.encoder = nn.Sequential(*enc)
        self.decoder = nn.Sequential(*dec)

    def encode_logits(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] → [B, H/2^L, W/2^L, vocab] logits (an NHWC view)."""
        with f32_scope():
            return _nhwc(self.encoder(_nchw(images, self.codebook.weight.dtype)))

    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        """The argmax over the encoder's logits (modeling_discrete_vae.py:
        133-138): [B, h·w] int64 token ids, row-major over the grid."""
        with f32_scope():
            idx = self.encoder(_nchw(images, self.codebook.weight.dtype)).argmax(dim=1)
        return idx.reshape(idx.shape[0], -1)

    def _decode(self, h: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.decoder(h.permute(0, 3, 1, 2)))

    def decode_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """[B, h, w] int codes → [B, H, W, C] reconstruction."""
        with f32_scope():
            return self._decode(self.codebook(codes.long()))

    def forward(self, images: torch.Tensor, temperature: Union[float, torch.Tensor, None] = None,
                gumbel: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training forward: softmax((logits + gumbel) / τ) over the
        vocabulary (without ``gumbel`` the plain softmax), its mix of the
        codebook rows, decoded. ``gumbel`` [B, h, w, vocab] is a draw of
        ``draw_gumbel``; τ defaults to ``temperature`` (a float or a 0-d
        device tensor). Returns (reconstruction [B, H, W, C], logits [B, h,
        w, vocab])."""
        tau = self.temperature if temperature is None else temperature
        with f32_scope():
            logits = _nhwc(self.encoder(_nchw(images, self.codebook.weight.dtype)))
            z = logits if gumbel is None else logits + gumbel.to(logits.dtype)
            soft = torch.softmax(z / tau, dim=-1)
            h = torch.einsum("bhwv,vd->bhwd", soft, self.codebook.weight)
            return self._decode(h), logits
