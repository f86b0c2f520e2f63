"""BEiT's masked-image-modeling pretrainer and the joint cyclical+BEiT model.

Counterpart of uncertainty_vit_tpu/models/mim.py (``MIMViT`` :24-53,
``JointViT`` :56-101), mirroring the reference's
VisionTransformerForMaskedImageModeling (modeling_pretrain.py:32-136) and
VisionTransformerForCyclicalJointTraining (modeling_cyclical_joint.py:
32-220). Both subclass the backbone as ``models.cyclical.CyclicalViT`` does:
a mask token that applies whenever a mask is given, every weight drawn from
trunc_normal(0.02) bounded at ±0.02, the patch embedding's too, so the
parameters sit under the reference's names. As in the JAX package the heads
run over all patch tokens and the loss does the masking (its documented
divergence from the reference's gather of the masked tokens).

``MIMViT``: ``norm``, then ``lm_head`` Linear(C → vocab), f32 logits.
``JointViT``: with ``layer_results`` ("end" / "fc") the per-layer outputs
without cls and before ``norm`` (the EMA teacher's call); else ``norm``,
then ``lm_head`` = Linear(C, 2C) → GELU (exact) → Linear(2C, C), keyed
``lm_head.0`` / ``lm_head.2`` as in the reference, and ``beit_head``
Linear(C → vocab) in f32. The heads compute in the model's dtype.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.core import init as I
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.models.cyclical import INIT_STD, LAYER_RESULTS
from uncertainty_vit_tpu_torch.models.layers import _Params, layer_norm
from uncertainty_vit_tpu_torch.models.vit import ViTBackbone


def _dense(cin: int, cout: int, device, generator) -> _Params:
    return _Params((cout, cin), I.trunc_normal(INIT_STD, INIT_STD), (cout,), device=device,
                   generator=generator)


def _linear(x: torch.Tensor, layer: _Params, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class _MaskedBackbone(ViTBackbone):
    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, device, generator):
        cfg = cfg.replace(init_std=INIT_STD, init_trunc_abs=INIT_STD)
        super().__init__(cfg, dtype, device=device, generator=generator, has_mask_token=True,
                         mask_only_when_training=False, patch_embed_init=("trunc", INIT_STD))
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps, device=device)


class MIMViT(_MaskedBackbone):
    """The classic BEiT pretrainer: masked patches → codebook logits."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32, *,
                 vocab_size: int = 8192, device=None,
                 generator: Optional[torch.Generator] = None):
        device = resolve_device(device)
        super().__init__(cfg, dtype, device, generator)
        self.vocab_size = vocab_size
        self.lm_head = _dense(cfg.embed_dim, vocab_size, device, generator)

    def forward(self, images: torch.Tensor, bool_masked_pos: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None,
                gumbel_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images [B, H, W, C]; ``bool_masked_pos`` [B, num_patches] (1 =
        masked) blends in the mask token → f32 logits [B, num_patches,
        vocab]. Drop-path and dropout draw from ``generator``, the gumbel
        and dual_sto attentions from ``gumbel_generator``."""
        x, _, _ = super().forward(images, generator, deterministic,
                                  bool_masked_pos=bool_masked_pos,
                                  gumbel_generator=gumbel_generator)
        x = layer_norm(self.norm, x)[:, 1:]
        return _linear(x, self.lm_head, self.dtype).float()


class JointViT(_MaskedBackbone):
    """The joint cyclical + BEiT pretrainer: ``lm_head`` regresses the
    teacher's features, ``beit_head`` predicts the codebook tokens."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32, *,
                 vocab_size: int = 8192, device=None,
                 generator: Optional[torch.Generator] = None):
        device = resolve_device(device)
        super().__init__(cfg, dtype, device, generator)
        c = cfg.embed_dim
        self.vocab_size = vocab_size
        self.lm_head = nn.Sequential(_dense(c, 2 * c, device, generator), nn.GELU(),
                                     _dense(2 * c, c, device, generator))
        self.beit_head = _dense(c, vocab_size, device, generator)

    def forward(self, images: torch.Tensor, bool_masked_pos: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None, layer_results: Optional[str] = None,
                gumbel_generator: Optional[torch.Generator] = None,
                ) -> Union[List[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
        """``layer_results`` "end" (the blocks' outputs) or "fc" (their
        post-MLP residuals): the per-layer activations [B, N, C] without the
        cls token, in the compute dtype. Else (lm_out [B, N, C] in the
        compute dtype, beit_out [B, N, vocab] f32) over the normed patch
        tokens."""
        if layer_results is not None and layer_results not in LAYER_RESULTS:
            raise ValueError(f"layer_results must be one of {LAYER_RESULTS}, got {layer_results!r}")
        x, layer_xs, fc_features = super().forward(images, generator, deterministic,
                                                   bool_masked_pos=bool_masked_pos,
                                                   gumbel_generator=gumbel_generator)
        if layer_results is not None:
            zs = layer_xs if layer_results == "end" else fc_features
            return [z[:, 1:] for z in zs]
        x = layer_norm(self.norm, x)[:, 1:]
        h = F.gelu(_linear(x, self.lm_head[0], self.dtype))
        lm_out = _linear(h, self.lm_head[2], self.dtype)
        beit_out = _linear(x, self.beit_head, self.dtype).float()
        return lm_out, beit_out
