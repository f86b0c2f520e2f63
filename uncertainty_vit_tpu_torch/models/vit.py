"""ViT backbone and the supervised/finetune model with the linear head.

Counterpart of uncertainty_vit_tpu/models/vit.py (``ViTBackbone`` :25-172,
``VisionTransformer`` :175-308), mirroring the reference's
modeling_finetune.py:367-523. ``VisionTransformer`` subclasses the backbone
so that its parameters sit at the top level under the reference's torch
names (``cls_token``, ``blocks.0.attn.qkv.weight``, ``fc_norm.weight``, ...),
which is where ``export_torch_state_dict`` of the JAX package puts them.

Not ported yet (they raise): the SNGP and heteroscedastic heads, the
spectral-norm fc_norm, attention variants other than softmax, the int8
trunk, masking and the split-trunk MC-dropout forward.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.core import init as I
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.models.layers import (
    Block, PatchEmbed, RelativePositionBias, _param, _Params, layer_norm,
)


class ViTBackbone(nn.Module):
    """Patch embed → [cls] + tokens (+ pos embed) → blocks.

    ``forward`` returns (x, layer_xs, fc_features): the final tokens and the
    per-layer block outputs / post-MLP residuals (learn_layer_weights reads
    the former)."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.quant != "none" or cfg.has_masking:
            raise NotImplementedError("the int8 trunk and token masking are not ported yet")
        self.cfg, self.dtype = cfg, dtype
        tn = I.trunc_normal(cfg.init_std, cfg.init_trunc_abs)
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, cfg.embed_dim, dtype,
                                      device=device, generator=generator)
        self.cls_token = _param((1, 1, cfg.embed_dim), tn, device, generator)
        self.pos_embed = (
            _param((1, cfg.num_patches + 1, cfg.embed_dim), tn, device, generator)
            if cfg.use_abs_pos_emb else None
        )
        self.pos_drop = cfg.drop_rate if cfg.dropout_from_block == 0 else 0.0
        self.rel_pos_bias = (
            RelativePositionBias(cfg.grid_size, cfg.num_heads, device=device)
            if cfg.use_shared_rel_pos_bias else None
        )
        dpr = np.linspace(0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(
            Block(
                cfg.embed_dim, cfg.num_heads, mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                qk_scale=cfg.qk_scale,
                drop=cfg.drop_rate if i >= cfg.dropout_from_block else 0.0,
                attn_drop=cfg.attn_drop_rate if i >= cfg.dropout_from_block else 0.0,
                drop_path_rate=float(dpr[i]), init_values=cfg.init_values,
                window_size=cfg.grid_size if cfg.use_rel_pos_bias else None,
                variant=cfg.attn_variant, layer_id=i + 1, init_std=cfg.init_std,
                init_trunc_abs=cfg.init_trunc_abs, layer_norm_eps=cfg.layer_norm_eps,
                use_flash=cfg.use_flash_attention, dtype=dtype,
                device=device, generator=generator,
            )
            for i in range(cfg.depth)
        )

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
        x = self.patch_embed(images.to(self.dtype))
        b, _, c = x.shape
        x = torch.cat([self.cls_token.to(self.dtype).expand(b, 1, c), x], dim=1)
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(self.dtype)
        x = F.dropout(x, self.pos_drop, self.training)
        rel_pos_bias = self.rel_pos_bias() if self.rel_pos_bias is not None else None
        layer_xs: List[torch.Tensor] = []
        fc_features: List[torch.Tensor] = []
        for blk in self.blocks:
            x, fc = blk(x, rel_pos_bias)
            layer_xs.append(x)
            fc_features.append(fc)
        return x, layer_xs, fc_features


class VisionTransformer(ViTBackbone):
    """Supervised/finetune ViT (modeling_finetune.py:367-523): backbone →
    pooled feature → linear head. Images are NHWC; logits are float32."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None):
        if cfg.head_type != "linear" or cfg.sngp_fc_norm:
            raise NotImplementedError("only the linear head is ported yet")
        super().__init__(cfg, dtype, device=device, generator=generator)
        c = cfg.embed_dim
        self.layer_log_weights = (
            _param((cfg.depth,), I.zeros, device, generator) if cfg.learn_layer_weights else None
        )
        final_norm = not cfg.learn_layer_weights and not cfg.remove_final_norm
        # mean pooling → fc_norm (no affine under linear_classifier,
        # modeling_finetune.py:412); cls token → norm, then token 0 (:411, 517)
        self.fc_norm = (
            nn.LayerNorm(c, eps=cfg.layer_norm_eps, elementwise_affine=not cfg.linear_classifier,
                         device=device)
            if final_norm and cfg.use_mean_pooling else None
        )
        self.norm = (
            nn.LayerNorm(c, eps=cfg.layer_norm_eps, device=device)
            if final_norm and not cfg.use_mean_pooling else None
        )
        self.head = _Params(
            (cfg.num_classes, c), I.scaled(I.trunc_normal(0.02, 2.0), cfg.init_scale),
            (cfg.num_classes,), device=device, generator=generator,
        )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x, layer_xs, _ = super().forward(images)
        feat = self._pool(x, layer_xs)
        return F.linear(feat.float(), self.head.weight, self.head.bias)

    def _pool(self, x: torch.Tensor, layer_xs: List[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        if cfg.learn_layer_weights:
            # softmax-weighted combination of per-layer pooled features
            # (modeling_finetune.py:499-510)
            pooled = [lx[:, 1:].mean(dim=1) if cfg.use_mean_pooling else lx[:, 0]
                      for lx in layer_xs]
            if cfg.layernorm_before_combine:
                pooled = [F.layer_norm(p.float(), p.shape[-1:], eps=1e-5) for p in pooled]
            stacked = torch.stack(pooled, dim=-1)  # [B, C, depth]
            weights = torch.softmax(self.layer_log_weights, dim=0).to(stacked.dtype)
            return torch.einsum("bcd,d->bc", stacked, weights)
        if cfg.use_mean_pooling:
            t = x[:, 1:].mean(dim=1)
            if self.fc_norm is None:  # remove_final_norm (run_class_finetuning.py:524-527)
                return t
            y = layer_norm(self.fc_norm, t)
            # without affine params the result keeps the input dtype, as
            # flax's LayerNorm does with nothing f32 to promote against
            return y if self.fc_norm.elementwise_affine else y.to(t.dtype)
        if self.norm is None:
            return x[:, 0]
        return layer_norm(self.norm, x)[:, 0]
