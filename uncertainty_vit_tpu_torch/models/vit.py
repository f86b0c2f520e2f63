"""ViT backbone and the supervised/finetune model with the linear head.

Counterpart of uncertainty_vit_tpu/models/vit.py (``ViTBackbone`` :25-172,
``VisionTransformer`` :175-308), mirroring the reference's
modeling_finetune.py:367-523. ``VisionTransformer`` subclasses the backbone
so that its parameters sit at the top level under the reference's torch
names (``cls_token``, ``blocks.0.attn.qkv.weight``, ``fc_norm.weight``, ...),
which is where ``export_torch_state_dict`` of the JAX package puts them.

Not ported yet (they raise): the SNGP and heteroscedastic heads, the
spectral-norm fc_norm, attention variants other than softmax and masking.
``cfg.quant="int8"`` runs the trunk's dense layers through
``ops.quant.int8_dense`` on [B, N, C] activations; the reference's flat
[B·N, C] trunk (models/vit.py:118-135) works around layout copies of its
compiler and computes the same.

``seq_group`` (a ``parallel.seq.SeqGroup``; the reference's ``seq_mesh``,
:41-45, 73-87, 184-185) splits the tokens over the ranks of a group: each
rank embeds the whole image, keeps its token rows ``seq_group.rows(N)`` and
runs the blocks on them (the attention gathers k/v over the group); the
pooling sums over the group, and the head runs on every rank alike, so the
logits come out equal on every rank. The train step sums the gradients of
``token_parameters()`` over the group.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.core import init as I
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.models.layers import (
    Block, PatchEmbed, RelativePositionBias, _active, _param, _Params, _query_rows, dropout,
    layer_norm,
)
from uncertainty_vit_tpu_torch.parallel import seq


class ViTBackbone(nn.Module):
    """Patch embed → [cls] + tokens (+ pos embed) → blocks.

    ``forward`` returns (x, layer_xs, fc_features): the final tokens and the
    per-layer block outputs / post-MLP residuals (learn_layer_weights reads
    the former). ``device=None`` builds on the current CUDA device.

    ``mc_samples > 0`` is the split-trunk MC-dropout forward (models/
    vit.py:56-61, 136-139, 170-171 of the reference): blocks [0, mc_split)
    run once without dropout, the batch is tiled K× and blocks [mc_split,
    depth) run with dropout. Exact MC-dropout when the shared blocks carry
    no dropout of their own (``cfg.dropout_from_block >= mc_split``)."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None,
                 seq_group: Optional[seq.SeqGroup] = None):
        super().__init__()
        device = resolve_device(device)
        if cfg.has_masking:
            raise NotImplementedError("token masking is not ported yet")
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {cfg.quant!r}")
        self.cfg, self.dtype, self.seq_group = cfg, dtype, seq_group
        # this rank's token rows under a seq group
        self.seq_shard = None if seq_group is None else seq_group.shard(cfg.num_patches + 1)
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
                use_flash=cfg.use_flash_attention, dtype=dtype, quant=cfg.quant,
                seq_shard=self.seq_shard, device=device, generator=generator,
            )
            for i in range(cfg.depth)
        )
        # every parameter registered so far acts on token rows; those a
        # subclass adds after this (the pooled feature's norm, the head) do not
        self._token_names = frozenset(name for name, _ in self.named_parameters())

    def token_parameters(self) -> List[nn.Parameter]:
        """The parameters the backbone registers (embedding, rel-pos tables,
        blocks), used before the pooling. Under a seq group each rank's
        gradient of them covers only its token rows; those of the norm and
        head after the pooling are whole on every rank."""
        return [p for name, p in self.named_parameters() if name in self._token_names]

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None, mc_samples: int = 0, mc_split: int = 0,
                ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
        active = _active(self, deterministic)
        shard = self.seq_shard
        if shard is not None and mc_samples > 0:
            raise NotImplementedError("MC-dropout under a seq group is not ported yet")
        x = self.patch_embed(images.to(self.dtype))
        b, _, c = x.shape
        x = torch.cat([self.cls_token.to(self.dtype).expand(b, 1, c), x], dim=1)
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(self.dtype)
        x = dropout(x, self.pos_drop, active, generator)
        if shard is not None:  # this rank's token rows
            x = x[:, shard.start:shard.stop].contiguous()
        # the shared bias of this rank's query rows: one tensor for every block
        rel_pos_bias = (self.rel_pos_bias(_query_rows(shard)) if self.rel_pos_bias is not None
                        else None)
        layer_xs: List[torch.Tensor] = []
        fc_features: List[torch.Tensor] = []
        for i, blk in enumerate(self.blocks):
            if mc_samples > 0 and i == mc_split:
                x = x.repeat(mc_samples, 1, 1)
            block_deterministic = not active if mc_samples == 0 else i < mc_split
            x, fc = blk(x, rel_pos_bias, generator, deterministic=block_deterministic)
            layer_xs.append(x)
            fc_features.append(fc)
        if mc_samples > 0 and mc_split >= len(self.blocks):
            x = x.repeat(mc_samples, 1, 1)
        return x, layer_xs, fc_features


class VisionTransformer(ViTBackbone):
    """Supervised/finetune ViT (modeling_finetune.py:367-523): backbone →
    pooled feature → linear head. Images are NHWC; logits are float32."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None,
                 seq_group: Optional[seq.SeqGroup] = None):
        if cfg.head_type != "linear" or cfg.sngp_fc_norm:
            raise NotImplementedError("only the linear head is ported yet")
        device = resolve_device(device)
        super().__init__(cfg, dtype, device=device, generator=generator, seq_group=seq_group)
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

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None, mc_samples: int = 0, mc_split: int = 0,
                ) -> torch.Tensor:
        """images [B, H, W, C] → f32 logits [B, classes], or [K, B, classes]
        with ``mc_samples=K`` (the split-trunk MC-dropout forward, see
        ``ViTBackbone``). Every random draw (drop-path, dropout masks and
        seeds) comes from ``generator``, on the images' device; a forward
        draws in train mode, or as ``deterministic`` says when given."""
        if mc_samples > 0:
            assert not self.cfg.learn_layer_weights, "mc split incompatible with layer weights"
        x, layer_xs, _ = super().forward(images, generator, deterministic, mc_samples, mc_split)
        feat = self._pool(x, layer_xs)
        logits = F.linear(feat.float(), self.head.weight, self.head.bias)
        if mc_samples > 0:
            logits = logits.reshape(mc_samples, images.shape[0], -1)
        return logits

    def _patch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of the patch tokens (all but token 0). Under a seq group:
        the f32 sum of this rank's patch rows, summed over the group, over
        N − 1, in x's dtype."""
        shard = self.seq_shard
        if shard is None:
            return x[:, 1:].mean(dim=1)
        rows = x[:, 1:] if shard.start == 0 else x
        total = seq.all_reduce_sum(rows.sum(dim=1, dtype=torch.float32), shard.group)
        return (total / (shard.n - 1)).to(x.dtype)

    def _token0(self, x: torch.Tensor) -> torch.Tensor:
        """Token 0 (cls): rank 0's, handed to every rank of a seq group."""
        shard = self.seq_shard
        if shard is None:
            return x[:, 0]
        # elsewhere the sum of no rows: zero, but a function of x, so that every
        # rank's backward runs through its blocks and meets the same collectives
        t = x[:, :1 if shard.start == 0 else 0].sum(dim=1, dtype=torch.float32)
        return seq.all_reduce_sum(t, shard.group).to(x.dtype)

    def _pool(self, x: torch.Tensor, layer_xs: List[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        if cfg.learn_layer_weights:
            # softmax-weighted combination of per-layer pooled features
            # (modeling_finetune.py:499-510)
            pooled = [self._patch_mean(lx) if cfg.use_mean_pooling else self._token0(lx)
                      for lx in layer_xs]
            if cfg.layernorm_before_combine:
                pooled = [F.layer_norm(p.float(), p.shape[-1:], eps=1e-5) for p in pooled]
            stacked = torch.stack(pooled, dim=-1)  # [B, C, depth]
            weights = torch.softmax(self.layer_log_weights, dim=0).to(stacked.dtype)
            return torch.einsum("bcd,d->bc", stacked, weights)
        if cfg.use_mean_pooling:
            t = self._patch_mean(x)
            if self.fc_norm is None:  # remove_final_norm (run_class_finetuning.py:524-527)
                return t
            y = layer_norm(self.fc_norm, t)
            # without affine params the result keeps the input dtype, as
            # flax's LayerNorm does with nothing f32 to promote against
            return y if self.fc_norm.elementwise_affine else y.to(t.dtype)
        if self.norm is None:
            return self._token0(x)
        # LayerNorm acts per token: norm(x)[:, 0] is norm(x[:, 0])
        return layer_norm(self.norm, self._token0(x))
