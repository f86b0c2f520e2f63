"""ViT backbone and the supervised/finetune model with the linear head.

Counterpart of uncertainty_vit_tpu/models/vit.py (``ViTBackbone`` :25-172,
``VisionTransformer`` :175-308), mirroring the reference's
modeling_finetune.py:367-523. ``VisionTransformer`` subclasses the backbone
so that its parameters sit at the top level under the reference's torch
names (``cls_token``, ``blocks.0.attn.qkv.weight``, ``fc_norm.weight``, ...),
which is where ``export_torch_state_dict`` of the JAX package puts them.

``cfg.has_masking`` registers the ``mask_token`` of on-the-fly token
masking (the reference's finetune masking, modeling_finetune.py:482-486):
``forward(..., bool_masked_pos=...)`` blends it into the masked patch
tokens in training; the evaluation ignores the mask.

``cfg.head_type`` picks the classifier (JAX :274-308): the linear head,
the SNGP head, the heteroscedastic MC-softmax head (``models/heads.py``) or
none (the pooled feature comes out); ``cfg.sngp_fc_norm`` puts the
spectral-norm ``SpectralNormDense`` in fc_norm's place under mean pooling
(JAX :254-261). ``cfg.attn_variant`` picks the blocks' attention (softmax,
gumbel, sinkformer with ``cfg.sinkformer_eps`` / ``sinkformer_iters``, or
dual_sto with ``cfg.dual_sto_n_centroids``; JAX :148-156); gumbel and
dual_sto draw from the forward's ``gumbel_generator`` on every forward
(``core.config.draws_gumbel``).
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
``token_parameters()`` over the group. The MC-dropout forward folds the
rank's rows K times; K8 draws each dropout mask's rows of the unsharded
forward (``layers.site_dropout``), so every rank's logits are the unsharded
model's given the same generator.

``mesh`` (a ``parallel.mesh.Mesh``; the JAX step's mesh with the param
specs of parallel/mesh.py:130-148) takes the place of ``seq_group``: its
seq axis splits the tokens as above, its model axis cuts every block
(``models.layers``) and the shared rel-pos table by heads, and its data
axis splits the batch: a forward draws its masks, and the heteroscedastic
head its noise, for the global batch and keeps this rank's rows (in each
copy of them in an MC-dropout batch, folded or split; K8 keys its masks on
those rows). A model under a model axis is built at its shard's shapes;
its weights come from the full state dict through
``parallel.mesh.shard_state_dict``. The SNGP head's precision update sums
over the data axis. ``quant="int8"`` on a data axis is one process's int8
trunk: each layer's gradient rounding draws the bits of the global batch's
rows and its wgrad column scales span the data × seq ranks, and a layer is
int8 where the global batch's trunk is (``layers._use_quant``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.core import init as I
from uncertainty_vit_tpu_torch.core.config import HEAD_TYPES, ViTConfig
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.models.heads import MCSoftmaxDenseFA, SNGPHead, SpectralNormDense
from uncertainty_vit_tpu_torch.models.layers import (
    Block, PatchEmbed, RelativePositionBias, _active, _local, _model_axis, _param, _Params,
    _query_rows, batch_shard, dropout, layer_norm,
)
from uncertainty_vit_tpu_torch.ops.losses import at_least_f32
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
from uncertainty_vit_tpu_torch.parallel import seq


class ViTBackbone(nn.Module):
    """Patch embed → [cls] + tokens (+ pos embed) → blocks.

    ``forward`` returns (x, layer_xs, fc_features): the final tokens and the
    per-layer block outputs / post-MLP residuals (learn_layer_weights and
    the cyclical teacher's targets read them). ``device=None`` builds on the
    current CUDA device.

    The JAX backbone's knobs (:35-40): ``has_mask_token`` (default
    ``cfg.has_masking``) registers the mask token; with
    ``mask_only_when_training`` (the finetune rule) a forward blends it in
    only where it draws, without it (the cyclical student) whenever it is
    given ``bool_masked_pos``; ``patch_embed_init`` is ``PatchEmbed``'s
    ``weight_init``.

    ``mc_samples > 0`` is the split-trunk MC-dropout forward (models/
    vit.py:56-61, 136-139, 170-171 of the reference): blocks [0, mc_split)
    run once without dropout, the batch is tiled K× and blocks [mc_split,
    depth) run with dropout. Exact MC-dropout when the shared blocks carry
    no dropout of their own (``cfg.dropout_from_block >= mc_split``)."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None,
                 seq_group: Optional[seq.SeqGroup] = None,
                 has_mask_token: Optional[bool] = None, mask_only_when_training: bool = True,
                 patch_embed_init="torch", mesh: Optional[meshlib.Mesh] = None):
        super().__init__()
        device = resolve_device(device)
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {cfg.quant!r}")
        if mesh is not None:
            if seq_group is not None:
                raise ValueError("pass a mesh or a seq_group, not both")
            seq_group = mesh.seq_group
        tp = _model_axis(mesh, cfg.quant)
        self.cfg, self.dtype, self.seq_group, self.mesh = cfg, dtype, seq_group, mesh
        self.mask_only_when_training = mask_only_when_training
        # this rank's token rows under a seq group
        self.seq_shard = None if seq_group is None else seq_group.shard(cfg.num_patches + 1)
        tn = I.trunc_normal(cfg.init_std, cfg.init_trunc_abs)
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, cfg.embed_dim, dtype,
                                      patch_embed_init, device=device, generator=generator)
        self.cls_token = _param((1, 1, cfg.embed_dim), tn, device, generator)
        self.pos_embed = (
            _param((1, cfg.num_patches + 1, cfg.embed_dim), tn, device, generator)
            if cfg.use_abs_pos_emb else None
        )
        self.pos_drop = cfg.drop_rate if cfg.dropout_from_block == 0 else 0.0
        heads = cfg.num_heads if tp is None else _local(cfg.num_heads, tp, "the head count")
        self.rel_pos_bias = (
            RelativePositionBias(cfg.grid_size, heads, device=device)
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
                seq_shard=self.seq_shard, sinkformer_eps=cfg.sinkformer_eps,
                sinkformer_iters=cfg.sinkformer_iters,
                dual_sto_n_centroids=cfg.dual_sto_n_centroids, mesh=mesh, device=device,
                generator=generator,
            )
            for i in range(cfg.depth)
        )
        # drawn after the blocks, so that the backbone's other parameters are
        # drawn as without masking; it acts on token rows (JAX
        # models/vit.py:91-92)
        if has_mask_token is None:
            has_mask_token = cfg.has_masking
        self.mask_token = (_param((1, 1, cfg.embed_dim), tn, device, generator)
                           if has_mask_token else None)
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
                bool_masked_pos: Optional[torch.Tensor] = None,
                gumbel_generator: Optional[torch.Generator] = None,
                ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
        with batch_shard(self.mesh, images.shape[0]):
            return self._trunk(images, generator, deterministic, mc_samples, mc_split,
                               bool_masked_pos, gumbel_generator)

    def _trunk(self, images, generator, deterministic, mc_samples, mc_split, bool_masked_pos,
               gumbel_generator):
        active = _active(self, deterministic)
        shard = self.seq_shard
        x = self.patch_embed(images.to(self.dtype))
        b, n, c = x.shape
        if (self.mask_token is not None and bool_masked_pos is not None
                and (active or not self.mask_only_when_training)):
            # masked patches become the mask token (w = 1): the finetune
            # model only in training, the cyclical student whenever it is
            # given a mask (mask_only_when_training, JAX models/vit.py:93-98)
            w = bool_masked_pos.reshape(b, n, 1).to(self.dtype)
            x = x * (1.0 - w) + self.mask_token.to(self.dtype) * w
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
            x, fc = blk(x, rel_pos_bias, generator, deterministic=block_deterministic,
                        gumbel_generator=gumbel_generator)
            layer_xs.append(x)
            fc_features.append(fc)
        if mc_samples > 0 and mc_split >= len(self.blocks):
            x = x.repeat(mc_samples, 1, 1)
        return x, layer_xs, fc_features


class VisionTransformer(ViTBackbone):
    """Supervised/finetune ViT (modeling_finetune.py:367-523): backbone →
    pooled feature → head (``cfg.head_type``). Images are NHWC; logits are
    float32."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None,
                 seq_group: Optional[seq.SeqGroup] = None,
                 mesh: Optional[meshlib.Mesh] = None):
        if cfg.head_type not in HEAD_TYPES:
            raise ValueError(f"unknown head_type: {cfg.head_type}")
        device = resolve_device(device)
        super().__init__(cfg, dtype, device=device, generator=generator, seq_group=seq_group,
                         mesh=mesh)
        c = cfg.embed_dim
        self.layer_log_weights = (
            _param((cfg.depth,), I.zeros, device, generator) if cfg.learn_layer_weights else None
        )
        final_norm = not cfg.learn_layer_weights and not cfg.remove_final_norm
        # mean pooling → fc_norm (no affine under linear_classifier,
        # modeling_finetune.py:412; spectral_norm(BertLinear) under --sngp,
        # :413-414); cls token → norm, then token 0 (:411, 517)
        self.fc_norm = None
        if final_norm and cfg.use_mean_pooling:
            self.fc_norm = (
                SpectralNormDense(c, c, dtype=dtype, device=device, generator=generator)
                if cfg.sngp_fc_norm else
                nn.LayerNorm(c, eps=cfg.layer_norm_eps,
                             elementwise_affine=not cfg.linear_classifier, device=device))
        self.norm = (
            nn.LayerNorm(c, eps=cfg.layer_norm_eps, device=device)
            if final_norm and not cfg.use_mean_pooling else None
        )
        self.head = None
        if cfg.head_type == "linear":
            self.head = _Params(
                (cfg.num_classes, c), I.scaled(I.trunc_normal(0.02, 2.0), cfg.init_scale),
                (cfg.num_classes,), device=device, generator=generator,
            )
        elif cfg.head_type == "sngp":
            self.head = SNGPHead(c, cfg.sngp_num_inducing or c, cfg.num_classes,
                                 momentum=cfg.sngp_momentum,
                                 ridge_penalty=cfg.sngp_ridge_penalty, device=device,
                                 generator=generator, mesh=mesh)
        elif cfg.head_type == "het":
            self.head = MCSoftmaxDenseFA(
                c, cfg.num_classes, num_factors=cfg.het_num_factors,
                temperature=cfg.het_temperature, train_mc_samples=cfg.het_train_mc_samples,
                test_mc_samples=cfg.het_test_mc_samples, device=device, generator=generator)

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None, mc_samples: int = 0, mc_split: int = 0,
                bool_masked_pos: Optional[torch.Tensor] = None, *,
                update_sngp_cov: bool = False, return_gp_cov: bool = False,
                return_features: bool = False, mc_generator: Optional[torch.Generator] = None,
                het_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                gumbel_generator: Optional[torch.Generator] = None,
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """images [B, H, W, C] → f32 logits [B, classes], or [K, B, classes]
        with ``mc_samples=K`` (the split-trunk MC-dropout forward, see
        ``ViTBackbone``). Every random draw (drop-path, dropout masks and
        seeds) comes from ``generator``, on the images' device; a forward
        draws in train mode, or as ``deterministic`` says when given.
        ``bool_masked_pos`` [B, num_patches] (1 = masked) applies where the
        forward draws, with ``cfg.has_masking``.

        The heads' options (JAX :188-227): ``update_sngp_cov`` updates the
        SNGP precision matrix, and the spectral fc_norm's (u, v) where the
        forward also draws; ``return_gp_cov`` returns (logits, GP
        covariance) from the SNGP head; ``return_features`` returns (logits,
        the pooled feature the head takes). The heteroscedastic head draws
        its noise from ``mc_generator`` (or takes ``het_noise``); it runs
        on its train sample count when ``update_sngp_cov`` is set, as the
        JAX model's ``training=update_sngp_cov`` does. The gumbel and
        dual_sto attentions draw their noise from ``gumbel_generator``."""
        cfg = self.cfg
        if mc_samples > 0:
            assert not cfg.learn_layer_weights, "mc split incompatible with layer weights"
            assert not return_features, "return_features incompatible with mc_samples"
        with batch_shard(self.mesh, images.shape[0]):
            feat = self.forward_features(images, generator, deterministic, mc_samples, mc_split,
                                         bool_masked_pos, update_sngp_cov=update_sngp_cov,
                                         gumbel_generator=gumbel_generator)
            out = self._head(feat, update_sngp_cov, return_gp_cov, mc_generator, het_noise)
        if return_features:
            return out, feat
        if mc_samples > 0:
            b = images.shape[0]
            if isinstance(out, tuple):
                return tuple(t.reshape(mc_samples, b, *t.shape[1:]) for t in out)
            return out.reshape(mc_samples, b, *out.shape[1:])
        return out

    def forward_features(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
                         deterministic: Optional[bool] = None, mc_samples: int = 0,
                         mc_split: int = 0, bool_masked_pos: Optional[torch.Tensor] = None, *,
                         update_sngp_cov: bool = False,
                         gumbel_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The pooled feature the head takes (what ``forward`` returns beside
        the logits with ``return_features``), without running the head."""
        x, layer_xs, _ = super().forward(images, generator, deterministic, mc_samples, mc_split,
                                         bool_masked_pos, gumbel_generator)
        return self._pool(x, layer_xs, update_sngp_cov and _active(self, deterministic))

    def _head(self, feat: torch.Tensor, update_sngp_cov: bool, return_gp_cov: bool,
              mc_generator: Optional[torch.Generator],
              het_noise: Optional[Tuple[torch.Tensor, torch.Tensor]]):
        head_type = self.cfg.head_type
        if head_type == "none":
            return feat
        if head_type == "linear":
            # f32 logits (float64 for a float64 copy of the model)
            return F.linear(feat.to(at_least_f32(feat.dtype)), self.head.weight, self.head.bias)
        if head_type == "sngp":
            return self.head(feat, update_cov=update_sngp_cov, return_gp_cov=return_gp_cov)
        return self.head(feat.float(), training=update_sngp_cov, generator=mc_generator,
                         noise=het_noise)

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

    def _pool(self, x: torch.Tensor, layer_xs: List[torch.Tensor],
              update_spectral: bool = False) -> torch.Tensor:
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
            if isinstance(self.fc_norm, SpectralNormDense):
                return self.fc_norm(t, update=update_spectral)
            y = layer_norm(self.fc_norm, t)
            # without affine params the result keeps the input dtype, as
            # flax's LayerNorm does with nothing f32 to promote against
            return y if self.fc_norm.elementwise_affine else y.to(t.dtype)
        if self.norm is None:
            return self._token0(x)
        # LayerNorm acts per token: norm(x)[:, 0] is norm(x[:, 0])
        return layer_norm(self.norm, self._token0(x))
