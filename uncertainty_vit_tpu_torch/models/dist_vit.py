"""The stochastic "dist" mean+covariance transformer.

Counterpart of uncertainty_vit_tpu/models/dist_vit.py (``DistAttention``
:35-110, ``DistBlock`` :113-177, ``_DistBackbone`` :180-243,
``DistVisionTransformer`` :246-278, ``DistCyclicalViT`` :281-314), mirroring
the reference's modeling_finetune_dist.py and modeling_cyclical_dist.py: two
token streams (mean, cov) run through attention whose logits are the
sigmoid-squashed negative 2-Wasserstein distance between (q, cov_q) and
(k, cov_k); the cov stream is rectified as ELU(·) + 1 and attends with the
squared attention weights. The two streams share the qkv weight, the norms
and the MLP; each has its own q / v biases, projection, patch embedding and
cls token.

It runs no kernel of the port: the attention is plain torch (its distance's
two products in float32, ``ops.losses.wasserstein_distance_matmul``), the
MLP takes no int8 layer and its dropout is a draw, as in the JAX package
(its ``_dropout`` reaches the fused kernel only under the MC-dropout
switch, which no dist path sets).

The trunk's modules sit at the top level under the reference's names
(``patch_embed``, ``cov_patch_embed``, ``cls_token``, ``cov_cls_token``,
``mask_token``, ``cov_mask_token``, ``rel_pos_bias``, ``blocks.{i}``), where
``utils.checkpoint`` puts the JAX package's ``backbone`` subtree and where
``train.optim.vit_layer_id`` reads a parameter's layer from its first name.
Every draw (drop-path, dropout) comes from the forward's ``generator``.
The attention's logits, the norms and the logits compute in float32, as
the JAX modules do, or in float64 for a model built with dtype float64 and
its parameters in float64 (``model.double()``: a reference copy, which the
card's smoke run holds a train step against).

Under a ``parallel.mesh.Mesh`` (``mesh``) the model takes its data and
model axes (the JAX driver refuses a seq axis for it, cli/finetune.py:
193-195; the ranks of a seq axis hold replicas): the batch is split over
data, each forward drawing its masks for the global batch, and the model
axis cuts ``DistAttention`` by heads (qkv, the four q / v biases and the
rel-pos tables; proj and cov_proj row-parallel, their bias after the sum)
and the shared MLP as ``models.layers.Mlp``. Training attention dropout
under a model axis raises, as the ViT's does.

The reference's quirks the JAX package handles are kept: drop-path on both
streams in both layer-scale branches (modeling_finetune_dist.py:48 names a
missing ``drop_cov``), the rel-pos bias added only where there is one
(:155), and the unused ``cov_qkv`` weight kept as a parameter (:76, 127).
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
    Mlp, PatchEmbed, RelativePositionBias, _active, _fix_init, _local, _model_axis, _param,
    _Params, batch_shard, drop_path, dropout, layer_norm,
)
from uncertainty_vit_tpu_torch.ops.losses import at_least_f32, wasserstein_distance_matmul
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib

LAYER_RESULTS = ("end",)


class DistAttention(nn.Module):
    """Wasserstein-kernel attention over the (mean, cov) streams
    (modeling_finetune_dist.py:61-179): one qkv weight for both streams and
    q / v biases of each; the cov stream's qkv is ELU(·) + 1; the logits
    −W2(q·scale, cov_q; k, cov_k) in float32, then a sigmoid, the rel-pos
    bias, the softmax and attention dropout, cast to the compute dtype;
    mean = attn·v and cov = attn²·cov_v, then ``proj`` and ``cov_proj``,
    each followed by its own dropout draw."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, layer_id: int = 0, init_std: float = 0.02,
                 dtype: torch.dtype = torch.float32, *, mesh=None, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        head_dim = dim // num_heads
        self.tp = _model_axis(mesh)
        if self.tp is not None:
            num_heads = _local(num_heads, self.tp, "the head count")
        all_head = head_dim * num_heads
        self.num_heads, self.head_dim, self.dtype = num_heads, head_dim, dtype
        self.scale = qk_scale or head_dim**-0.5
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        tn = I.trunc_normal(init_std, 2.0)
        self.qkv = _Params((all_head * 3, dim), tn, device=device, generator=generator)
        # a parameter of the reference (:76) that its forward never reads (:127)
        self.cov_qkv = _Params((all_head * 3, dim), tn, device=device, generator=generator)
        if qkv_bias:
            self.q_bias = _param((all_head,), I.zeros, device, generator)
            self.v_bias = _param((all_head,), I.zeros, device, generator)
            self.cov_q_bias = _param((all_head,), I.zeros, device, generator)
            self.cov_v_bias = _param((all_head,), I.zeros, device, generator)
        else:
            self.q_bias = self.v_bias = self.cov_q_bias = self.cov_v_bias = None
        proj_init = _fix_init(tn, layer_id)
        self.proj = _Params((dim, all_head), proj_init, (dim,), device=device,
                            generator=generator)
        self.cov_proj = _Params((dim, all_head), proj_init, (dim,), device=device,
                                generator=generator)

    def _project(self, x: torch.Tensor, q_bias: Optional[torch.Tensor],
                 v_bias: Optional[torch.Tensor]) -> torch.Tensor:
        bias = None if q_bias is None else torch.cat([q_bias, torch.zeros_like(v_bias), v_bias])
        return F.linear(x, self.qkv.weight.to(self.dtype),
                        None if bias is None else bias.to(self.dtype))

    def _out(self, layer: _Params, x: torch.Tensor) -> torch.Tensor:
        """proj / cov_proj: under a model axis the partial products summed
        over it, then the bias."""
        if self.tp is None:
            return F.linear(x, layer.weight.to(self.dtype), layer.bias.to(self.dtype))
        y = meshlib.reduce_from_model(F.linear(x, layer.weight.to(self.dtype)), self.tp)
        return y + layer.bias.to(self.dtype)

    def forward(self, x: torch.Tensor, cov_x: torch.Tensor,
                rel_pos_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        active = _active(self, deterministic)
        b, n, _ = x.shape
        if self.tp is not None:
            if active and self.attn_drop > 0.0:
                raise NotImplementedError("attention dropout in training under a model axis is "
                                          "not ported (ROADMAP.md item 21)")
            x, cov_x = meshlib.copy_to_model(x, self.tp), meshlib.copy_to_model(cov_x, self.tp)
        qkv = self._project(x, self.q_bias, self.v_bias)
        cov_qkv = F.elu(self._project(cov_x, self.cov_q_bias, self.cov_v_bias)) + 1.0

        def heads(t):  # [B, N, 3·H·D] → 3 × [B, H, N, D]
            return t.reshape(b, n, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)

        q, k, v = heads(qkv)
        cov_q, cov_k, cov_v = heads(cov_qkv)
        q = q * self.scale
        acc = at_least_f32(self.dtype)
        attn = -wasserstein_distance_matmul(q.to(acc), cov_q.to(acc), k.to(acc), cov_k.to(acc))
        attn = torch.sigmoid(attn + 1e-24)
        if rel_pos_bias is not None:
            attn = attn + rel_pos_bias.to(acc)
        attn = torch.softmax(attn, dim=-1)
        attn = dropout(attn, self.attn_drop, active, generator).to(self.dtype)
        mean = (attn @ v).transpose(1, 2).reshape(b, n, -1)
        cov = ((attn**2) @ cov_v).transpose(1, 2).reshape(b, n, -1)
        mean, cov = self._out(self.proj, mean), self._out(self.cov_proj, cov)
        return (dropout(mean, self.proj_drop, active, generator),
                dropout(cov, self.proj_drop, active, generator))


class DistBlock(nn.Module):
    """Pre-norm block over both streams with the norms and the MLP shared
    (modeling_finetune_dist.py:15-59); layer scale γ multiplies the
    attention's and the MLP's outputs, and each use of drop-path draws its
    own per-sample mask."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path_rate: float = 0.0, init_values: Optional[float] = None,
                 layer_id: int = 1, init_std: float = 0.02, layer_norm_eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, *, mesh=None, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.drop_path_rate = dtype, drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.attn = DistAttention(dim, num_heads, qkv_bias, qk_scale, attn_drop, drop, layer_id,
                                  init_std, dtype, mesh=mesh, device=device, generator=generator)
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop=drop, layer_id=layer_id,
                       init_std=init_std, dtype=dtype, mesh=mesh, device=device,
                       generator=generator)
        if init_values is not None and init_values > 0:
            self.gamma_1 = _param((dim,), I.constant(init_values), device, generator)
            self.gamma_2 = _param((dim,), I.constant(init_values), device, generator)
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x_mean: torch.Tensor, x_cov: torch.Tensor,
                rel_pos_bias: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        active = _active(self, deterministic)
        mean, cov = self.attn(layer_norm(self.norm1, x_mean).to(self.dtype),
                              layer_norm(self.norm1, x_cov).to(self.dtype), rel_pos_bias,
                              generator, deterministic=not active)

        def dp(h):
            return drop_path(h, self.drop_path_rate, active, generator)

        def mlp(x):
            return self.mlp(layer_norm(self.norm2, x).to(self.dtype), generator=generator,
                            deterministic=not active)

        def scaled(gamma, h):
            return h if gamma is None else gamma.to(self.dtype) * h

        x_mean = x_mean + dp(scaled(self.gamma_1, mean))
        fc_mean = dp(scaled(self.gamma_2, mlp(x_mean)))
        x_cov = x_cov + dp(scaled(self.gamma_1, cov))
        fc_cov = dp(scaled(self.gamma_2, mlp(x_cov)))
        return x_mean + fc_mean, x_cov + fc_cov


class _DistBackbone(nn.Module):
    """The shared trunk (JAX :180-243): two patch embeddings, two cls tokens
    (and two mask tokens with ``has_mask_tokens``), no absolute position
    embedding, the shared rel-pos bias where the config has it, the
    ``DistBlock`` s. A subclass adds its norms and heads after it."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype, has_mask_tokens: bool, *,
                 device=None, generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.dtype, self.mesh = cfg, dtype, mesh
        tp = _model_axis(mesh)
        c = cfg.embed_dim
        tn = I.trunc_normal(0.02, 2.0)
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, c, dtype, device=device,
                                      generator=generator)
        self.cov_patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, c, dtype, device=device,
                                          generator=generator)
        self.cls_token = _param((1, 1, c), tn, device, generator)
        self.cov_cls_token = _param((1, 1, c), tn, device, generator)
        if has_mask_tokens:
            self.mask_token = _param((1, 1, c), tn, device, generator)
            self.cov_mask_token = _param((1, 1, c), tn, device, generator)
        else:
            self.mask_token = self.cov_mask_token = None
        heads = cfg.num_heads if tp is None else _local(cfg.num_heads, tp, "the head count")
        self.rel_pos_bias = (RelativePositionBias(cfg.grid_size, heads, device=device)
                             if cfg.use_shared_rel_pos_bias else None)
        dpr = np.linspace(0, cfg.drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(
            DistBlock(c, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias, cfg.qk_scale,
                      drop=cfg.drop_rate, attn_drop=cfg.attn_drop_rate,
                      drop_path_rate=float(dpr[i]), init_values=cfg.init_values, layer_id=i + 1,
                      layer_norm_eps=cfg.layer_norm_eps, dtype=dtype, mesh=mesh, device=device,
                      generator=generator)
            for i in range(cfg.depth))

    def trunk(self, images: torch.Tensor, bool_masked_pos: Optional[torch.Tensor],
              generator: Optional[torch.Generator], active: bool, collect_layers: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
        """(mean tokens, cov tokens, and with ``collect_layers`` every
        block's mean and cov outputs) of images [B, H, W, C]; the mask
        tokens blend into the patches ``bool_masked_pos`` marks whenever the
        model has them and a mask is given."""
        with batch_shard(self.mesh, images.shape[0]):
            return self._trunk(images, bool_masked_pos, generator, active, collect_layers)

    def _trunk(self, images, bool_masked_pos, generator, active, collect_layers):
        images = images.to(self.dtype)
        mean_x = self.patch_embed(images)
        cov_x = self.cov_patch_embed(images)
        b, n, c = mean_x.shape
        if self.mask_token is not None and bool_masked_pos is not None:
            w = bool_masked_pos.reshape(b, n, 1).to(self.dtype)
            mean_x = mean_x * (1 - w) + self.mask_token.to(self.dtype) * w
            cov_x = cov_x * (1 - w) + self.cov_mask_token.to(self.dtype) * w
        mean_x = torch.cat([self.cls_token.to(self.dtype).expand(b, 1, c), mean_x], dim=1)
        cov_x = torch.cat([self.cov_cls_token.to(self.dtype).expand(b, 1, c), cov_x], dim=1)
        mean_x = dropout(mean_x, self.cfg.drop_rate, active, generator)
        cov_x = dropout(cov_x, self.cfg.drop_rate, active, generator)
        rel_pos_bias = self.rel_pos_bias() if self.rel_pos_bias is not None else None
        mean_z: List[torch.Tensor] = []
        cov_z: List[torch.Tensor] = []
        for blk in self.blocks:
            mean_x, cov_x = blk(mean_x, cov_x, rel_pos_bias, generator, deterministic=not active)
            if collect_layers:
                mean_z.append(mean_x)
                cov_z.append(cov_x)
        return mean_x, cov_x, mean_z, cov_z


class DistVisionTransformer(_DistBackbone):
    """The finetune dist ViT (modeling_finetune_dist.py:181-326): both
    streams pooled through the shared ``fc_norm`` (mean pooling; no affine
    under ``linear_classifier``) or ``norm`` at the cls token, the mean's
    pooled feature classified by ``head``. ``forward`` returns (mean
    pooled, cov pooled, f32 logits)."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        device = resolve_device(device)
        super().__init__(cfg, dtype, has_mask_tokens=False, device=device, generator=generator,
                         mesh=mesh)
        c = cfg.embed_dim
        self.fc_norm = self.norm = None
        if cfg.use_mean_pooling:
            self.fc_norm = nn.LayerNorm(c, eps=cfg.layer_norm_eps,
                                        elementwise_affine=not cfg.linear_classifier,
                                        device=device)
        else:
            self.norm = nn.LayerNorm(c, eps=cfg.layer_norm_eps, device=device)
        self.head = _Params((cfg.num_classes, c), I.trunc_normal(0.02, 2.0), (cfg.num_classes,),
                            device=device, generator=generator)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.fc_norm is None:
            return layer_norm(self.norm, x[:, 0])
        t = x[:, 1:].mean(dim=1)
        y = layer_norm(self.fc_norm, t)
        # without affine parameters the result keeps the input's dtype, as
        # flax's LayerNorm does with nothing f32 to promote against
        return y if self.fc_norm.elementwise_affine else y.to(t.dtype)

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """images [B, H, W, C] → (mean pooled, cov pooled, logits [B,
        classes] f32); a forward draws in train mode, or as
        ``deterministic`` says, from ``generator``."""
        mean_x, cov_x, _, _ = self.trunk(images, None, generator, _active(self, deterministic))
        mean_pooled, cov_pooled = self._pool(mean_x), self._pool(cov_x)
        logits = F.linear(mean_pooled.to(self.head.weight.dtype), self.head.weight, self.head.bias)
        return mean_pooled, cov_pooled, logits


class DistCyclicalViT(_DistBackbone):
    """The pretraining dist ViT (modeling_cyclical_dist.py:14-166), in
    ``CyclicalViT``'s call modes: the teacher's ``layer_results="end"``
    gives every block's mean and cov outputs without the cls token; else
    the student's ``norm`` then ``lm_head`` / ``cov_lm_head`` over all patch
    tokens (the loss does the masking, the JAX package's documented
    divergence from the reference's gather). There are no post-MLP
    residuals to return ("fc" raises; the JAX model returns the block
    outputs for it)."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32, *, device=None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        device = resolve_device(device)
        super().__init__(cfg, dtype, has_mask_tokens=True, device=device, generator=generator,
                         mesh=mesh)
        c = cfg.embed_dim
        tn = I.trunc_normal(0.02, 2.0)
        self.norm = nn.LayerNorm(c, eps=cfg.layer_norm_eps, device=device)
        self.lm_head = _Params((c, c), tn, (c,), device=device, generator=generator)
        self.cov_lm_head = _Params((c, c), tn, (c,), device=device, generator=generator)

    def forward(self, images: torch.Tensor, bool_masked_pos: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None, layer_results: Optional[str] = None):
        """images [B, H, W, C]; ``bool_masked_pos`` [B, num_patches] (1 =
        masked) blends in the mask tokens. ``layer_results="end"``: (mean
        layers, cov layers), each [B, N, C] in the compute dtype; else
        (mean, cov) of the two heads, [B, N, C]."""
        if layer_results is not None and layer_results not in LAYER_RESULTS:
            raise ValueError(f"the dist model's layer_results must be one of {LAYER_RESULTS}, "
                             f"got {layer_results!r}: it keeps no post-MLP residuals")
        mean_x, cov_x, mean_z, cov_z = self.trunk(images, bool_masked_pos, generator,
                                                  _active(self, deterministic),
                                                  collect_layers=layer_results is not None)
        if layer_results is not None:
            return [z[:, 1:] for z in mean_z], [z[:, 1:] for z in cov_z]

        def head(lin, x):
            x = layer_norm(self.norm, x)[:, 1:].to(self.dtype)
            return F.linear(x, lin.weight.to(self.dtype), lin.bias.to(self.dtype))

        return head(self.lm_head, mean_x), head(self.cov_lm_head, cov_x)
