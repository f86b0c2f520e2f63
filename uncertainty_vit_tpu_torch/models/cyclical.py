"""The data2vec-style cyclical pretraining model (student and teacher alike).

Counterpart of uncertainty_vit_tpu/models/cyclical.py (``CyclicalViT``
:29-98), mirroring the reference's VisionTransformerForCyclicalTraining
(modeling_cyclical.py:33-225): masked patches are replaced by a learned
mask token, the teacher (an EMA copy run unmasked) gives its per-layer
activations, and the student regresses those targets at the masked
positions through ``lm_head``.

``CyclicalViT`` subclasses the backbone, so that its parameters sit under
the reference's names (``cls_token``, ``mask_token``, ``patch_embed.*``,
``rel_pos_bias.*``, ``blocks.*``, ``norm.*``, ``lm_head.*``). Its backbone
draws every weight from trunc_normal(0.02) bounded at ±0.02, the patch
embedding's too (modeling_cyclical.py:23-24, 158-161), and has a mask token
that applies whenever a mask is given. As in the JAX package, ``lm_head``
runs over all patch tokens and the loss does the masking (its documented
divergence from the reference's gather of the masked tokens, :219-225).

``mesh`` (a ``parallel.mesh.Mesh``; the JAX model's ``seq_mesh``, :42-67,
and the mesh's param specs) runs the backbone sharded as
``models.vit.ViTBackbone`` does. Under its seq axis a rank holds its token
rows of every output (the cls row only on the rank that holds token 0, and
stripped there), and every parameter acts on token rows
(``token_parameters``); the SNGP ``lm_head`` sums its precision update over
the data and seq axes.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch.nn as nn

import torch
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.core import init as I
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.models.heads import SNGPHead
from uncertainty_vit_tpu_torch.models.layers import _Params, layer_norm
from uncertainty_vit_tpu_torch.models.vit import ViTBackbone

LAYER_RESULTS = ("end", "fc")
INIT_STD = 0.02  # every weight's trunc_normal std and bound (modeling_cyclical.py:23-24)


class CyclicalViT(ViTBackbone):
    """Student / teacher ViT of the cyclical pretraining. ``gp_layer``: the
    student's ``lm_head`` is an SNGP head over the [B·N, C] patch tokens
    (modeling_cyclical.py:133), with ``num_inducing = num_classes =
    embed_dim``; else a linear layer at trunc_normal(0.02) bounded at ±0.02
    with a zero bias."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32, *,
                 gp_layer: bool = False, device=None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        device = resolve_device(device)
        cfg = cfg.replace(init_std=INIT_STD, init_trunc_abs=INIT_STD)
        super().__init__(cfg, dtype, device=device, generator=generator, has_mask_token=True,
                         mask_only_when_training=False,
                         patch_embed_init=("trunc", INIT_STD), mesh=mesh)
        c = cfg.embed_dim
        self.gp_layer = gp_layer
        self.norm = torch.nn.LayerNorm(c, eps=cfg.layer_norm_eps, device=device)
        if gp_layer:
            self.lm_head = SNGPHead(c, c, c, device=device, generator=generator, mesh=mesh,
                                    axes=("data", "seq"))
        else:
            self.lm_head = _Params((c, c), I.trunc_normal(INIT_STD, INIT_STD), (c,),
                                   device=device, generator=generator)

    def forward(self, images: torch.Tensor, bool_masked_pos: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None,
                deterministic: Optional[bool] = None, layer_results: Optional[str] = None,
                update_sngp_cov: bool = False,
                gumbel_generator: Optional[torch.Generator] = None,
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """images [B, H, W, C]; ``bool_masked_pos`` [B, num_patches] (1 =
        masked) blends in the mask token. ``layer_results`` "end" (the
        blocks' outputs) or "fc" (their post-MLP residuals) returns the
        per-layer activations without the cls token, in the compute dtype,
        and no final norm (the teacher's call, modeling_cyclical.py:209-214);
        else ``lm_head`` over the normed patch tokens, [B, N, C]. Every
        draw (drop-path, dropout, attention dropout) comes from
        ``generator`` where the forward draws. ``update_sngp_cov`` updates
        the SNGP head's precision matrix. The gumbel and dual_sto attentions
        draw from ``gumbel_generator``."""
        if layer_results is not None and layer_results not in LAYER_RESULTS:
            raise ValueError(f"layer_results must be one of {LAYER_RESULTS}, got {layer_results!r}")
        x, layer_xs, fc_features = super().forward(images, generator, deterministic,
                                                   bool_masked_pos=bool_masked_pos,
                                                   gumbel_generator=gumbel_generator)
        if layer_results is not None:
            zs = layer_xs if layer_results == "end" else fc_features
            return [self._patch_rows(z) for z in zs]
        x = self._patch_rows(layer_norm(self.norm, x))
        if self.gp_layer:
            b, n, c = x.shape
            return self.lm_head(x.reshape(b * n, c), update_cov=update_sngp_cov).reshape(b, n, -1)
        return F.linear(x.to(self.dtype), self.lm_head.weight.to(self.dtype),
                        self.lm_head.bias.to(self.dtype))

    def _patch_rows(self, z: torch.Tensor) -> torch.Tensor:
        """The patch tokens of z: without the cls row, which under a seq
        group only the rank holding token 0 has."""
        shard = self.seq_shard
        return z[:, 1:] if shard is None or shard.start == 0 else z

    def token_parameters(self) -> List[nn.Parameter]:
        """Every parameter: the norm and lm_head act on token rows too."""
        return list(self.parameters())
