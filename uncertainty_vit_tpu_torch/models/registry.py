"""timm-style model factory: counterpart of uncertainty_vit_tpu/models/
registry.py (``create_model`` :43-81), over the reference's registry names
(modeling_finetune.py:1221-1275, modeling_cyclical.py:282-363,
modeling_pretrain.py:139-166).

``create_model(name, family=...)`` returns (module, config): the
``finetune`` family, the ``VisionTransformer`` with any of its heads
(``head_type=`` and the other config fields pass through as overrides), the
``cyclical`` family, ``CyclicalViT``, and the ``mim`` and ``joint``
families, ``MIMViT`` and ``JointViT`` over ``vocab_size`` codebook tokens,
each with ``head_type="none"`` (JAX :70-78). A dist_* name builds the
mean+covariance model in the finetune (``DistVisionTransformer``) and the
cyclical (``DistCyclicalViT``) family, as JAX :64-69 does.
``sngp_reset_cov`` (:84-95) restarts the SNGP head's precision matrix.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import torch

from uncertainty_vit_tpu_torch.core.config import PRESETS, ViTConfig, get_preset
from uncertainty_vit_tpu_torch.models.cyclical import CyclicalViT
from uncertainty_vit_tpu_torch.models.dist_vit import DistCyclicalViT, DistVisionTransformer
from uncertainty_vit_tpu_torch.models.heads import SNGPHead
from uncertainty_vit_tpu_torch.models.mim import JointViT, MIMViT
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer

MODEL_NAMES = (
    "beit_base_patch16_224", "beit_base_patch16_384",
    "beit_large_patch16_224", "beit_large_patch16_384",
    "beit_large_patch16_512", "beit_huge_patch16_224",
    "beit_base_patch16_224_8k_vocab", "beit_large_patch16_224_8k_vocab",
    "dist_beit_base_patch16_224",
    "beit_base_joint_patch16_224",
)

def preset_name(name: str) -> str:
    """The ``core.config`` preset of a registry name: the *_8k_vocab, joint
    and dist_* names are the architectures of beit_{size}_patch16_{res}."""
    if name in PRESETS:
        return name
    m = re.search(r"beit_(base|large|huge)_(?:joint_)?patch16_(\d+)", name)
    if not m:
        raise ValueError(f"unknown model name: {name}")
    return f"beit_{m.group(1)}_patch16_{m.group(2)}"


def _base_preset(name: str) -> ViTConfig:
    return get_preset(preset_name(name))


def create_model(
    name: str,
    family: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    vocab_size: int = 8192,
    *,
    device=None,
    generator: Optional[torch.Generator] = None,
    **overrides,
) -> Tuple[torch.nn.Module, ViTConfig]:
    """(module, config) of a registry name. ``family`` defaults by name:
    *_8k_vocab → mim, *_joint_* → joint, else finetune; dist_* names select
    the mean+covariance model of the finetune and cyclical families.
    ``device=None`` builds on the card."""
    is_dist = name.startswith("dist_")
    if family is None:
        if name.endswith("_8k_vocab"):
            family = "mim"
        elif "_joint_" in name:
            family = "joint"
        else:
            family = "finetune"
    if family not in ("finetune", "cyclical", "mim", "joint"):
        raise ValueError(f"unknown family: {family}")
    cfg = _base_preset(name)
    if overrides:
        cfg = cfg.replace(**overrides)
    if family == "cyclical":
        cfg = cfg.replace(head_type="none")
        cls = DistCyclicalViT if is_dist else CyclicalViT
        return cls(cfg, dtype, device=device, generator=generator), cfg
    if family in ("mim", "joint"):
        cfg = cfg.replace(head_type="none")
        cls = MIMViT if family == "mim" else JointViT
        return cls(cfg, dtype, vocab_size=vocab_size, device=device, generator=generator), cfg
    cls = DistVisionTransformer if is_dist else VisionTransformer
    return cls(cfg, dtype, device=device, generator=generator), cfg


def sngp_reset_cov(model: torch.nn.Module, ridge_penalty: float = 1e-3) -> torch.nn.Module:
    """Reset the GP precision matrix of every SNGP head in ``model`` to
    ridge·I (SNGP.reset_cov, modeling_finetune.py:596-597), in place; call
    between epochs under exact (momentum ≤ 0) accumulation. Returns the
    model."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, SNGPHead):
                p = module.precision_matrix
                p.copy_(ridge_penalty * torch.eye(p.shape[0], dtype=p.dtype, device=p.device))
    return model
