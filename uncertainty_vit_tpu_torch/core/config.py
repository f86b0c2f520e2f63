"""Model / training configuration dataclasses.

A copy of uncertainty_vit_tpu/core/config.py, so that both packages are
driven by the same typed, hashable config tree (the reference's per-driver
argparse sprawl, run_cyclical.py:36-284, run_class_finetuning.py:49-259).
Fields the PyTorch port does not implement yet raise where a model reads
them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

HEAD_TYPES = ("linear", "sngp", "het", "none")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Canonical ViT configuration.

    One config drives every model family in the reference zoo
    (modeling_finetune.py:367-523, modeling_cyclical.py:33-225,
    modeling_pretrain.py:32-136): the finetune backbone, the cyclical
    (data2vec) student/teacher, and the BEiT MIM pretrainer are all thin
    wrappers over the same backbone.
    """

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None

    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    # First block index where drop_rate/attn_drop_rate are active; blocks
    # below it (and pos_drop when > 0) carry NO dropout. With
    # dropout_from_block == s, split-trunk MC-dropout at mc_split == s is
    # EXACT full MC-dropout (the shared trunk is deterministic by
    # construction) — the configuration that meets the K=8 ≤ 4× target
    # honestly. 0 (default) = reference behavior, dropout everywhere.
    dropout_from_block: int = 0

    # Layer scale (modeling_finetune.py:284-288). None/0 disables.
    init_values: Optional[float] = None

    use_abs_pos_emb: bool = True
    # Per-block relative position bias tables (modeling_finetune.py:106-134).
    use_rel_pos_bias: bool = False
    # One table shared across blocks (modeling_finetune.py:328-364).
    use_shared_rel_pos_bias: bool = False

    use_mean_pooling: bool = True
    init_scale: float = 0.001
    # `linear_classifier` drops the affine params of fc_norm
    # (modeling_finetune.py:412); the CLI additionally freezes imported
    # params (run_class_finetuning.py:529-538).
    linear_classifier: bool = False
    # replace final norm/fc_norm with identity (run_class_finetuning.py:524-527)
    remove_final_norm: bool = False
    # Learnable mask token for on-the-fly masking during finetune
    # (modeling_finetune.py:387-388).
    has_masking: bool = False

    # Softmax-weighted combination of per-layer pooled features
    # (modeling_finetune.py:433-436, 499-510).
    learn_layer_weights: bool = False
    layernorm_before_combine: bool = False

    # Attention variant: 'softmax' | 'gumbel' | 'sinkformer' | 'dual_sto'
    # (modeling_finetune.py:169-181, 191-260).
    attn_variant: str = "softmax"
    sinkformer_eps: float = 1.0
    sinkformer_iters: int = 3
    dual_sto_n_centroids: int = 2

    # Classifier head: 'linear' | 'sngp' | 'het' | 'none'
    # (modeling_finetune.py:413-421). Note the reference has a bug where the
    # linear head always overwrites the SNGP head unless het_layer is set;
    # we implement the *intended* behavior and note the divergence.
    head_type: str = "linear"
    # Spectral-norm the fc_norm BertLinear as in `--sngp`
    # (modeling_finetune.py:413-414).
    sngp_fc_norm: bool = False

    layer_norm_eps: float = 1e-6
    init_std: float = 0.02
    # trunc_normal_ absolute truncation bounds: the finetune zoo uses
    # timm's default (±2.0 absolute, i.e. effectively untruncated for
    # std=0.02); the cyclical zoo truncates at ±std
    # (modeling_cyclical.py:23-24).
    init_trunc_abs: float = 2.0

    # SNGP head hyperparameters (modeling_finetune.py:525-567).
    sngp_num_inducing: Optional[int] = None  # default: embed_dim
    sngp_momentum: float = 0.999
    sngp_ridge_penalty: float = 1e-3

    # Het (MCSoftmaxDenseFA) head hyperparameters
    # (modeling_finetune.py:1220-1260 area; Collier et al. 2021).
    het_num_factors: int = 50
    het_temperature: float = 1.0
    het_train_mc_samples: int = 1000
    het_test_mc_samples: int = 1000

    # Use the fused attention kernel (ops/flash_attention.py).
    use_flash_attention: bool = True

    # Quantized trunk matmuls: 'none' | 'int8' (AQT-style dynamic int8 for
    # qkv/proj/fc1/fc2 — fwd, dgrad and wgrad all run on the int8 tensor
    # cores; see uncertainty_vit_tpu_torch/ops/quant.py). No reference
    # counterpart (its fastest mode was DeepSpeed fp16,
    # run_class_finetuning.py:583-594).
    quant: str = "none"

    @property
    def grid_size(self) -> Tuple[int, int]:
        return (self.img_size // self.patch_size, self.img_size // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid_size
        return gh * gw

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def replace(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Model zoo presets mirroring the timm registry names
# (modeling_finetune.py:1221-1275, modeling_cyclical.py:282-363,
#  modeling_pretrain.py:139-166).
# ---------------------------------------------------------------------------

def vit_base() -> ViTConfig:
    return ViTConfig(embed_dim=768, depth=12, num_heads=12)


def vit_large(img_size: int = 224) -> ViTConfig:
    return ViTConfig(img_size=img_size, embed_dim=1024, depth=24, num_heads=16)


def vit_huge() -> ViTConfig:
    return ViTConfig(embed_dim=1280, depth=32, num_heads=16)


PRESETS = {
    # tiny preset for smoke/integration tests (CPU-friendly)
    "beit_test_patch16_32": ViTConfig(
        img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2,
        use_flash_attention=False,
    ),
    "beit_base_patch16_224": vit_base(),
    "beit_base_patch16_384": vit_base().replace(img_size=384),
    "beit_large_patch16_224": vit_large(224),
    "beit_large_patch16_384": vit_large(384),
    "beit_large_patch16_512": vit_large(512),
    "beit_huge_patch16_224": vit_huge(),
}


# the attention variants that draw Gumbel noise in every forward
GUMBEL_VARIANTS = ("gumbel", "dual_sto")


def draws_gumbel(cfg) -> bool:
    """Whether a model of ``cfg`` draws Gumbel noise in every forward, and so
    takes a ``gumbel_generator`` (the gumbel and dual_sto attentions)."""
    return getattr(cfg, "attn_variant", "softmax") in GUMBEL_VARIANTS


def get_preset(name: str, **overrides) -> ViTConfig:
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg
