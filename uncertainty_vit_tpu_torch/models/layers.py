"""ViT building blocks (torch.nn).

Counterpart of uncertainty_vit_tpu/models/layers.py. Numerical semantics
follow the reference's modeling_finetune.py, as the JAX modules do; layout is
the same: images NHWC, a compute dtype that is an argument (bfloat16 on the
card), parameters float32 under the reference's torch names and shapes, so
that ``utils.checkpoint.load_flax_params`` loads the JAX params with
``strict=True``. Every module initializes its parameters from an explicit
``torch.Generator`` on its ``device``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.core import init as I
from uncertainty_vit_tpu_torch.ops import relpos
from uncertainty_vit_tpu_torch.ops.attention import naive_attention
from uncertainty_vit_tpu_torch.ops.flash_attention import fused_qkv_attention


def drop_path(
    x: torch.Tensor, rate: float, training: bool,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Stochastic depth per sample (modeling_finetune.py:51-62 / timm drop_path)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in f32 with f32 params; the result is f32 (as
    flax's LayerNorm promotes a bf16 input against its f32 params)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


def _param(shape, init: I.Init, device, generator) -> nn.Parameter:
    return nn.Parameter(init(torch.empty(shape, dtype=torch.float32, device=device), generator))


class _Params(nn.Module):
    """A weight and an optional bias under the reference's names (``weight``
    in torch's [out, in, ...] layout, ``bias``)."""

    def __init__(self, weight_shape, weight_init: I.Init, bias_shape=None,
                 bias_init: I.Init = I.zeros, *, device=None, generator=None):
        super().__init__()
        self.weight = _param(weight_shape, weight_init, device, generator)
        self.bias = None if bias_shape is None else _param(bias_shape, bias_init, device, generator)


class PatchEmbed(nn.Module):
    """Patchifier → [B, N, C] (modeling_finetune.py:304-325), NHWC input.

    The stride-p conv is computed as space-to-depth + matmul, as the JAX
    module does; the parameter keeps torch's conv layout [C, in, p, p]."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3, embed_dim: int = 768,
                 dtype: torch.dtype = torch.float32, *, device=None, generator=None):
        super().__init__()
        self.patch_size, self.embed_dim, self.dtype = patch_size, embed_dim, dtype
        fan_in = in_chans * patch_size * patch_size
        self.proj = _Params(
            (embed_dim, in_chans, patch_size, patch_size), I.torch_linear_default(fan_in),
            (embed_dim,), I.torch_linear_default(fan_in), device=device, generator=generator,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        b, h, w, c = x.shape
        gh, gw = h // p, w // p
        # space-to-depth: patch-major rows [py, px, c]
        patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(b, gh * gw, p * p * c).to(self.dtype)
        wm = self.proj.weight.permute(0, 2, 3, 1).reshape(self.embed_dim, p * p * c)
        return F.linear(patches, wm.to(self.dtype), self.proj.bias.to(self.dtype))


class _ScaledOutDense(_Params):
    """Linear whose weight/bias are premultiplied by an optional per-output
    scale — the layer-scale fold of models/layers.py:146-174:
    γ ⊙ (x Wᵀ + b) = x (γ·W)ᵀ + γ⊙b, exactly, at the cost of scaling the
    weight instead of the [B, N, C] activations."""

    def __init__(self, in_features: int, out_features: int, weight_init: I.Init,
                 *, device=None, generator=None):
        super().__init__((out_features, in_features), weight_init, (out_features,),
                         device=device, generator=generator)

    def forward(self, x: torch.Tensor, scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        w, b = self.weight, self.bias
        if scale is not None:
            w = w * scale[:, None]
            b = b * scale
        return F.linear(x, w.to(x.dtype), b.to(x.dtype))


def _fix_init(base: I.Init, layer_id: int) -> I.Init:
    """fix_init_weight rescale by 1/sqrt(2·layer_id) (modeling_finetune.py:443-449)."""
    return base if layer_id == 0 else I.scaled(base, 1.0 / math.sqrt(2.0 * layer_id))


class Mlp(nn.Module):
    """fc1 → GELU → fc2 → dropout (modeling_finetune.py:65-82).

    GELU is the tanh form under bfloat16 and exact erf otherwise, as the
    JAX module selects (models/layers.py:201-205)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int, drop: float = 0.0,
                 layer_id: int = 0, init_std: float = 0.02, init_trunc_abs: float = 2.0,
                 dtype: torch.dtype = torch.float32, *, device=None, generator=None):
        super().__init__()
        tn = I.trunc_normal(init_std, init_trunc_abs)
        self.drop, self.dtype = drop, dtype
        self.fc1 = _ScaledOutDense(in_dim, hidden_dim, tn, device=device, generator=generator)
        self.fc2 = _ScaledOutDense(hidden_dim, out_dim, _fix_init(tn, layer_id),
                                   device=device, generator=generator)

    def forward(self, x: torch.Tensor, out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.fc1(x)
        x = F.gelu(x, approximate="tanh" if self.dtype == torch.bfloat16 else "none")
        x = self.fc2(x, out_scale)
        return F.dropout(x, self.drop, self.training)


def _register_relpos_index(module: nn.Module, window_size: Tuple[int, int], device) -> None:
    """The static [N, N] index into the rel-pos table, as a buffer that is
    not part of the state_dict (the reference checkpoints hold only tables)."""
    index = torch.from_numpy(relpos.relative_position_index(window_size).astype("int64"))
    module.register_buffer("relative_position_index", index.to(device), persistent=False)


def _table_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """[nrd, H] table gathered by the [N, N] index → contiguous [H, N, N]."""
    n = index.shape[0]
    return table[index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1).contiguous()


class RelativePositionBias(nn.Module):
    """Shared-across-blocks rel-pos bias table (modeling_finetune.py:328-364).

    Returns [num_heads, N+1, N+1] f32; zero-initialized like the reference."""

    def __init__(self, window_size: Tuple[int, int], num_heads: int, *, device=None):
        super().__init__()
        nrd = relpos.num_relative_distance(window_size)
        self.relative_position_bias_table = _param((nrd, num_heads), I.zeros, device, None)
        _register_relpos_index(self, window_size, device)

    def forward(self) -> torch.Tensor:
        return _table_bias(self.relative_position_bias_table, self.relative_position_index)


class Attention(nn.Module):
    """MHSA with the reference's fused-qkv / no-key-bias layout
    (modeling_finetune.py:85-188), softmax variant.

    The qkv Linear has no bias; q_bias and v_bias are separate parameters
    and the key bias is structurally zero. The q|0|v bias is added with the
    qkv matmul, outside the attention kernel (models/layers.py:296-314).
    ``use_flash=True`` routes through ``fused_qkv_attention`` (the kernel on
    a CUDA tensor, its plain version on CPU); ``use_flash=False`` takes
    ``naive_attention``."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, window_size: Optional[Tuple[int, int]] = None,
                 attn_head_dim: Optional[int] = None, layer_id: int = 0,
                 init_std: float = 0.02, init_trunc_abs: float = 2.0,
                 use_flash: bool = True, *, device=None, generator=None):
        super().__init__()
        head_dim = attn_head_dim or dim // num_heads
        all_head_dim = head_dim * num_heads
        self.num_heads, self.head_dim = num_heads, head_dim
        self.scale = qk_scale or head_dim**-0.5
        self.attn_drop, self.proj_drop, self.use_flash = attn_drop, proj_drop, use_flash
        tn = I.trunc_normal(init_std, init_trunc_abs)

        self.qkv = _Params((all_head_dim * 3, dim), tn, device=device, generator=generator)
        if qkv_bias:
            self.q_bias = _param((all_head_dim,), I.zeros, device, generator)
            self.v_bias = _param((all_head_dim,), I.zeros, device, generator)
        else:
            self.q_bias = self.v_bias = None
        if window_size is not None:
            nrd = relpos.num_relative_distance(window_size)
            self.relative_position_bias_table = _param((nrd, num_heads), I.zeros, device, generator)
            _register_relpos_index(self, window_size, device)
        else:
            self.relative_position_bias_table = None
        self.proj = _ScaledOutDense(all_head_dim, dim, _fix_init(tn, layer_id),
                                    device=device, generator=generator)

    def forward(self, x: torch.Tensor, rel_pos_bias: Optional[torch.Tensor] = None,
                out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        qkv_bias = None
        if self.q_bias is not None:
            qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.v_bias), self.v_bias])
            qkv_bias = qkv_bias.to(x.dtype)
        qkv = F.linear(x, self.qkv.weight.to(x.dtype), qkv_bias)

        bias = None
        if self.relative_position_bias_table is not None:
            bias = _table_bias(self.relative_position_bias_table, self.relative_position_index)
        if rel_pos_bias is not None:
            bias = rel_pos_bias if bias is None else bias + rel_pos_bias

        drop = self.attn_drop if self.training else 0.0
        if self.use_flash:
            out = fused_qkv_attention(qkv, bias, None, None, self.scale, self.num_heads, drop)
        else:
            q, k, v = qkv.reshape(b, n, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
            out = naive_attention(q, k, v, self.scale, bias, dropout_rate=self.attn_drop,
                                  deterministic=not self.training)
            out = out.transpose(1, 2).reshape(b, n, -1)
        out = self.proj(out, out_scale)
        return F.dropout(out, self.proj_drop, self.training)


class Block(nn.Module):
    """Pre-norm transformer block returning (x, fc_feature)
    (modeling_finetune.py:263-299), with the layer scale γ folded into the
    attention projection and fc2 (exact: dropout and drop-path are diagonal
    maps)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path_rate: float = 0.0,
                 init_values: Optional[float] = None,
                 window_size: Optional[Tuple[int, int]] = None,
                 attn_head_dim: Optional[int] = None, variant: str = "softmax",
                 layer_id: int = 1, init_std: float = 0.02, init_trunc_abs: float = 2.0,
                 layer_norm_eps: float = 1e-6, use_flash: bool = True,
                 dtype: torch.dtype = torch.float32, *, device=None, generator=None):
        super().__init__()
        if variant != "softmax":
            raise NotImplementedError(f"attention variant {variant!r} is not ported yet")
        self.dtype, self.drop_path_rate = dtype, drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.attn = Attention(
            dim, num_heads, qkv_bias=qkv_bias, qk_scale=qk_scale, attn_drop=attn_drop,
            proj_drop=drop, window_size=window_size, attn_head_dim=attn_head_dim,
            layer_id=layer_id, init_std=init_std, init_trunc_abs=init_trunc_abs,
            use_flash=use_flash, device=device, generator=generator,
        )
        self.norm2 = nn.LayerNorm(dim, eps=layer_norm_eps, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop=drop, layer_id=layer_id,
                       init_std=init_std, init_trunc_abs=init_trunc_abs, dtype=dtype,
                       device=device, generator=generator)
        if init_values is not None and init_values > 0:
            self.gamma_1 = _param((dim,), I.constant(init_values), device, generator)
            self.gamma_2 = _param((dim,), I.constant(init_values), device, generator)
        else:
            self.gamma_1 = self.gamma_2 = None

    def forward(self, x: torch.Tensor, rel_pos_bias: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        attn_out = self.attn(layer_norm(self.norm1, x).to(self.dtype), rel_pos_bias,
                             out_scale=self.gamma_1)
        x = x + drop_path(attn_out, self.drop_path_rate, self.training)
        fc_feature = drop_path(
            self.mlp(layer_norm(self.norm2, x).to(self.dtype), out_scale=self.gamma_2),
            self.drop_path_rate, self.training,
        )
        return x + fc_feature, fc_feature
