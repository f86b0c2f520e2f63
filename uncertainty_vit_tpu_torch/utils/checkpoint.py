"""JAX param tree → the port's state_dict.

Counterpart of the torch-layout mapping in uncertainty_vit_tpu/utils/
checkpoint.py (``_torch_key_for`` :89-175, ``export_torch_state_dict``
:562-578), for the parameters of the ported VisionTransformer. The port's
modules use the reference's torch names and layouts, so the mapped dict
loads with ``strict=True``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_TOP = {"cls_token", "pos_embed", "layer_log_weights"}


def _torch_key_for(path: Tuple[str, ...]) -> Optional[Tuple[str, str]]:
    """Map a JAX param path → (torch state_dict key, transform), transform ∈
    {'linear_w' ([in, out] → [out, in]), 'conv_w' (HWIO → OIHW), 'id'}."""
    parts = [p for p in path if p != "backbone"]
    name = parts[-1]
    if len(parts) == 1 and name in _TOP:
        return name, "id"
    if parts[0] == "patch_embed":
        return ("patch_embed.proj.weight", "conv_w") if name == "kernel" \
            else ("patch_embed.proj.bias", "id")
    if parts[0] == "rel_pos_bias":
        return "rel_pos_bias.relative_position_bias_table", "id"
    m = re.fullmatch(r"blocks_(\d+)", parts[0])
    if m:
        pre = f"blocks.{m.group(1)}."
        rest = parts[1:]
        if rest[0] in ("norm1", "norm2"):
            return pre + f"{rest[0]}.{'weight' if name == 'scale' else 'bias'}", "id"
        if rest[0] in ("gamma_1", "gamma_2"):
            return pre + rest[0], "id"
        if rest[0] == "attn":
            if rest[1] == "qkv_kernel":
                return pre + "attn.qkv.weight", "linear_w"
            if rest[1] in ("q_bias", "v_bias", "relative_position_bias_table"):
                return pre + f"attn.{rest[1]}", "id"
            if rest[1] == "proj":
                return _dense(pre + "attn.proj", name)
        if rest[0] == "mlp" and rest[1] in ("fc1", "fc2"):
            return _dense(pre + f"mlp.{rest[1]}", name)
        return None
    if parts[0] == "head":
        return _dense("head", name)
    if parts[0] in ("norm", "fc_norm"):
        return f"{parts[0]}.{'weight' if name == 'scale' else 'bias'}", "id"
    return None


def _dense(prefix: str, name: str) -> Tuple[str, str]:
    return (f"{prefix}.weight", "linear_w") if name == "kernel" else (f"{prefix}.bias", "id")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested JAX params (numpy leaves) → {torch key: f32 tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        mapping = _torch_key_for(path)
        if mapping is None:
            raise KeyError(f"no port parameter for JAX param {'/'.join(path)}")
        key, tf = mapping
        v = np.asarray(leaf, dtype=np.float32)
        if tf == "linear_w":
            v = v.T
        elif tf == "conv_w":
            v = v.transpose(3, 2, 0, 1)
        out[key] = torch.tensor(v)
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load a JAX VisionTransformer's params (``variables["params"]``, as
    nested dicts of numpy arrays) into the port's model, strictly."""
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model
