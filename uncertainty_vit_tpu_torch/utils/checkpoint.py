"""JAX param tree → the port's state_dict, a state_dict of one resolution →
a model of another, and the import of a reference ``.pth``.

Counterpart of the torch-layout mapping in uncertainty_vit_tpu/utils/
checkpoint.py (``_torch_key_for`` :89-175, ``export_torch_state_dict``
:562-578), for the parameters and buffers of the ported VisionTransformer,
its uncertainty heads included, of the cyclical model (its ``lm_head``,
linear or SNGP), of the dist models (the cov stream's ``cov_*`` leaves:
``cov_patch_embed``, ``cov_cls_token``, ``cov_mask_token``, each block's
``attn.cov_qkv`` / ``cov_q_bias`` / ``cov_v_bias`` / ``cov_proj``,
``cov_lm_head``), of the MIM and joint models (``lm_head``, ``lm_head.0`` /
``lm_head.2``, ``beit_head``) and of the two image tokenizers (the
DiscreteVAE's Sequential layout, :372-409, its transposed convs' kernels
unflipped; dall_e's ``w`` / ``b``, :450-465). The port's modules use the
reference's torch names and layouts, so the mapped dict loads with
``strict=True``. Each leaf has a key of its own: the JAX package's mapping
sends the SNGP head's two input-norm vectors both to ``head.bias`` and its
output layer to ``head.weight`` (ROADMAP.md §3).

The cross-resolution surgery a 384 or 512 finetune starts from
(``interpolate_pos_embed`` :215-231, ``interpolate_rel_pos_table`` :234-278,
applied in ``import_torch_params`` :320-323) is ``resize_state_dict``:
numpy in, numpy out for the two interpolations.

``load_dalle_pickle_state_dict`` (:521-559) reads OpenAI's dall_e
pickles without their package. ``load_torch_state_dict`` (:76-87) reads a reference ``.pth``, and
``import_torch_state_dict`` applies the rules of ``import_torch_params``
(:281-342) to a model's state_dict under its own (torch) keys; the
spectral fc_norm's ``fc_norm.weight_u`` / ``fc_norm.weight_v`` are
entries like any other, which ``import_torch_spectral_stats`` (:345-370)
takes in the JAX package.

The port's own checkpoints (``save_checkpoint``, ``latest_checkpoint``,
``restore_checkpoint``, ``auto_load``; the JAX package's orbax checkpoints,
:26-73, and the reference's save_model / auto_load_model, utils.py:462-545)
are ``torch.save`` files named as the reference BEiT names them,
``checkpoint-{epoch}.pth`` and ``checkpoint-best.pth``, holding
{"model", "optimizer", "step", "epoch", "model_ema"}; the cyclical state's
EMA teacher is its "model_ema" (``train.engine_cyclical.CyclicalState``).
``save_weights`` writes a model's weights alone (the dVAE trainer's
``checkpoint-dvae-weights.pth``). "model" is the state dict under the reference's torch names, so
``load_torch_state_dict`` and --finetune read a port checkpoint as they
read a reference ``.pth``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
from uncertainty_vit_tpu_torch.parallel.distributed import is_main_process, save_on_master

_TOP = {"cls_token", "mask_token", "pos_embed", "layer_log_weights", "cov_cls_token",
        "cov_mask_token"}


def _torch_key_for(path: Tuple[str, ...]) -> Optional[Tuple[str, str]]:
    """Map a JAX param path → (torch state_dict key, transform), transform ∈
    {'linear_w' ([in, out] → [out, in]), 'conv_w' (HWIO → OIHW), 'id'}."""
    parts = [p for p in path if p != "backbone"]
    name = parts[-1]
    if len(parts) == 1 and name in _TOP:
        return name, "id"
    if parts[0] in ("patch_embed", "cov_patch_embed"):
        return (f"{parts[0]}.proj.weight", "conv_w") if name == "kernel" \
            else (f"{parts[0]}.proj.bias", "id")
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
            if rest[1] in ("qkv_kernel", "cov_qkv_kernel"):
                return pre + f"attn.{rest[1][:-len('_kernel')]}.weight", "linear_w"
            if rest[1] in ("q_bias", "v_bias", "cov_q_bias", "cov_v_bias",
                           "relative_position_bias_table"):
                return pre + f"attn.{rest[1]}", "id"
            if rest[1] in ("proj", "cov_proj", "query", "key", "value"):
                # query / key / value: the dual stochastic attention's dense
                # layers, beside its centroid (JAX utils/checkpoint.py:137-142)
                return _dense(pre + f"attn.{rest[1]}", name)
            if rest[1] == "centroid":
                return pre + "attn.centroid", "id"
        if rest[0] == "mlp" and rest[1] in ("fc1", "fc2"):
            return _dense(pre + f"mlp.{rest[1]}", name)
        return None
    if parts[0] in ("head", "lm_head"):
        return _head_key(parts[0], parts[1:])
    if parts[0] in _JOINT_HEADS:
        # the MIM / joint heads and the dist cyclical model's cov head (JAX
        # :163-171)
        return _dense(_JOINT_HEADS[parts[0]], name)
    if parts[0] in ("norm", "fc_norm"):
        return f"{parts[0]}.{'weight' if name == 'scale' else 'bias'}", "id"
    if parts[0] == "fc_norm_sn":
        # spectral_norm(BertLinear) in fc_norm's place (--sngp,
        # modeling_finetune.py:413-414) under the torch hook's names, its
        # power-iteration vectors ('spectral_stats') beside the weight
        return {"kernel": ("fc_norm.weight_orig", "linear_w"), "bias": ("fc_norm.bias", "id"),
                "u": ("fc_norm.weight_u", "id"), "v": ("fc_norm.weight_v", "id")}.get(name)
    return None


# the joint model's heads (models/mim.py: lm_head is Sequential(fc1, GELU, fc2))
_JOINT_HEADS = {"beit_head": "beit_head", "lm_head_fc1": "lm_head.0",
                "lm_head_fc2": "lm_head.2", "cov_lm_head": "cov_lm_head"}

# the SNGP head's leaves (params, 'sngp_frozen', 'sngp_state') → the
# reference SNGP module's names (modeling_finetune.py:525-638)
_SNGP_KEYS = {
    ("input_norm", "scale"): ("_gp_input_normalize_layer.weight", "id"),
    ("input_norm", "bias"): ("_gp_input_normalize_layer.bias", "id"),
    ("output_layer", "kernel"): ("_gp_output_layer.weight", "linear_w"),
    ("rf_kernel",): ("_random_feature.weight", "linear_w"),
    ("rf_bias",): ("_random_feature.bias", "id"),
    ("precision_matrix",): ("precision_matrix", "id"),
}


def _head_key(head: str, rest: List[str]) -> Optional[Tuple[str, str]]:
    """The leaves of a head ("head", or the cyclical model's "lm_head"),
    under its name: the linear layer's kernel / bias, the SNGP head's
    (``_SNGP_KEYS``) and the heteroscedastic head's three dense layers
    (``loc_layer``, ``scale_layer``, ``diag_layer``). Every leaf has a key
    of its own (the JAX package's export maps several of them onto
    head.weight / head.bias, and has no key for lm_head)."""
    if len(rest) == 1 and rest[0] in ("kernel", "bias"):
        return _dense(head, rest[0])
    found = _SNGP_KEYS.get(tuple(rest))
    if found is not None:
        return f"{head}.{found[0]}", found[1]
    if len(rest) == 2 and rest[0] in ("loc_layer", "scale_layer", "diag_layer"):
        return _dense(f"{head}.{rest[0]}", rest[1])
    return None


def _dense(prefix: str, name: str) -> Tuple[str, str]:
    return (f"{prefix}.weight", "linear_w") if name == "kernel" else (f"{prefix}.bias", "id")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _mapped(tree: Mapping) -> Iterator[Tuple[str, str, Any]]:
    for path, leaf in _leaves(tree):
        mapping = _torch_key_for(path)
        if mapping is None:
            raise KeyError(f"no port parameter for JAX param {'/'.join(path)}")
        yield mapping[0], mapping[1], leaf


def flax_leaves_by_torch_key(tree: Mapping) -> Dict[str, Any]:
    """A tree shaped like the JAX params (per-parameter scalars such as the
    layer-decay scales or the weight-decay mask, or gradients) → {torch
    key: leaf}, leaves untouched (no layout transpose)."""
    return {key: leaf for key, _, leaf in _mapped(tree)}


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested JAX params or gradients (numpy leaves) → {torch key: f32
    tensor in the port's layout}."""
    out: Dict[str, torch.Tensor] = {}
    for key, tf, leaf in _mapped(params):
        v = np.asarray(leaf, dtype=np.float32)
        if tf == "linear_w":
            v = v.T
        elif tf == "conv_w":
            v = v.transpose(3, 2, 0, 1)
        out[key] = torch.tensor(v)
    return out


# the inverse of _torch_key_for: the JAX tree's names for the port's keys
_BACKBONE_TOP = ("cls_token", "mask_token", "pos_embed", "cov_cls_token", "cov_mask_token")
_SNGP_PATHS = {key: path for path, (key, _) in _SNGP_KEYS.items()}
_JOINT_PATHS = {key: name for name, key in _JOINT_HEADS.items()}
# the SNGP leaves that are not parameters, by the JAX collection holding them
_COLLECTION_OF = {"rf_kernel": "sngp_frozen", "rf_bias": "sngp_frozen",
                  "precision_matrix": "sngp_state", "u": "spectral_stats",
                  "v": "spectral_stats"}


def _flax_path_for(key: str, spectral_fc_norm: bool) -> Tuple[str, ...]:
    """A port key → its JAX path (the inverse of ``_torch_key_for``, the
    ``backbone`` module put back). ``fc_norm.bias`` is the spectral
    fc_norm's when the state dict holds ``fc_norm.weight_orig``."""
    parts = key.split(".")
    leaf = "kernel" if parts[-1] == "weight" else "bias"
    if key in _BACKBONE_TOP:
        return ("backbone", key)
    if key == "layer_log_weights":
        return (key,)
    if parts[0] in ("patch_embed", "cov_patch_embed"):
        return ("backbone", parts[0], "proj", leaf)
    if key == SHARED_REL_POS_TABLE:
        return ("backbone", "rel_pos_bias", "relative_position_bias_table")
    if parts[0] == "blocks":
        pre, sub = ("backbone", f"blocks_{parts[1]}"), parts[2:]
        if sub[0] in ("norm1", "norm2"):
            return pre + (sub[0], "scale" if sub[1] == "weight" else "bias")
        if sub[0] in ("gamma_1", "gamma_2"):
            return pre + (sub[0],)
        if sub[:2] in (["attn", "qkv"], ["attn", "cov_qkv"]):
            return pre + ("attn", f"{sub[1]}_kernel")
        return pre + tuple(sub[:2]) + ((leaf,) if len(sub) == 3 else ())
    if ".".join(parts[:-1]) in _JOINT_PATHS:
        return (_JOINT_PATHS[".".join(parts[:-1])], leaf)
    if parts[0] in ("head", "lm_head"):
        rest = ".".join(parts[1:])
        if rest in _SNGP_PATHS:
            return (parts[0],) + _SNGP_PATHS[rest]
        return tuple(parts[:-1]) + (leaf,)
    if parts[0] == "fc_norm" and spectral_fc_norm:
        return ("fc_norm_sn", {"weight_orig": "kernel", "bias": "bias", "weight_u": "u",
                               "weight_v": "v"}[parts[1]])
    return (parts[0], "scale" if parts[1] == "weight" else "bias")


def state_dict_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """The port's state dict (a model's, or a reference ``.pth``'s) → the
    JAX package's variables, {collection: nested dict of numpy arrays}:
    "params" and, where the model has them, "spectral_stats", "sngp_state"
    and "sngp_frozen". The counterpart of JAX ``import_torch_params``
    (uncertainty_vit_tpu/utils/checkpoint.py:281) that needs no JAX: the
    exact inverse of ``flax_to_state_dict`` (each key sent back through
    ``_torch_key_for`` must give itself; the layouts transposed back), so
    that a float32 tree comes back bit for bit. ``relative_position_index``
    buffers, which the JAX tree does not hold, are dropped."""
    spectral = "fc_norm.weight_orig" in state_dict
    out: Dict[str, Dict[str, Any]] = {}
    for key, value in state_dict.items():
        if "relative_position_index" in key:
            continue
        path = _flax_path_for(key, spectral)
        mapping = _torch_key_for(path)
        if mapping is None or mapping[0] != key:
            raise KeyError(f"no JAX param for port key {key}")
        v = _numpy(value)
        if mapping[1] == "linear_w":
            v = v.T
        elif mapping[1] == "conv_w":  # OIHW → HWIO
            v = v.transpose(2, 3, 1, 0)
        node = out.setdefault(_COLLECTION_OF.get(path[-1], "params"), {})
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(v)
    return out


# ---------------------------------------------------------------------------
# The JAX package's train states, as utils.orbax.read_orbax_tree reads them
# ---------------------------------------------------------------------------

# each state's fields (uncertainty_vit_tpu/train/engine_finetune.py:25-33,
# engine_finetune_dist.py:26-30, engine_cyclical.py:26-35,
# engine_mim.py:25-29: the joint pretrainer writes a CyclicalState), and the
# dVAE trainer's two layouts (cli/train_dvae.py:193-200): its per-epoch
# state and checkpoint-dvae-weights, the variables alone
JAX_STATES = {
    "finetune": ("params", "opt_state", "step", "model_ema", "sngp_state", "spectral_stats",
                 "sngp_frozen"),
    "dist": ("params", "opt_state", "step"),
    "cyclical": ("params", "opt_state", "ema_params", "step", "sngp_state", "sngp_frozen"),
    "mim": ("params", "opt_state", "step"),
}
DVAE_STATES = (("params",), ("variables", "opt_state", "step"))
FAMILIES = (*JAX_STATES, "dvae")


def jax_state_family(tree: Mapping) -> str:
    """Which train state of the JAX package ``tree`` is, by its fields; a
    DistFinetuneState and a MIMState have the same fields, and the dist
    model's backbone holds ``cov_patch_embed``."""
    fields = set(tree)
    if any(fields == set(f) for f in DVAE_STATES):
        params = tree["params"] if "params" in tree else tree["variables"]["params"]
        if "codebook" in params:
            return "dvae"
    for family in ("finetune", "cyclical"):
        if fields == set(JAX_STATES[family]):
            return family
    if fields == set(JAX_STATES["dist"]):
        return "dist" if "cov_patch_embed" in tree["params"].get("backbone", {}) else "mim"
    raise ValueError(f"not a train state of the JAX package: fields {sorted(fields)}")


def jax_state_dict(tree: Mapping, family: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The weights of a JAX train state as the port's state dict, under the
    reference's names: what the JAX drivers take from the state, its
    ``params`` (the student's, for the pretraining states: JAX
    cli/finetune.py:259-263, :288-289), and for a dVAE its variables'
    params (cli/builders.py:456-457). The SNGP buffers (``spectral_stats``,
    ``sngp_state``, ``sngp_frozen``) are carried where the state holds them,
    as the port's ``.pth`` carries them. The optimizer's state and the EMA
    are not read. ``family`` (one of ``FAMILIES``) must be the state's when
    given; by default it is read from the tree."""
    found = jax_state_family(tree)
    if family is not None and family != found:
        raise ValueError(f"the tree is a {found} state, not {family}")
    if found == "dvae":
        return dvae_state_dict(tree["params"] if "params" in tree else tree["variables"]["params"])
    state = flax_to_state_dict(tree["params"])
    for name in ("spectral_stats", "sngp_state", "sngp_frozen"):
        if tree.get(name):
            state.update(flax_to_state_dict(tree[name]))
    return state


def read_weights(path: str) -> Dict[str, torch.Tensor]:
    """The weights at ``path`` as a state dict: a ``.pth`` / ``.pt``
    (``load_torch_state_dict``), anything else an orbax checkpoint
    directory of the JAX package (``jax_state_dict`` of
    ``utils.orbax.read_orbax_tree``, which needs tensorstore), as the JAX
    drivers tell them apart."""
    if path.endswith((".pth", ".pt")):
        return load_torch_state_dict(path)
    from uncertainty_vit_tpu_torch.utils.orbax import read_orbax_tree

    return jax_state_dict(read_orbax_tree(path))


def _dvae_key_for(path: Tuple[str, ...], num_layers: int) -> Tuple[str, str]:
    """A JAX DiscreteVAE param path → (torch key, transform) in the
    reference's Sequential layout (JAX :372-409); transform 'conv_w' (HWIO →
    OIHW), 'deconv_w' (TorchConvTranspose's pre-flipped HWIO kernel → torch
    ConvTranspose2d's [in, out, kh, kw]) or 'id'."""
    head, name = path[0], path[-1]
    if head == "codebook":
        return "codebook.weight", "id"
    tname = "weight" if name == "kernel" else "bias"
    for side, prefix in (("enc", "encoder"), ("dec", "decoder")):
        m = re.fullmatch(rf"{side}_conv_(\d+)", head)
        if m:
            kernel = "conv_w" if side == "enc" else "deconv_w"
            return f"{prefix}.{2 * int(m.group(1))}.0.{tname}", kernel if name == "kernel" else "id"
        m = re.fullmatch(rf"{side}_res_(\d+)", head)
        if m:
            slot = {"conv1": 0, "conv2": 2, "conv3": 4}[path[1]]
            return (f"{prefix}.{2 * int(m.group(1)) + 1}.net.{slot}.{tname}",
                    "conv_w" if name == "kernel" else "id")
        if head == f"{side}_head":
            return f"{prefix}.{2 * num_layers}.{tname}", "conv_w" if name == "kernel" else "id"
    raise KeyError(f"no DiscreteVAE parameter for JAX param {'/'.join(path)}")


def _dalle_key_for(path: Tuple[str, ...]) -> Tuple[str, str]:
    """A JAX DalleEncoder / DalleDecoder param path → (dall_e key, transform)
    (JAX :450-465): ``w`` OIHW, ``b``."""
    suffix, tf = ("w", "conv_w") if path[-1] == "kernel" else ("b", "id")
    mod = path[0]
    if mod == "input_conv":
        return f"blocks.input.{suffix}", tf
    if mod == "output_conv":
        return f"blocks.output.conv.{suffix}", tf
    m = re.fullmatch(r"group_(\d+)_block_(\d+)", mod)
    if m is None:
        raise KeyError(f"no dall_e parameter for JAX param {'/'.join(path)}")
    inner = "id_path" if path[1] == "id_conv" else f"res_path.{path[1]}"
    return f"blocks.group_{m.group(1)}.block_{m.group(2)}.{inner}.{suffix}", tf


def dvae_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX DiscreteVAE's params as the port's DiscreteVAE's state dict;
    its depth is the count of ``enc_conv_*`` layers in ``params``."""
    num_layers = sum(1 for k in params if re.fullmatch(r"enc_conv_\d+", k))
    return _tokenizer_leaves(params, lambda path: _dvae_key_for(path, num_layers))


def _tokenizer_state_dict(model: nn.Module, params: Mapping) -> Optional[Dict[str, torch.Tensor]]:
    """A JAX tokenizer's params as the port's tokenizer's state dict, or None
    when ``model`` is no tokenizer."""
    from uncertainty_vit_tpu_torch.models.dalle_vae import DalleDecoder, DalleEncoder, DalleVAE
    from uncertainty_vit_tpu_torch.models.dvae import DiscreteVAE

    if isinstance(model, DiscreteVAE):
        def key_for(path):
            return _dvae_key_for(path, model.num_layers)
    elif isinstance(model, DalleVAE):
        def key_for(path):  # encoder/... and decoder/... subtrees
            key, tf = _dalle_key_for(path[1:])
            return f"{path[0]}.{key}", tf
    elif isinstance(model, (DalleEncoder, DalleDecoder)):
        key_for = _dalle_key_for
    else:
        return None
    return _tokenizer_leaves(params, key_for)


def _tokenizer_leaves(params: Mapping, key_for) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        key, tf = key_for(path)
        v = np.asarray(leaf, dtype=np.float32)
        if tf == "conv_w":
            v = v.transpose(3, 2, 0, 1)
        elif tf == "deconv_w":  # the inverse of v.transpose(2, 3, 0, 1)[::-1, ::-1]
            v = v[::-1, ::-1].transpose(2, 3, 0, 1)
        out[key] = torch.tensor(np.ascontiguousarray(v))
    return out


def load_flax_params(model: nn.Module, params: Mapping,
                     collections: Optional[Mapping] = None) -> nn.Module:
    """Load a JAX VisionTransformer's params (``variables["params"]``, as
    nested dicts of numpy arrays) into the port's model, strictly.
    ``collections`` holds the model's other variable collections
    ('spectral_stats', 'sngp_frozen', 'sngp_state' of the SNGP model; a
    whole ``variables`` dict may be passed, its "params" are skipped): they
    fill the buffers of the same leaves. The image tokenizers (a
    ``models.dvae.DiscreteVAE``, a ``models.dalle_vae.DalleVAE`` or its
    encoder or decoder) take their JAX counterparts' params the same way.
    A model built on a ``parallel.mesh.Mesh`` takes its shard of the full
    dict (``parallel.mesh.shard_state_dict``)."""
    state = _tokenizer_state_dict(model, params)
    if state is not None:
        model.load_state_dict(state, strict=True)
        return model
    state = flax_to_state_dict(params)
    for name, tree in (collections or {}).items():
        if name != "params":
            state.update(flax_to_state_dict(tree))
    model.load_state_dict(meshlib.shard_state_dict(state, getattr(model, "mesh", None)),
                          strict=True)
    return model


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's whole state dict: under a model axis of a mesh the
    shards gathered from every model rank (every rank of the axis must
    call it)."""
    return meshlib.gather_state_dict(model.state_dict(), getattr(model, "mesh", None))


def _torch_bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """Row-stochastic (out_size, in_size) matrix reproducing
    torch.nn.functional.interpolate(mode='bicubic', align_corners=False,
    antialias=False) along one axis: half-pixel source centers, 4-tap cubic
    convolution with A=-0.75, border-clamped taps."""
    a = -0.75

    def kernel(x):
        ax = np.abs(x)
        return np.where(
            ax <= 1.0,
            ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
            np.where(ax < 2.0, a * (((ax - 5.0) * ax + 8.0) * ax - 4.0), 0.0),
        )

    scale = in_size / out_size
    i = np.arange(out_size)
    center = (i + 0.5) * scale - 0.5
    i0 = np.floor(center).astype(np.int64)
    t = center - i0
    w_mat = np.zeros((out_size, in_size), np.float64)
    for k in range(-1, 3):
        w = kernel(k - t)
        idx = np.clip(i0 + k, 0, in_size - 1)
        np.add.at(w_mat, (i, idx), w)
    return w_mat


def interpolate_pos_embed(pos: np.ndarray, dst_num_patches: int) -> np.ndarray:
    """Bicubic abs-pos-embed interpolation (run_class_finetuning.py:496-518):
    pos [1, extra + S², C] → [1, extra + dst_num_patches, C]. The cls slot
    passes through; the patch grid is resized with torch's bicubic semantics
    (A=-0.75, align_corners=False)."""
    num_extra = pos.shape[1] - int(round((pos.shape[1] - 1) ** 0.5)) ** 2
    src_size = int(round((pos.shape[1] - num_extra) ** 0.5))
    dst_size = int(round(dst_num_patches**0.5))
    if src_size == dst_size:
        return pos
    extra = pos[:, :num_extra]
    grid = pos[:, num_extra:].reshape(src_size, src_size, -1).astype(np.float64)
    w = _torch_bicubic_weights(src_size, dst_size)
    resized = np.einsum("yh,hwc,xw->yxc", w, grid, w)
    resized = resized.reshape(1, dst_size * dst_size, -1).astype(pos.dtype)
    return np.concatenate([extra, resized], axis=1)


def interpolate_rel_pos_table(table: np.ndarray, dst_num_pos: int) -> np.ndarray:
    """Geometric-progression rel-pos-table resize
    (run_class_finetuning.py:433-494): table [(2S−1)² + 3, H] → [dst_num_pos,
    H]. Source coordinates are laid out with geometrically increasing
    spacing, targets on the integer grid, one cubic spline
    (``RectBivariateSpline(kx=3, ky=3)``) per head; the three cls entries
    pass through."""
    from scipy import interpolate

    src_num_pos, num_heads = table.shape
    num_extra = 3
    src_size = int((src_num_pos - num_extra) ** 0.5)
    dst_size = int((dst_num_pos - num_extra) ** 0.5)
    if src_size == dst_size:
        return table

    extra = table[-num_extra:, :]
    body = table[:-num_extra, :]

    def gp_sum(a, r, n):
        return a * (1.0 - r**n) / (1.0 - r)

    left, right = 1.01, 1.5
    while right - left > 1e-6:
        q = (left + right) / 2.0
        if gp_sum(1, q, src_size // 2) > dst_size // 2:
            right = q
        else:
            left = q

    dis, cur = [], 1.0
    for i in range(src_size // 2):
        dis.append(cur)
        cur += q ** (i + 1)
    r_ids = [-v for v in reversed(dis)]
    x = np.array(r_ids + [0] + dis)
    t = dst_size // 2.0
    dx = np.arange(-t, t + 0.1, 1.0)

    heads = []
    for i in range(num_heads):
        z = body[:, i].reshape(src_size, src_size).astype(np.float64)
        f = interpolate.RectBivariateSpline(x, x, z, kx=3, ky=3)
        heads.append(f(dx, dx).reshape(-1, 1))
    new_body = np.concatenate(heads, axis=-1).astype(table.dtype)
    return np.concatenate([new_body, extra], axis=0)


def resize_entry(key: str, array: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """One checkpoint entry carried to a model's ``shape`` at another
    resolution: ``pos_embed`` and every ``relative_position_bias_table``
    (the shared one or a per-block one) are interpolated when their shape
    differs; anything else comes back as it was."""
    if tuple(array.shape) == tuple(shape):
        return array
    if key == "pos_embed":
        return interpolate_pos_embed(array, shape[1] - 1)
    if key.endswith("relative_position_bias_table"):
        return interpolate_rel_pos_table(array, shape[0])
    return array


def resize_state_dict(state_dict: Mapping[str, torch.Tensor], model: nn.Module
                      ) -> Dict[str, torch.Tensor]:
    """A port state_dict of one resolution → one that ``model`` (same widths,
    another image size) loads strictly: each entry through ``resize_entry``.
    ``relative_position_index`` entries are dropped: the model rebuilds its
    index buffers from its own window."""
    target = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if "relative_position_index" in key:
            continue
        want = target.get(key)
        if want is not None and tuple(value.shape) != tuple(want.shape):
            array = resize_entry(key, value.detach().cpu().numpy(), tuple(want.shape))
            value = torch.from_numpy(np.ascontiguousarray(array)).to(value.device)
        out[key] = value
    return out


SHARED_REL_POS_TABLE = "rel_pos_bias.relative_position_bias_table"


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` as {key: CPU tensor}, from its ``model`` or
    ``module`` container when it has one (run_class_finetuning.py:400-406).
    ``weights_only=False``, as the JAX package loads it: the reference's
    files carry an argparse Namespace beside the weights, so load only files
    you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "module"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in ckpt.items()}


def _numpy(value: Any) -> np.ndarray:
    """A checkpoint entry as a numpy array (a bf16 tensor, which numpy has
    no type for, as f32)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return np.asarray(value)


def import_torch_state_dict(
    state_dict: Mapping[str, Any],
    template: Mapping[str, torch.Tensor],
    keep_mismatched_head: bool = False,
) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Fill a model's state_dict (``template``) from a reference state_dict.

    Returns (state, missing, unused): ``state`` loads into the model
    strictly, with the template's entry where the checkpoint has none;
    ``missing`` are the template's keys left so, ``unused`` the checkpoint's
    keys nothing took. The rules of ``import_torch_params``:
    ``relative_position_index`` entries are dropped; a per-block
    ``relative_position_bias_table`` the checkpoint lacks is taken from its
    shared table (run_class_finetuning.py:419-426); ``pos_embed`` and the
    rel-pos tables are interpolated to the template's resolution
    (``resize_entry``, as ``resize_state_dict`` does); any other
    shape mismatch (a head of another class count) keeps the template's
    entry (:409-412), unless ``keep_mismatched_head``
    (``--dual_finetune``), which raises instead."""
    sd = {k: v for k, v in state_dict.items() if "relative_position_index" not in k}
    state: Dict[str, torch.Tensor] = {}
    missing: List[str] = []
    used = set()
    for key, want in template.items():
        source = key
        if (source not in sd and key.startswith("blocks.")
                and key.endswith("relative_position_bias_table")
                and SHARED_REL_POS_TABLE in sd):
            source = SHARED_REL_POS_TABLE
        value = None
        if source in sd:
            used.add(source)
            value = resize_entry(key, _numpy(sd[source]), tuple(want.shape))
            if value.shape != tuple(want.shape):
                if keep_mismatched_head:
                    raise ValueError(f"--dual_finetune: checkpoint {source} shape {value.shape} "
                                     f"!= model {tuple(want.shape)}")
                value = None
        if value is None:
            missing.append(key)
            state[key] = want
        else:
            state[key] = torch.as_tensor(np.ascontiguousarray(value), dtype=want.dtype
                                         ).to(want.device)
    return state, missing, [k for k in sd if k not in used]


def load_dalle_pickle_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of an OpenAI dall_e ``encoder.pkl`` / ``decoder.pkl``
    (a pickled module) without the dall_e package (JAX :521-559): stand-in
    ``nn.Module`` classes under the ``dall_e.*`` module paths the pickle
    names let it rebuild the object graph. ``sys.modules`` is left as it
    was found, whether the load succeeds or fails; a ``dall_e`` module that
    is installed is used as it is. ``weights_only=False``: load only files
    you trust."""
    import sys
    import types

    stand_ins = {"dall_e": (), "dall_e.utils": ("Conv2d",),
                 "dall_e.encoder": ("Encoder", "EncoderBlock"),
                 "dall_e.decoder": ("Decoder", "DecoderBlock")}
    saved = {name: sys.modules.get(name) for name in stand_ins}
    try:
        for name, classes in stand_ins.items():
            if saved[name] is None:
                module = types.ModuleType(name)
                for cls in classes:
                    setattr(module, cls, type(cls, (nn.Module,), {}))
                sys.modules[name] = module
        obj = torch.load(path, map_location="cpu", weights_only=False)
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return {k: v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in sd.items()}


# ---------------------------------------------------------------------------
# The port's own checkpoints
# ---------------------------------------------------------------------------

_NUMBERED = re.compile(r"checkpoint-(\d+)\.pth")


def checkpoint_path(output_dir: str, tag) -> str:
    return os.path.join(os.path.abspath(output_dir), f"checkpoint-{tag}.pth")


def save_checkpoint(output_dir: str, tag, state, epoch: int) -> str:
    """Write a train state (``train.engine_finetune.FinetuneState``,
    the MIM pretrainer's and the dVAE trainer's too, or
    ``train.engine_cyclical.CyclicalState``, the joint pretrainer's too:
    model, optimizer, step, and the EMA or teacher where it has one) after ``epoch`` to
    output_dir/checkpoint-{tag}.pth
    (an epoch number or "best"); the file appears whole or not at all.
    Under a mesh rank 0 alone writes (its replica: the ranks of the data and
    seq axes hold equal states); a model axis raises (its optimizer state
    is not gathered yet, ROADMAP.md item 21)."""
    mesh = getattr(state.model, "mesh", None)
    if meshlib.active(mesh, meshlib.MODEL_AXIS):
        raise NotImplementedError("a resumable checkpoint under a model axis is not ported "
                                  "(ROADMAP.md item 21); save_weights writes the gathered model")
    path = checkpoint_path(output_dir, tag)
    if not is_main_process():
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    def cpu(tensors):
        return None if tensors is None else {k: v.detach().cpu() for k, v in tensors.items()}

    blob = {"model": cpu(state.model.state_dict()), "optimizer": state.optimizer.state_dict(),
            "step": int(state.step), "epoch": int(epoch), "model_ema": cpu(state.model_ema)}
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def save_weights(output_dir: str, tag, model: nn.Module) -> str:
    """Write a model's weights alone, {"model": state_dict}, to
    output_dir/checkpoint-{tag}.pth (the dVAE trainer's
    ``checkpoint-dvae-weights.pth``, which the pretrainers read through
    --discrete_vae_weight_path); ``load_torch_state_dict`` reads it. A
    model on a mesh is gathered over its model axis and written by rank 0
    (``save_on_master``)."""
    path = checkpoint_path(output_dir, tag)
    state = full_state_dict(model)

    def write():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save({"model": {k: v.detach().cpu() for k, v in state.items()}}, tmp)
        os.replace(tmp, path)

    save_on_master(write)
    return path


def latest_checkpoint(output_dir: str) -> Optional[Tuple[int, str]]:
    """(N, path) of the highest checkpoint-N.pth in output_dir, or None
    (utils.py:493-503)."""
    if not os.path.isdir(output_dir):
        return None
    best = None
    for name in os.listdir(output_dir):
        m = _NUMBERED.fullmatch(name)
        if m and (best is None or int(m.group(1)) > best[0]):
            best = (int(m.group(1)), os.path.join(output_dir, name))
    return best


def restore_checkpoint(path: str, state):
    """Load a port checkpoint into ``state`` in place: the model strictly,
    the optimizer's moments and counts, the step and the EMA. Returns it."""
    device = next(state.model.parameters()).device
    blob = torch.load(path, map_location=device, weights_only=False)
    state.model.load_state_dict(blob["model"], strict=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    if blob.get("model_ema") is not None:
        state.model_ema = {k: v.to(device) for k, v in blob["model_ema"].items()}
    return state


def auto_load(output_dir: str, state) -> Tuple[Any, int]:
    """Resume from the highest checkpoint-N.pth: (state, N + 1), or
    (state, 0) untouched when there is none. An orbax ``checkpoint-N``
    directory of the JAX package there raises: its optax state does not
    cross packages (ROADMAP.md item 23), and a run that skipped it would
    start afresh over it."""
    from uncertainty_vit_tpu_torch.utils.orbax import is_orbax_checkpoint

    if os.path.isdir(output_dir):
        jax_states = sorted(n for n in os.listdir(output_dir) if re.fullmatch(r"checkpoint-\d+", n)
                            and is_orbax_checkpoint(os.path.join(output_dir, n)))
        if jax_states:
            raise NotImplementedError(
                f"--auto_resume: {output_dir} holds orbax train states of the JAX package "
                f"({', '.join(jax_states)}); their optax state does not cross packages "
                "(ROADMAP.md item 23): pass one to --finetune, or use another --output_dir")
    found = latest_checkpoint(output_dir)
    if found is None:
        return state, 0
    epoch, path = found
    print(f"resuming from {path}", flush=True)
    return restore_checkpoint(path, state), epoch + 1
