"""Read a checkpoint directory that the JAX package's ``save_checkpoint``
wrote (uncertainty_vit_tpu/utils/checkpoint.py:30-39: orbax's
``StandardCheckpointer``) without JAX and without orbax.

The layout, as orbax-checkpoint 0.11 writes it by default:

- ``_METADATA``, a JSON file: ``tree_metadata`` maps each leaf to its key
  path (``key_metadata``: ``key_type`` 2 for a dict key, 1 for a sequence
  index) and its kind (``value_metadata.value_type``: ``jax.Array``,
  ``np.ndarray`` or ``scalar`` for stored values; ``None``, ``Dict``,
  ``Tuple`` or ``List`` for an empty node, ``skip_deserialize`` set);
  beside it the flags ``use_ocdbt`` (true) and ``use_zarr3`` (false).
- one OCDBT key-value store at the directory's root, holding each stored
  leaf as a zarr v2 array under its keys joined by ``.``
  (``params.backbone.blocks_0.attn.qkv_kernel``), zstd-compressed; a bf16
  leaf is stored as bfloat16.

``tensorstore`` reads both (its ``zarr`` driver over its ``ocdbt``
kvstore); it is imported when a directory is read, never at import, and
the card's machine does not have it: there ``read_orbax_tree`` raises,
and ``tools/torch_port_orbax_to_pth.py``, run where tensorstore is
installed, turns the directory into a ``.pth`` that the card reads.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

ORBAX_METADATA = "_METADATA"
CONVERTER = "tools/torch_port_orbax_to_pth.py"

# the kinds of a stored leaf, and of an empty node (stored as nothing)
_STORED = ("jax.Array", "np.ndarray", "scalar")
_EMPTY = {"None": lambda: None, "Dict": dict, "Tuple": tuple, "List": list}
_DICT_KEY, _SEQUENCE_INDEX = 2, 1


def is_orbax_checkpoint(path: str) -> bool:
    """A directory holding orbax's ``_METADATA``."""
    return os.path.isfile(os.path.join(path, ORBAX_METADATA))


def _metadata(path: str) -> Dict[str, Any]:
    """``_METADATA`` of ``path``, checked to be the layout this module
    reads; another one raises with its flags."""
    with open(os.path.join(path, ORBAX_METADATA)) as f:
        meta = json.load(f)
    layout = {k: meta.get(k) for k in ("use_ocdbt", "use_zarr3")}
    tree = meta.get("tree_metadata")
    known = (layout == {"use_ocdbt": True, "use_zarr3": False} and isinstance(tree, dict)
             and all(isinstance(e, dict) and "key_metadata" in e and "value_metadata" in e
                     for e in tree.values()))
    if not known:
        raise ValueError(
            f"{path}: an orbax layout this reader does not know ({json.dumps(layout)}, "
            f"tree_metadata entries {'present' if isinstance(tree, dict) else 'absent'}); it "
            "reads the one orbax-checkpoint 0.11's StandardCheckpointer writes by default "
            "(use_ocdbt true, use_zarr3 false, per-leaf key_metadata / value_metadata)")
    return meta


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise RuntimeError(
            "reading an orbax checkpoint of the JAX package needs the tensorstore package, "
            f"which this machine does not have: run {CONVERTER} DIR OUT.pth where tensorstore "
            "is installed and pass OUT.pth instead") from e
    return tensorstore


def read_orbax_tree(path: str) -> Dict[str, Any]:
    """The whole tree of an orbax checkpoint directory as nested dicts,
    lists and tuples of numpy arrays, as JAX's ``restore_checkpoint(path,
    None)`` gives it: a sequence index (an optax state's tuple) makes a
    list, an empty node comes back as ``None``, ``{}``, ``()`` or ``[]``, a
    ``scalar`` leaf as a Python number, a 0-d array (``step``) as a 0-d
    array. Every leaf keeps its stored dtype, bfloat16 included (numpy's
    bfloat16 type that tensorstore registers): the leaves become float32
    where they enter the port's state dict
    (``utils.checkpoint.flax_to_state_dict``), whose parameters are all
    float32. Needs tensorstore; without it raises ``RuntimeError`` naming
    the converter."""
    path = os.path.abspath(path)
    meta = _metadata(path)
    ts = _tensorstore()
    context = ts.Context()
    base = "file://" + path
    opened: List[tuple] = []
    empty: List[tuple] = []
    for entry in meta["tree_metadata"].values():
        keys = tuple((k["key"], k["key_type"]) for k in entry["key_metadata"])
        if any(t not in (_DICT_KEY, _SEQUENCE_INDEX) for _, t in keys):
            raise ValueError(f"{path}: key types {[t for _, t in keys]} at "
                             f"{'.'.join(k for k, _ in keys)}")
        kind = entry["value_metadata"].get("value_type")
        if kind in _EMPTY:
            empty.append((keys, _EMPTY[kind]()))
        elif kind in _STORED:
            spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": base,
                                                  "path": ".".join(k for k, _ in keys)}}
            opened.append((keys, kind, ts.open(spec, context=context, open=True, read=True)))
        else:
            raise ValueError(f"{path}: a leaf of kind {kind!r} at "
                             f"{'.'.join(k for k, _ in keys)}")
    reads = [(keys, kind, store.result().read()) for keys, kind, store in opened]
    root: Dict[tuple, Any] = {}
    for keys, kind, future in reads:
        value = future.result()
        _insert(root, keys, value.item() if kind == "scalar" else value)
    for keys, value in empty:
        _insert(root, keys, value)
    return _sequences(root)


def _insert(root: dict, keys: tuple, value: Any) -> None:
    """Put ``value`` at ``keys`` (((key, key type), ...)); a node is a dict
    keyed by (key, key type) until ``_sequences``."""
    node = root
    for key in keys[:-1]:
        node = node.setdefault(key, {})
    node[keys[-1]] = value


def _sequences(node: Any) -> Any:
    """The dicts keyed by (key, key type) → dicts of str keys, and lists
    where every key is a sequence index, in index order."""
    if not isinstance(node, dict):
        return node
    if node and all(t == _SEQUENCE_INDEX for _, t in node):
        return [_sequences(node[k]) for k in sorted(node, key=lambda kt: int(kt[0]))]
    return {k: _sequences(v) for (k, _), v in node.items()}
