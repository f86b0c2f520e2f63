"""PyTorch port: the orbax reader (``utils/orbax.py``), the JAX train
states as state dicts and back (``utils/checkpoint.py``), and the converter
(``tools/torch_port_orbax_to_pth.py``) against what the JAX package writes.

One module fixture saves every train state the JAX drivers write
(``tests/orbax_states.py``: FinetuneState with a linear head and a bf16 EMA,
with ``--sngp`` and with ``--het_layer``; DistFinetuneState; CyclicalState of
the ``--gp_layer`` model; MIMState; the dVAE's ``checkpoint-dvae-weights``
and its per-epoch state) with the JAX package's ``save_checkpoint``. Every
hold is exact: the reader against JAX's ``restore_checkpoint(path, None)``
leaf for leaf (dtype, shape and bytes), the state dicts against the JAX
export of the same trees, the inverse mapping back to the trees bit for bit.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import orbax_states as S
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)
from uncertainty_vit_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from uncertainty_vit_tpu.utils import checkpoint as JC
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.models.cyclical import CyclicalViT
from uncertainty_vit_tpu_torch.models.dist_vit import DistVisionTransformer
from uncertainty_vit_tpu_torch.models.dvae import DiscreteVAE
from uncertainty_vit_tpu_torch.models.mim import MIMViT
from uncertainty_vit_tpu_torch.utils import checkpoint as C
from uncertainty_vit_tpu_torch.utils import orbax as O

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_port_orbax_to_pth as TOOL  # noqa: E402

FT_ARGV = S.driver_argv("unused", "unused")
# family name → (the JAX state, the family jax_state_family reads, the port model)
FAMILIES = {
    "finetune_linear": (lambda: S.finetune_state(FT_ARGV, ema_dtype="bfloat16"), "finetune",
                        lambda: TFT.build_model(TFT.get_args_parser().parse_args(FT_ARGV),
                                                S.NUM_CLASSES, device="cpu")[0]),
    "finetune_sngp": (lambda: S.finetune_state(FT_ARGV + ["--sngp"], sngp_batches=2), "finetune",
                      lambda: TFT.build_model(TFT.get_args_parser().parse_args(
                          FT_ARGV + ["--sngp"]), S.NUM_CLASSES, device="cpu")[0]),
    "finetune_het": (lambda: S.finetune_state(FT_ARGV + ["--het_layer"]), "finetune",
                     lambda: TFT.build_model(TFT.get_args_parser().parse_args(
                         FT_ARGV + ["--het_layer"]), S.NUM_CLASSES, device="cpu")[0]),
    "dist": (S.dist_state, "dist", lambda: DistVisionTransformer(
        ViTConfig(**S.SMALL, num_classes=S.NUM_CLASSES), device="cpu")),
    "cyclical": (S.cyclical_state, "cyclical", lambda: CyclicalViT(
        ViTConfig(**S.SMALL, head_type="none"), gp_layer=True, device="cpu")),
    "mim": (S.mim_state, "mim", lambda: MIMViT(ViTConfig(**S.SMALL, head_type="none"),
                                               vocab_size=S.VOCAB, device="cpu")),
    "dvae_weights": (S.dvae_variables, "dvae", lambda: DiscreteVAE(**S.DVAE, device="cpu")),
    "dvae_epoch": (S.dvae_epoch_state, "dvae", lambda: DiscreteVAE(**S.DVAE, device="cpu")),
}
VIT_FAMILIES = [f for f in FAMILIES if not f.startswith("dvae")]
COLLECTIONS = ("spectral_stats", "sngp_state", "sngp_frozen")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{family: (checkpoint directory, the JAX state as numpy)}."""
    root = str(tmp_path_factory.mktemp("orbax"))
    out = {}
    for name, (make, _, _) in FAMILIES.items():
        state = make()
        out[name] = (S.save(root, name, state), state)
    return out


def _state_fields(state):
    """A JAX state's fields as a dict (a flax dataclass or a dict)."""
    return state if isinstance(state, dict) else {
        k: getattr(state, k) for k in state.__dataclass_fields__}


def _same_tree(got, want, where=""):
    """``got`` is ``want`` leaf for leaf: the same containers (list where JAX
    restores a list), None where None, Python scalars equal, arrays of the
    same dtype, shape and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, got, want)
        for k in want:
            _same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), (where, type(got), type(want))
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{where}/{i}")
    elif want is None or isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, (where, got, want)
    else:
        w = np.asarray(want)
        assert isinstance(got, np.ndarray), (where, type(got))
        assert str(got.dtype) == str(w.dtype) and got.shape == w.shape, (where, got.dtype, w.dtype)
        assert got.tobytes() == w.tobytes(), where


@pytest.mark.parametrize("family", list(FAMILIES))
def test_reader_gives_what_jax_restores(saved, family):
    """Every leaf of the directory as JAX's restore_checkpoint(path, None)
    gives it: the optax state's tuples as lists, None fields as None, the
    0-d step, the bf16 EMA as bf16."""
    path, _ = saved[family]
    want = S.as_numpy(JC.restore_checkpoint(path, None))
    got = O.read_orbax_tree(path)
    _same_tree(got, want)
    assert O.is_orbax_checkpoint(path) and not O.is_orbax_checkpoint(os.path.dirname(path))
    if family == "finetune_linear":
        assert str(got["model_ema"]["head"]["kernel"].dtype) == "bfloat16"
        assert got["step"].shape == () and got["sngp_state"] is None
        assert isinstance(got["opt_state"], list)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_state_dict_is_the_jax_export_and_loads_strictly(saved, family):
    """``read_weights`` of a directory: the family read from the tree, the same
    tensors as the mapping of the JAX state's params and SNGP collections in
    memory, loaded by the port's model of that family strictly (the rel-pos
    index buffers are the model's own)."""
    path, state = saved[family]
    _, want_family, make_model = FAMILIES[family]
    tree = O.read_orbax_tree(path)
    assert C.jax_state_family(tree) == want_family
    got = C.read_weights(path)
    fields = S.as_numpy(_state_fields(state))
    if want_family == "dvae":
        params = fields["params"] if "params" in fields else fields["variables"]["params"]
        want = C.dvae_state_dict(params)
    else:
        want = C.flax_to_state_dict(fields["params"])
        for name in COLLECTIONS:
            if fields.get(name) is not None:
                want.update(C.flax_to_state_dict(fields[name]))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    model = make_model()
    result = model.load_state_dict(got, strict=False)
    assert not result.unexpected_keys
    assert all("relative_position_index" in k for k in result.missing_keys), result.missing_keys
    if family == "finetune_sngp":
        assert {"head.precision_matrix", "head._random_feature.weight", "fc_norm.weight_u",
                "fc_norm.weight_v"} <= set(got)


@pytest.mark.parametrize("family", VIT_FAMILIES)
def test_inverse_round_trips(saved, family):
    """``state_dict_to_flax`` gives back the JAX state's params and SNGP
    collections bit for bit, and the port model's own state dict survives
    the round trip (its rel-pos index buffers dropped)."""
    path, state = saved[family]
    fields = S.as_numpy(_state_fields(state))
    back = C.state_dict_to_flax(C.read_weights(path))
    want = {"params": fields["params"],
            **{k: fields[k] for k in COLLECTIONS if fields.get(k) is not None}}
    _same_tree(back, want)
    model_sd = FAMILIES[family][2]().state_dict()
    again = {}
    for tree in C.state_dict_to_flax(model_sd).values():
        again.update(C.flax_to_state_dict(tree))
    assert sorted(again) == sorted(k for k in model_sd if "relative_position_index" not in k)
    for k, v in again.items():
        assert torch.equal(v, model_sd[k]), k


def test_inverse_refuses_a_key_with_no_jax_param():
    with pytest.raises(KeyError, match="no JAX param for port key blocks.0.attn.nope"):
        C.state_dict_to_flax({"blocks.0.attn.nope.weight": torch.zeros(2, 2)})


@pytest.mark.parametrize("family", ["finetune_sngp", "cyclical", "dvae_epoch"])
def test_converter_writes_what_the_driver_loads(saved, family, tmp_path):
    """The tool's .pth holds {"model": state dict}, equal to what the
    drivers load from the directory; --family must match the tree."""
    path, _ = saved[family]
    out = str(tmp_path / "out.pth")
    assert TOOL.main([path, out]) == 0
    blob = torch.load(out, weights_only=False)
    assert list(blob) == ["model"]
    want = C.read_weights(path)
    assert sorted(C.read_weights(out)) == sorted(want)
    for k, v in want.items():
        assert torch.equal(blob["model"][k], v), k
    other = "mim" if FAMILIES[family][1] != "mim" else "dist"
    with pytest.raises(ValueError, match=f"not {other}"):
        TOOL.main([path, out, "--family", other])


def test_reader_and_tool_import_neither_jax_nor_orbax(saved, tmp_path):
    """A fresh process that reads a directory, converts it and loads the
    file leaves no module of JAX, orbax or the JAX package imported."""
    path, _ = saved["finetune_linear"]
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tools')!r})\n"
        "import torch_port_orbax_to_pth as T\n"
        "from uncertainty_vit_tpu_torch.utils import checkpoint as C\n"
        f"assert T.main([{path!r}, {str(tmp_path / 'x.pth')!r}]) == 0\n"
        f"assert len(C.read_weights({path!r})) == len(C.read_weights("
        f"{str(tmp_path / 'x.pth')!r}))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'orbax', 'uncertainty_vit_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "a finetune state" in proc.stdout


def test_without_tensorstore_the_reader_names_the_converter(saved, monkeypatch):
    """Where tensorstore is missing (the card's machine) the reader raises,
    naming the converter, and so does every driver path that reads a
    directory; a .pth still loads."""
    path, _ = saved["finetune_linear"]
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(RuntimeError, match="tools/torch_port_orbax_to_pth.py"):
        O.read_orbax_tree(path)
    with pytest.raises(RuntimeError, match="tools/torch_port_orbax_to_pth.py"):
        C.read_weights(path)


def _layout_copy(src, dst, edit):
    shutil.copytree(src, dst)
    meta_path = os.path.join(dst, O.ORBAX_METADATA)
    with open(meta_path) as f:
        meta = json.load(f)
    edit(meta)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return dst


def _old_format(meta):
    meta["tree_metadata"] = {k: v["value_metadata"] for k, v in meta["tree_metadata"].items()}


LAYOUTS = {"zarr3": (lambda m: m.update(use_zarr3=True), r'"use_zarr3": true'),
           "no_ocdbt": (lambda m: m.update(use_ocdbt=False), r'"use_ocdbt": false'),
           "other_version": (_old_format, "key_metadata"),
           "unknown_leaf": (lambda m: next(iter(m["tree_metadata"].values()))[
               "value_metadata"].update(value_type="PyTreeDef"), "PyTreeDef")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_unknown_layouts_raise_with_their_flags(saved, tmp_path, layout):
    """A _METADATA of another layout (zarr3, no OCDBT, another orbax
    version's format, a leaf kind it does not know) raises naming it."""
    edit, words = LAYOUTS[layout]
    path = _layout_copy(saved["dist"][0], str(tmp_path / layout), edit)
    with pytest.raises(ValueError, match=words):
        O.read_orbax_tree(path)


def test_dvae_codes_equal_jax(saved):
    """The tokenizer filled from the JAX dVAE trainer's weights gives the
    JAX DiscreteVAE's codes on the same images."""
    path, variables = saved["dvae_weights"]
    images = np.random.RandomState(3).rand(4, 8, 8, 3).astype(np.float32)
    want = np.asarray(JDiscreteVAE(**S.DVAE).apply(variables, images,
                                                   method=JDiscreteVAE.get_codebook_indices))
    vae = DiscreteVAE(**S.DVAE, device="cpu")
    vae.load_state_dict(C.read_weights(path), strict=True)
    got = vae.get_codebook_indices(torch.from_numpy(images)).numpy()
    assert np.array_equal(got, want)
