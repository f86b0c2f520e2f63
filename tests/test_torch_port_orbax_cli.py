"""PyTorch port: the drivers' paths that take an orbax checkpoint directory
of the JAX package (``--finetune DIR``, ``--ensemble_checkpoints DIR``,
``--discrete_vae_weight_path DIR``) against the JAX drivers on the same
directories, and the JAX behaviours the port does not copy (ROADMAP.md §3).

The module fixture trains with the JAX finetune driver as
tests/test_cli_eval_paths.py:93-115 does (2 epochs of 1 step, a checkpoint
each: the two ensemble members, ``checkpoint-best`` beside them) on seeded
CIFAR-100 pickles, and saves the other states with the JAX package's
``save_checkpoint`` (tests/orbax_states.py). Tolerances: the drivers'
metrics as tests/test_torch_port_cli_eval.py holds them (acc equal, the
rest within 1e-4); a forward's logits rtol 2e-4 / atol 2e-5 (two
frameworks' f32 forwards); a directory and its converted ``.pth`` equal to
the bit.
"""

import math
import os
import pickle
import sys

import flax.errors
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbax_states as S
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)
import uncertainty_vit_tpu.ops.flash_attention as JFA
from uncertainty_vit_tpu.cli import builders as JB
from uncertainty_vit_tpu.cli import finetune as JFT
from uncertainty_vit_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from uncertainty_vit_tpu.utils import checkpoint as JC
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.cli import pretrain_beit as PB
from uncertainty_vit_tpu_torch.cli import pretrain_cyclical as PC
from uncertainty_vit_tpu_torch.evals.classification import make_eval_forward
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.utils.checkpoint import _torch_key_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_port_orbax_to_pth as TOOL  # noqa: E402

N_TEST = 48
METRIC_ATOL = 1e-4
FWD = dict(rtol=2e-4, atol=2e-5)
CIFAR_CLASSES = 100
DVAE_FLAGS = ["--second_input_size", "8", "--vocab_size", "64", "--dvae_num_layers", "2",
              "--dvae_hidden_dim", "8"]


@pytest.fixture
def restore_globals():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFA, "BOUNDED_SCORES", JFA.BOUNDED_SCORES)
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        mp.delenv("UVIT_ATTN_BOUNDED_SCORES", raising=False)
        yield


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The data, the JAX driver's checkpoints and the saved states:
    {"root", "out", "members", "sngp", "cyclical", "mim", "head10",
    "dvae_weights", "dvae_epoch"}."""
    root = tmp_path_factory.mktemp("orbax_cli")
    base = root / "cifar-100-python"
    base.mkdir()
    rs = np.random.RandomState(0)
    for name, n in (("train", 32), ("test", N_TEST)):
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (n, 3072), dtype=np.uint8),
                         b"fine_labels": (np.arange(n) % CIFAR_CLASSES).tolist()}, f)
    out = str(root / "jax_train")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFA, "BOUNDED_SCORES", JFA.BOUNDED_SCORES)
        JFT.main(JFT.get_args_parser().parse_args(S.driver_argv(
            str(root), out, "--epochs", "2", "--steps_per_epoch", "1", "--warmup_epochs", "0",
            "--mixup", "0", "--cutmix", "0", "--save_ckpt_freq", "1")))
    saved = str(root / "states")
    argv = S.driver_argv(str(root), out)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "NUM_CLASSES", CIFAR_CLASSES)
        sngp = S.finetune_state(argv + ["--sngp"], sngp_batches=3)
    dvae = JDiscreteVAE(image_size=8, num_tokens=64, num_layers=2, hidden_dim=8)
    dvae_vars = jax.jit(dvae.init)(jax.random.PRNGKey(5), jnp.zeros((2, 8, 8, 3)))
    return {
        "root": str(root), "out": out,
        "members": [os.path.join(out, "checkpoint-0"), os.path.join(out, "checkpoint-1")],
        "sngp": (S.save(saved, "sngp", sngp), sngp),
        "cyclical": S.save(saved, "cyclical", S.cyclical_state()),
        "mim": S.save(saved, "mim", S.mim_state()),
        "head10": S.save(saved, "head10", S.finetune_state(argv)),
        "dvae_weights": (JC.save_checkpoint(saved, "dvae-weights", dvae_vars), dvae_vars),
        "dvae_epoch": S.save(saved, "dvae_epoch", {
            "variables": dvae_vars, "opt_state": (), "step": jnp.asarray(3, jnp.int32)}),
    }


def _argv(run, *extra):
    """The driver's flags (training unless ``extra`` holds --eval)."""
    return S.driver_argv(run["root"], os.path.join(run["root"], "eval_out"), *extra)


def _same_metrics(got, want, where):
    assert sorted(got) == sorted(want), where
    for k, v in want.items():
        assert math.isfinite(got[k]), (where, k)
        if k in ("acc1", "acc5"):
            assert round(got[k] * N_TEST / 100) == round(v * N_TEST / 100), (where, k, got[k], v)
        else:
            assert abs(got[k] - v) <= METRIC_ATOL, (where, k, got[k], v)


@pytest.mark.parametrize("mode", ["eval", "ensembles"])
def test_eval_from_jax_directories_matches_the_jax_driver(run, mode, restore_globals):
    """``--eval --finetune DIR`` (the JAX driver's last checkpoint) and
    ``--ensembles`` of its two epochs' checkpoints: the port's results are
    the JAX driver's on the same directories."""
    extra = ["--eval", "--finetune", run["members"][1]]
    if mode == "ensembles":
        extra += ["--ensembles", "--ensemble_checkpoints", *run["members"]]
    want = JFT.main(JFT.get_args_parser().parse_args(_argv(run, *extra)))
    got = TFT.main(TFT.get_args_parser().parse_args(_argv(run, *extra)), device="cpu")
    assert list(got) == list(want) == [mode]
    if mode == "ensembles":
        for i, (g, w) in enumerate(zip(got[mode]["members"], want[mode]["members"])):
            _same_metrics(g, w, f"member {i}")
        _same_metrics(got[mode]["ensemble"], want[mode]["ensemble"], "ensemble")
        assert got[mode]["members"][0] != got[mode]["members"][1]
    else:
        _same_metrics(got[mode], want[mode], mode)


def _port_model(run, *extra):
    args = TFT.get_args_parser().parse_args(_argv(run, *extra))
    model, _ = TFT.build_model(args, CIFAR_CLASSES, device="cpu")
    return args, model


def _images(n=8, seed=4):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def _port_logits(model, images):
    return make_eval_forward(model)(torch.from_numpy(images)).numpy()


def _jax_load(run, *extra):
    args = JFT.get_args_parser().parse_args(_argv(run, *extra))
    model, _ = JFT.build_model(args, CIFAR_CLASSES)
    variables, missing = JFT.load_variables(args, model, jnp.zeros((2, 32, 32, 3)),
                                            return_missing=True)
    return model, variables, missing


def _jax_forward(model):
    return jax.jit(lambda v, x: model.apply(v, x, deterministic=True))


def test_directory_and_its_converted_pth_load_the_same_tensors(run, tmp_path):
    """--finetune DIR and --finetune OUT.pth (the converter's) load the
    same tensors and give the same logits to the bit; the directory counts
    the head as missing (the JAX orbax branch's rule), the .pth does not."""
    pth = str(tmp_path / "best.pth")
    best = os.path.join(run["out"], "checkpoint-best")
    assert TOOL.main([best, pth]) == 0
    args, from_dir = _port_model(run, "--finetune", best)
    missing_dir = TFT.load_variables(args, from_dir)
    args, from_pth = _port_model(run, "--finetune", pth)
    missing_pth = TFT.load_variables(args, from_pth)
    assert missing_dir == ["head.bias", "head.weight"] and missing_pth == []
    a, b = from_dir.state_dict(), from_pth.state_dict()
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    images = _images()
    assert np.array_equal(_port_logits(from_dir, images), _port_logits(from_pth, images))


def test_orbax_branch_takes_the_jax_drivers_rules(run, capsys):
    """The JAX driver's orbax branch: the checkpoint's parameters kept
    whole, the head named missing (so --linear_classifier trains the same
    leaves), --model_prefix and --reinit_final_norm not applied. The port's
    weights and logits are the JAX driver's."""
    ck = run["members"][1]
    flags = ("--finetune", ck, "--model_prefix", "backbone.", "--reinit_final_norm")
    jmodel, variables, jmissing = _jax_load(run, *flags)
    args, model = _port_model(run, *flags)
    missing = TFT.load_variables(args, model)
    assert missing == sorted(_torch_key_for(tuple(p.split("/")))[0] for p in jmissing)
    _, plain = _port_model(run, "--finetune", ck)
    TFT.load_variables(TFT.get_args_parser().parse_args(_argv(run, "--finetune", ck)), plain)
    assert all(torch.equal(v, plain.state_dict()[k]) for k, v in model.state_dict().items())
    images = _images()
    want = np.asarray(_jax_forward(jmodel)(variables, jnp.asarray(images)))
    np.testing.assert_allclose(_port_logits(model, images), want, **FWD)
    # --linear_classifier's trainable leaves: the head alone in both drivers
    jtrain = sorted(_torch_key_for(tuple(str(p.key) for p in path))[0]
                    for path, _ in jax.tree_util.tree_flatten_with_path(variables["params"])[0]
                    if any(t in "/".join(str(p.key) for p in path) for t in jmissing))
    assert jtrain == sorted(k for k, _ in model.named_parameters()
                            if any(t in k for t in missing)) == ["head.bias", "head.weight"]


def test_sngp_buffers_are_carried_where_jax_drops_them(run, capsys):
    """A --sngp FinetuneState whose power-iteration vectors and precision
    matrix moved in training: the JAX driver's orbax branch replaces the
    params only and evaluates with freshly initialised ones (its logits
    differ from the same model in memory); the port carries the stored
    buffers, and its logits are the in-memory model's (ROADMAP.md §3)."""
    path, state = run["sngp"]
    jmodel, from_dir, _ = _jax_load(run, "--sngp", "--finetune", path)
    in_memory = {"params": state.params, "spectral_stats": state.spectral_stats,
                 "sngp_state": state.sngp_state, "sngp_frozen": state.sngp_frozen}
    images = jnp.asarray(_images())
    forward = _jax_forward(jmodel)
    want = np.asarray(forward(in_memory, images))
    dropped = np.asarray(forward(from_dir, images))
    jax_diff = float(np.abs(dropped - want).max() / np.abs(want).max())
    args, model = _port_model(run, "--sngp", "--finetune", path)
    TFT.load_variables(args, model)
    got = _port_logits(model, np.array(images))
    np.testing.assert_allclose(got, want, **FWD)
    for name in ("u", "v"):
        assert not np.array_equal(np.asarray(from_dir["spectral_stats"]["fc_norm_sn"][name]),
                                  np.asarray(state.spectral_stats["fc_norm_sn"][name]))
    print(f"JAX --finetune DIR --sngp: max|logit diff| / max|logit| against the model in "
          f"memory {jax_diff:.4e}")
    assert jax_diff > 1e-3


@pytest.mark.parametrize("case", ["cyclical", "mim", "head10"])
def test_trees_the_jax_driver_cannot_apply_take_the_pth_surgery(run, case):
    """A pretraining state (no ``head``, ``lm_head`` beside the trunk) or a
    head of another class count: the JAX driver puts the tree in as it is
    and its forward raises (flax finds no head, or a head of another
    shape); the port imports it with its .pth surgery's rules: the trunk
    from the checkpoint, the model's own head (and fc_norm where the tree
    has none) counted missing, the tree's other heads unused."""
    path = run[case]
    jmodel, variables, _ = _jax_load(run, "--finetune", path)
    error = (flax.errors.ScopeParamShapeError if case == "head10"
             else flax.errors.ScopeParamNotFoundError)
    with pytest.raises(error):
        jmodel.apply(variables, jnp.zeros((2, 32, 32, 3)), deterministic=True)
    args, model = _port_model(run, "--finetune", path)
    missing = TFT.load_variables(args, model)
    assert {"head.weight", "head.bias"} <= set(missing)
    if case != "head10":
        assert {"fc_norm.weight", "fc_norm.bias"} <= set(missing)
    sd = TFT.C.read_weights(path)
    trunk = [k for k in sd if k.startswith("blocks.") and "relative_position" not in k]
    assert trunk and all(torch.equal(model.state_dict()[k], sd[k]) for k in trunk)
    assert np.isfinite(_port_logits(model, _images())).all()


def _dvae_args(path):
    return PB.get_args_parser().parse_args([
        "--data_path", "unused", "--discrete_vae_type", "customized",
        "--discrete_vae_weight_path", path, *DVAE_FLAGS])


def test_dvae_directories_into_the_beit_tokenizer(run):
    """--discrete_vae_weight_path: the JAX dVAE trainer's
    checkpoint-dvae-weights through the BEiT pretrainer's builder gives the
    codes of the JAX DiscreteVAE restored from it as the JAX builder
    restores it (onto its variables, cli/builders.py:457). Its per-epoch
    state ({"variables", "opt_state", "step"}) the JAX builder cannot
    restore (orbax refuses the other tree); the port reads its variables,
    the same weights."""
    path, variables = run["dvae_weights"]
    images = np.random.RandomState(6).rand(4, 8, 8, 3).astype(np.float32)
    jdvae = JDiscreteVAE(image_size=8, num_tokens=64, num_layers=2, hidden_dim=8)
    codes = jax.jit(lambda v, x: jdvae.apply(v, x, method=JDiscreteVAE.get_codebook_indices))
    want = np.asarray(codes(JC.restore_checkpoint(path, variables), images))
    vae = PB.B.build_discrete_vae(_dvae_args(path), None, "cpu")
    assert np.array_equal(vae.get_codebook_indices(torch.from_numpy(images)).numpy(), want)
    with pytest.raises(ValueError):
        JB.build_discrete_vae(_dvae_args(run["dvae_epoch"]), jax.random.PRNGKey(0),
                              jnp.zeros((2, 8, 8, 3)))
    epoch = PB.B.build_discrete_vae(_dvae_args(run["dvae_epoch"]), None, "cpu")
    assert all(torch.equal(v, vae.state_dict()[k]) for k, v in epoch.state_dict().items())


@pytest.mark.parametrize("path", ["finetune", "ensemble_member", "dvae"])
def test_without_tensorstore_every_path_names_the_converter(run, path, tmp_path, monkeypatch,
                                                            restore_globals):
    """On a machine without tensorstore (the card's) each driver path that
    reads a directory raises, naming the converter; none goes on without
    the weights it was given (the ensemble case's --finetune is a .pth)."""
    pth = str(tmp_path / "member0.pth")
    TOOL.main([run["members"][0], pth])
    argv = {"finetune": ["--eval", "--finetune", run["members"][0]],
            "ensemble_member": ["--eval", "--finetune", pth, "--ensembles",
                                "--ensemble_checkpoints", pth, run["members"][1]]}.get(path)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(RuntimeError, match="tools/torch_port_orbax_to_pth.py"):
        if argv is None:
            PB.B.build_discrete_vae(_dvae_args(run["dvae_weights"][0]), None, "cpu")
        else:
            TFT.main(TFT.get_args_parser().parse_args(_argv(run, *argv)), device="cpu")


def test_train_states_of_jax_do_not_resume(run, tmp_path, restore_globals):
    """--resume DIR and --auto_resume over an output directory holding the
    JAX driver's checkpoint-N directories raise, naming ROADMAP.md item 23:
    the optax state does not cross packages. The cyclical pretrainer
    refuses a directory for --finetune / --seed_model, which the JAX one
    ignores."""
    train = [a for a in _argv(run, "--epochs", "3", "--steps_per_epoch", "1")]
    train[train.index("--output_dir") + 1] = run["out"]
    with pytest.raises(NotImplementedError, match="item 23"):
        TFT.main(TFT.get_args_parser().parse_args(train), device="cpu")
    train[train.index("--output_dir") + 1] = str(tmp_path)
    with pytest.raises(NotImplementedError, match="item 23"):
        TFT.main(TFT.get_args_parser().parse_args(train + ["--resume", run["members"][0]]),
                 device="cpu")
    args = PC.get_args_parser().parse_args([
        "--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
        "--data_path", run["root"], "--output_dir", str(tmp_path), "--seed_model",
        run["members"][0], "--num_workers", "0"])
    with pytest.raises(NotImplementedError, match="torch_port_orbax_to_pth"):
        PC.main(args, device="cpu")
