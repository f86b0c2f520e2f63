"""PyTorch port: the dist (mean+covariance) model through the drivers,
``cli.finetune --stochastic`` (training, ``--eval``, ``--corrupted_data``,
``--perturbed_data``) and ``cli.pretrain_cyclical --stochastic``, against
the JAX drivers on the same CIFAR-100 pickles, ``.pth`` file and CIFAR-C /
-P ``.npy`` files.

The drivers run ``beit_test_patch16_32`` (2 blocks of width 32, two heads,
32×32 images) with ``main(args, device="cpu")``. One module fixture writes
the data and a ``.pth`` of a seeded port ``DistVisionTransformer`` and runs
each JAX evaluation dispatch once beside the port's (the perturbation
harness's list cut to two in both packages, as
tests/test_torch_port_cli_uq.py cuts it). Tolerances: acc1 / acc5 equal,
every other metric within 1e-4 (f32 forwards of two frameworks); the -C /
-P dicts equal. A training run resumed from its checkpoint equals the
uninterrupted run bit for bit (the per-step generators, the loader's order
and the triplet negatives are functions of (seed, epoch, step); the
loaders run without worker threads). Both packages' ``BOUNDED_SCORES``,
which the drivers set, are restored after each test.
"""

import copy
import io
import json
import math
import os
import pickle
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as JFA
from uncertainty_vit_tpu.cli import finetune as JFT
from uncertainty_vit_tpu.evals import robustness as JR
from uncertainty_vit_tpu.train import engine_finetune_dist as JED
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu.utils import checkpoint as JC
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.cli import pretrain_cyclical as P
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.evals import metrics as TM
from uncertainty_vit_tpu_torch.evals import robustness as TR
from uncertainty_vit_tpu_torch.models.dist_vit import DistCyclicalViT, DistVisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.utils import checkpoint as C
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

N_TRAIN, N_TEST, BATCH = 48, 32, 16
METRIC_ATOL = 1e-4
DISTORTIONS = ("gaussian_noise", "contrast")
PERTURBATIONS = ("shot_noise", "tilt")
MODES = {
    "eval": [],
    "corrupted": ["--corrupted_data", "--corruption_data_path", "{c}"],
    "perturbed": ["--perturbed_data", "--perturbation_data_path", "{p}"],
}


@pytest.fixture(autouse=True)
def restore_bounded_scores():
    prev = (JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    yield
    JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_dist")
    base = root / "cifar-100-python"
    base.mkdir()
    rs = np.random.RandomState(0)
    for name, n in (("train", N_TRAIN), ("test", N_TEST)):
        data = rs.randint(0, 256, (n, 3072), dtype=np.uint8)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": (np.arange(n) % 100).tolist()}, f)
    cdir, pdir = root / "cifar-c", root / "cifar-p"
    cdir.mkdir()
    pdir.mkdir()
    # one batch shape a dispatch: 16 corrupted images, 4 videos of 4 frames
    np.save(cdir / "labels.npy", np.arange(16) % 100)
    for d in DISTORTIONS:
        np.save(cdir / f"{d}.npy", rs.randint(0, 256, (16, 32, 32, 3), dtype=np.uint8))
    for p in PERTURBATIONS:
        np.save(pdir / f"{p}.npy", rs.randint(0, 256, (4, 4, 32, 32, 3), dtype=np.uint8))
    cfg = get_preset("beit_test_patch16_32", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)
    gen = torch.Generator().manual_seed(1)
    model = DistVisionTransformer(cfg, device="cpu", generator=gen)
    with torch.no_grad():  # logits well apart, a rel-pos bias that is not zero
        model.head.weight.normal_(0.0, 0.5, generator=gen)
        model.rel_pos_bias.relative_position_bias_table.normal_(0.0, 0.2, generator=gen)
    torch.save({"model": model.state_dict()}, str(root / "dist.pth"))
    return {"root": str(root), "pth": str(root / "dist.pth"), "c": str(cdir), "p": str(pdir),
            "out": str(root / "out")}


def _argv(files, *extra, eval_=True):
    return ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
            "--data_path", files["root"], "--batch_size", str(BATCH), "--num_workers", "0",
            "--dtype", "float32", "--output_dir", files["out"], "--finetune", files["pth"],
            "--stochastic", *(["--eval"] if eval_ else []),
            *[e.format(**files) for e in extra]]


def _quiet(fn, *a, **k):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*a, **k)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def runs(files):
    """{mode: (JAX driver's results, port driver's results, port's stdout)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFA, "BOUNDED_SCORES", JFA.BOUNDED_SCORES)
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        mp.delenv("UVIT_ATTN_BOUNDED_SCORES", raising=False)
        mp.setattr(JR, "PERTURBATIONS", PERTURBATIONS)
        mp.setattr(TR, "PERTURBATIONS", PERTURBATIONS)
        for mode, extra in MODES.items():
            want, _ = _quiet(JFT.main, JFT.get_args_parser().parse_args(_argv(files, *extra)))
            got, printed = _quiet(TFT.main, TFT.get_args_parser().parse_args(
                _argv(files, *extra)), device="cpu")
            out[mode] = (want, got, printed)
    return out


def test_eval_stochastic_matches_jax(runs, files):
    """--eval --stochastic: the JAX driver's "dist_eval" dict, the metrics
    of the deterministic forward's logits (no loss key); acc equal, the
    rest within 1e-4; the import's line printed as JAX prints it."""
    want, got, printed = runs["eval"]
    assert list(got) == list(want) == ["dist_eval"]
    assert sorted(got["dist_eval"]) == sorted(want["dist_eval"])
    assert "loss" not in got["dist_eval"]
    for k, v in want["dist_eval"].items():
        g = got["dist_eval"][k]
        assert math.isfinite(g), k
        if k in ("acc1", "acc5"):
            assert round(g * N_TEST / 100) == round(v * N_TEST / 100), (k, g, v)
        else:
            assert abs(g - v) <= METRIC_ATOL, (k, g, v)
    assert f"imported {files['pth']}: 0 missing, 0 unused" in printed


@pytest.mark.parametrize("mode", ["corrupted", "perturbed"])
def test_robustness_eval_stochastic_matches_jax(runs, mode):
    """--stochastic with -C and -P: the logits are output [2] of the dist
    model's deterministic forward in both drivers; equal dicts."""
    want, got, _ = runs[mode]
    assert got == want
    key = "corruption" if mode == "corrupted" else "perturbation"
    per = got[key]["per_distortion" if mode == "corrupted" else "per_perturbation"]
    assert sorted(per) == sorted(DISTORTIONS if mode == "corrupted" else PERTURBATIONS)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train(files, out, *extra):
    argv = _argv(files, "--save_ckpt_freq", "1", "--steps_per_epoch", "1", "--warmup_epochs",
                 "1", "--layer_decay", "0.65", "--drop_path", "0.2", "--drop", "0.1",
                 "--attn_drop_rate", "0.1", "--lambda_finetuning", "0.3", "--lambda_pvn", "0.3",
                 *extra, eval_=False)
    argv[argv.index("--output_dir") + 1] = str(out)
    argv[argv.index("--batch_size") + 1] = "8"
    return _quiet(TFT.main, TFT.get_args_parser().parse_args(argv), device="cpu")


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _jax_step_metric_names(jargs):
    """The JAX dist step's metric names, from jax.eval_shape of its step
    (the step without the transform hooks names the same metrics)."""
    jmodel, _ = JFT.build_model(jargs, 100)
    x = jnp.zeros((2, 32, 32, 3))
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)["params"]
    import optax

    tx = optax.adamw(1e-3)
    state = JED.DistFinetuneState(params=params, opt_state=jax.eval_shape(tx.init, params),
                                  step=jnp.zeros([], jnp.int32))
    step = JED.make_dist_finetune_train_step(jmodel, tx, JED.DistFinetuneHParams(),
                                             JS.constant_schedule(1e-3))
    labels = jnp.zeros((2,), jnp.int32)
    return set(jax.eval_shape(step, state, x, x, x, labels, jax.random.PRNGKey(0))[1])


def test_stochastic_training_log_checkpoints_and_resume(files, tmp_path):
    """Two epochs of one triplet step from the .pth (the default train
    transform, mixup / cutmix, drop-path, dropout and attention dropout on):
    finite losses; log.txt's records under the JAX step's metric names and
    the dist evaluation's test metrics (no test_loss); checkpoint-{0,1,best}
    .pth. A run stopped after epoch 0 and auto-resumed equals the
    uninterrupted run: model, AdamW state and step."""
    straight, printed = _train(files, tmp_path / "straight", "--epochs", "2")
    assert straight.step == 2 and isinstance(straight.model, DistVisionTransformer)
    assert "0 missing, 0 unused" in printed
    log = _log(tmp_path / "straight")
    jargs = JFT.get_args_parser().parse_args(_argv(files, eval_=False))
    train_keys = {f"train_{k}" for k in _jax_step_metric_names(jargs)}
    test_keys = {f"test_{k}" for k in TM.classification_metrics(
        torch.zeros(2, 3), torch.zeros(2, dtype=torch.int64))}
    assert [r["epoch"] for r in log] == [0, 1]
    for r in log:
        assert set(r) == {"epoch", "best_acc1"} | train_keys | test_keys
        assert all(math.isfinite(r[k]) for k in train_keys | test_keys)
        assert r["train_wasserstein_loss"] > 0
    assert {"checkpoint-0.pth", "checkpoint-1.pth", "checkpoint-best.pth"} <= set(
        os.listdir(tmp_path / "straight"))
    want = {"model": copy.deepcopy(straight.model.state_dict()),
            "optimizer": copy.deepcopy(straight.optimizer.state_dict())}
    _train(files, tmp_path / "split", "--epochs", "1")
    resumed, _ = _train(files, tmp_path / "split", "--epochs", "2")
    assert resumed.step == 2 and [r["epoch"] for r in _log(tmp_path / "split")] == [0, 1]
    for k, v in want["model"].items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    got_opt = resumed.optimizer.state_dict()["state"]
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got_opt[i][k], v), (i, k)


def test_pretrain_cyclical_stochastic_and_the_handoff_to_finetune(files, tmp_path, capsys):
    """cli.pretrain_cyclical --stochastic for an epoch of two steps: the
    dist model as student and teacher, finite losses, log.txt, and a
    checkpoint whose "model_ema" is the teacher's dist tensors. Its
    checkpoint through cli.finetune --stochastic --finetune: the missing
    and unused keys, and the printed line, those of the JAX driver's
    load_variables on its dist finetune model (missing fc_norm and the
    head; unused the mask tokens, norm, lm_head and cov_lm_head)."""
    out = tmp_path / "pre"
    args = P.get_args_parser().parse_args([
        "--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
        "--data_path", files["root"], "--batch_size", "8", "--num_workers", "0",
        "--dtype", "float32", "--output_dir", str(out), "--steps_per_epoch", "2",
        "--warmup_epochs", "1", "--target_layers", "[0,1]", "--num_mask_patches", "2",
        "--min_mask_patches_per_block", "1", "--clip_grad", "3.0", "--drop_path", "0.25",
        "--attn_drop_rate", "0.05", "--post_target_layer_norm", "--lambda_pretraining", "0.5",
        "--epochs", "1", "--stochastic"])
    state, _ = _quiet(P.main, args, device="cpu")
    assert state.step == 2
    assert isinstance(state.model, DistCyclicalViT) and isinstance(state.teacher, DistCyclicalViT)
    log = _log(out)
    assert len(log) == 1 and all(math.isfinite(v) for v in log[0].values())
    blob = torch.load(str(out / "checkpoint-0.pth"), weights_only=False)
    assert "cov_mask_token" in blob["model_ema"] and "cov_lm_head.weight" in blob["model"]

    pth = str(out / "checkpoint-0.pth")
    argv = _argv(files)
    argv[argv.index("--finetune") + 1] = pth
    jargs = JFT.get_args_parser().parse_args(argv)
    targs = TFT.get_args_parser().parse_args(argv)
    jmodel, _ = JFT.build_model(jargs, 100)
    images = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    capsys.readouterr()
    variables, jmissing = JFT.load_variables(jargs, jmodel, images, return_missing=True)
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    model, _ = TFT.build_model(targs, 100, device="cpu")
    missing = TFT.load_variables(targs, model)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == jline
    _, _, unused = C.import_torch_state_dict(C.load_torch_state_dict(pth), model.state_dict())
    _, _, junused = JC.import_torch_params(JC.load_torch_state_dict(pth), variables["params"])
    jkeys = sorted(C._torch_key_for(tuple(p.split("/")))[0] for p in jmissing)
    assert sorted(missing) == jkeys == ["fc_norm.bias", "fc_norm.weight", "head.bias",
                                        "head.weight"]
    assert sorted(unused) == sorted(junused) == [
        "cov_lm_head.bias", "cov_lm_head.weight", "cov_mask_token", "lm_head.bias",
        "lm_head.weight", "mask_token", "norm.bias", "norm.weight"]


FINETUNE_RAISES = [
    ["--model_ema"], ["--quant", "int8"], ["--masked_position_prob", "0.1"], ["--sngp"],
    ["--gp_layer"], ["--het_layer"], ["--learn_layer_weights"], ["--layernorm_before_combine"],
    ["--remove_final_norm"], ["--abs_pos_emb", "True"], ["--per_block_rel_pos_bias", "True"],
    ["--dropout_from_block", "1"], ["--sinkformer"], ["--gumbel_softmax"], ["--h_sto_trans"],
    ["--init_scale", "0.01"], ["--mc_dropout"], ["--ensembles"],
    ["--visualize_embedding"], ["--laplace"], ["--temp_scaling"],
]
RAISES = (
    [("finetune", e, "does not read it") for e in FINETUNE_RAISES]
    + [("finetune", ["--seq_parallel", "2"], "not wired for --stochastic"),
       ("finetune_no_flag", [], "pass --stochastic"),
       ("finetune_train", ["--decode_letterbox", "True"], "decode_letterbox")]
    + [("cyclical", e, m) for e, m in (
        (["--gp_layer"], "only supported by the non-stochastic"),
        (["--quant", "int8"], "does not read it"), (["--abs_pos_emb", "True"], "does not read it"),
        (["--per_block_rel_pos_bias", "True"], "does not read it"),
        (["--dropout_from_block", "1"], "does not read it"), (["--sngp"], "does not read it"),
        (["--het_layer"], "does not read it"), (["--sinkformer"], "does not read it"),
        (["--layer_results", "fc"], "does not read it"))]
)


def _raise_id(case):
    return f"{case[0]}-{'_'.join(a.lstrip('-') for a in case[1]) or 'dist_model'}"


@pytest.mark.parametrize("case", RAISES, ids=[_raise_id(c) for c in RAISES])
def test_flags_the_dist_model_does_not_read_raise(files, tmp_path, case):
    """Under --stochastic every flag the JAX drivers ignore there (the dist
    model does not read it, or the dispatch would run another model on its
    weights) raises ValueError, as do --seq_parallel (JAX's words), a dist
    --model without the flag, and --decode_letterbox in triplet training;
    in the cyclical driver --gp_layer with JAX's words."""
    where, extra, match = case
    if where == "cyclical":
        args = P.get_args_parser().parse_args([
            "--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
            "--data_path", files["root"], "--batch_size", "8", "--num_workers", "0",
            "--output_dir", str(tmp_path), "--stochastic", *extra])
        fn = P.main
    else:
        argv = _argv(files, *extra, eval_=where != "finetune_train")
        if where == "finetune_no_flag":
            argv.remove("--stochastic")
            argv[argv.index("--model") + 1] = "dist_beit_base_patch16_224"
        args, fn = TFT.get_args_parser().parse_args(argv), TFT.main
    with pytest.raises(ValueError, match=match):
        _quiet(fn, args, device="cpu")
