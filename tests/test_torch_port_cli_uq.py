"""PyTorch port: slice 8 through the finetune driver (``cli.finetune.main``
with ``device="cpu"``) against the JAX driver on the same CIFAR-100
pickles, ``.pth`` file and CIFAR-C / -P ``.npy`` files.

One module fixture writes the data and a ``.pth`` of a seeded port model
(``beit_test_patch16_32``: 2 blocks of width 32, the plain attention, at
--input_size 32), then runs each JAX driver dispatch once and the port's
once: ``--temp_scaling`` on its three fit splits, ``--laplace`` (probit),
``--corrupted_data`` over two seeded distortions (plain and ``--laplace``),
``--perturbed_data`` over two seeded perturbations (the harness's list cut
to them in both packages: the JAX driver reads every one it lists) and
``--visualize_embedding``. Tolerances: acc1 / acc5 equal; every other
metric within 1e-4 (f32 forwards of two frameworks, sums in another
order); the chosen prior precision equal and T* equal or one point of
the final grid away (grid points, where the NLL is flat); the -C / -P
dicts equal; the embedding TSVs within 1e-5.

The heads: an ``--sngp`` epoch trains in the port, then ``--eval`` from its
``checkpoint-0.pth`` is held against the JAX driver's dispatch given the
same weights and buffers (mapped onto its variables); at
``--sngp_cov_momentum 0`` the precision matrix restarts at the second
epoch, and an auto-resumed run gives back every parameter and buffer of the
checkpoint. ``--het_layer --eval`` draws from the port's generators, so its
metrics are held against a recomputation from its own logits. Both
packages' ``BOUNDED_SCORES``, which the drivers set, are restored.
"""

import io
import math
import os
import pickle
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax

import uncertainty_vit_tpu.ops.flash_attention as JFA
from uncertainty_vit_tpu.cli import finetune as JFT
from uncertainty_vit_tpu.evals import robustness as JR
from uncertainty_vit_tpu_torch.cli import builders as TB
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.evals import metrics as TM
from uncertainty_vit_tpu_torch.evals import robustness as TR
from uncertainty_vit_tpu_torch.evals.classification import make_eval_forward
from uncertainty_vit_tpu_torch.evals.collect import collect_logits, per_call_generator
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.utils import checkpoint as TC

N_TRAIN, N_TEST, BATCH = 32, 40, 16
METRIC_ATOL = 1e-4
# the widest log step of fit_temperature's final grid: the first pass's
# bracket spans two coarse steps, cut into 63
FINE_STEP = 2 * math.log(20.0 / 0.05) / 63 / 63 * 1.001
DISTORTIONS = ("gaussian_noise", "contrast")
PERTURBATIONS = ("shot_noise", "tilt")  # one against frame 0, one against the frame before
MODES = {
    "temp_eval": ["--temp_scaling"],
    "temp_train": ["--temp_scaling", "--temp_scaling_split", "train"],
    "temp_heldout": ["--temp_scaling", "--temp_scaling_split", "heldout",
                     "--temp_scaling_heldout_frac", "0.25"],
    "laplace": ["--laplace"],
    "corrupted": ["--corrupted_data", "--corruption_data_path", "{c}"],
    "corrupted_laplace": ["--corrupted_data", "--corruption_data_path", "{c}", "--laplace"],
    "perturbed": ["--perturbed_data", "--perturbation_data_path", "{p}"],
}


@pytest.fixture(autouse=True)
def restore_bounded_scores():
    prev = (JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    yield
    JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_uq")
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
    np.save(cdir / "labels.npy", np.arange(24) % 100)
    for d in DISTORTIONS:
        np.save(cdir / f"{d}.npy", rs.randint(0, 256, (24, 32, 32, 3), dtype=np.uint8))
    for p in PERTURBATIONS:
        np.save(pdir / f"{p}.npy", rs.randint(0, 256, (5, 4, 32, 32, 3), dtype=np.uint8))
    cfg = get_preset("beit_test_patch16_32", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)
    gen = torch.Generator().manual_seed(1)
    model = VisionTransformer(cfg, device="cpu", generator=gen)
    with torch.no_grad():  # logits well apart, a rel-pos bias that is not zero
        model.head.weight.normal_(0.0, 0.5, generator=gen)
        model.rel_pos_bias.relative_position_bias_table.normal_(0.0, 0.2, generator=gen)
    torch.save({"model": model.state_dict()}, str(root / "a.pth"))
    return {"root": str(root), "pth": str(root / "a.pth"), "c": str(cdir), "p": str(pdir),
            "out": str(root / "out")}


def _argv(files, *extra):
    return ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
            "--data_path", files["root"], "--batch_size", str(BATCH), "--num_workers", "0",
            "--dtype", "float32", "--output_dir", files["out"], "--finetune", files["pth"],
            "--eval", *[e.format(**files) for e in extra]]


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


def _same_metrics(got, want, where, n):
    assert sorted(got) == sorted(want), where
    for k, v in want.items():
        assert math.isfinite(got[k]), (where, k)
        if k in ("acc1", "acc5"):
            assert round(got[k] * n / 100) == round(v * n / 100), (where, k, got[k], v)
        elif k == "temperature":
            # a grid point; where the fit set's NLL is flat at its minimum, the
            # f32 curves of two frameworks may pick the neighbouring point of
            # the final grid (log spacing ~3e-3 over [0.05, 20])
            assert abs(math.log(got[k] / v)) <= FINE_STEP, (where, k, got[k], v)
        elif k in ("prior_precision", "heldout_fit_samples"):
            assert got[k] == v, (where, k, got[k], v)
        else:
            assert abs(got[k] - v) <= METRIC_ATOL, (where, k, got[k], v)


@pytest.mark.parametrize("mode", ["temp_eval", "temp_train", "temp_heldout", "laplace"])
def test_posthoc_eval_matches_jax(runs, mode):
    """--temp_scaling on each split and --laplace: the JAX driver's result
    dict (the prior precision equal, T* equal or the neighbouring point of
    the final grid, metrics within 1e-4)."""
    want, got, printed = runs[mode]
    key = "laplace" if mode == "laplace" else "temp_scaling"
    assert list(got) == list(want) == [key]
    n = N_TEST - (N_TEST // 4 if mode == "temp_heldout" else 0)
    _same_metrics(got[key], want[key], mode, n)
    if key == "temp_scaling":
        assert f"temperature scaling: T* = {got[key]['temperature']:.4f}" in printed
        assert got[key]["temperature"] != runs["temp_train"][1]["temp_scaling"]["temperature"] \
            or mode == "temp_train"
    else:
        assert f"laplace: fit on {N_TRAIN} samples" in printed


@pytest.mark.parametrize("mode", ["corrupted", "corrupted_laplace", "perturbed"])
def test_robustness_eval_matches_jax(runs, mode):
    """-C (plain and under the Laplace predictive) and -P: equal dicts; the
    distortions without files are skipped with the JAX message."""
    want, got, printed = runs[mode]
    assert got == want
    if mode.startswith("corrupted"):
        per = got["corruption"]["per_distortion"]
        assert sorted(per) == sorted(DISTORTIONS)
        assert "skipping distortions with no data" in printed
    else:
        assert sorted(got["perturbation"]["per_perturbation"]) == sorted(PERTURBATIONS)


def test_corruption_eval_runs_the_mc_and_ensemble_forwards(files):
    """-C under --mc_dropout at rate 0 (every sample the deterministic
    forward) and --ensembles of one member: the plain -C result."""
    plain, _ = _quiet(TFT.main, TFT.get_args_parser().parse_args(
        _argv(files, *[e for e in MODES["corrupted"]])), device="cpu")
    for extra in (["--mc_dropout", "--mc_dropout_forwards", "2", "--drop", "0"],
                  ["--ensembles", "--ensemble_checkpoints", files["pth"]]):
        got, _ = _quiet(TFT.main, TFT.get_args_parser().parse_args(
            _argv(files, *MODES["corrupted"], *extra)), device="cpu")
        assert got == plain, extra


@pytest.mark.parametrize("extra,match", [
    (["--laplace", "--mc_dropout"], "--laplace composes"),
    (["--laplace", "--perturbed_data"], "--laplace composes"),
    (["--temp_scaling", "--corrupted_data"], "--temp_scaling supports"),
    (["--temp_scaling", "--laplace"], "--temp_scaling supports"),
])
def test_refused_combinations_match_jax(files, extra, match):
    for ft in (JFT, TFT):
        args = ft.get_args_parser().parse_args(_argv(files, *extra))
        kw = {"device": "cpu"} if ft is TFT else {}
        with pytest.raises(ValueError, match=match):
            _quiet(ft.main, args, **kw)


def test_laplace_refuses_the_uncertainty_heads(files):
    args = TFT.get_args_parser().parse_args(_argv(files, "--laplace", "--gp_layer"))
    with pytest.raises(ValueError, match="needs the linear head"):
        _quiet(TFT.main, args, device="cpu")


def test_visualize_embedding_matches_jax(files, tmp_path):
    """The TSVs of the JAX driver and the port's: labels equal, features
    within 1e-5; the driver returns the directory."""
    outs = {}
    for name, ft, kw in (("jax", JFT, {}), ("port", TFT, {"device": "cpu"})):
        argv = _argv(files, "--visualize_embedding")
        argv[argv.index("--output_dir") + 1] = str(tmp_path / name)
        outs[name], printed = _quiet(ft.main, ft.get_args_parser().parse_args(argv), **kw)
        assert f"embeddings written to {outs[name]}" in printed
    for tsv, atol in (("embeddings.tsv", 1e-5), ("embeddings_labels.tsv", 0)):
        want = np.loadtxt(os.path.join(outs["jax"], tsv))
        got = np.loadtxt(os.path.join(outs["port"], tsv))
        assert got.shape == want.shape and got.shape[0] == N_TEST
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the heads through the driver
# ---------------------------------------------------------------------------

def jax_variables_from_state(template, state):
    """A port state_dict as the JAX model's variables of ``template``'s
    tree: each leaf from the port's key for its path (``_torch_key_for``),
    the [out, in] weights and the OIHW conv weight laid out back."""

    def leaf(path, value):
        names = tuple(str(getattr(p, "key", p)) for p in path)[1:]  # drop the collection
        key, tf = TC._torch_key_for(names)
        v = state[key].detach().cpu().numpy()
        return {"linear_w": lambda a: a.T, "conv_w": lambda a: a.transpose(2, 3, 1, 0)}.get(
            tf, lambda a: a)(v)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(template))


def _train_argv(files, out, *extra):
    argv = _argv(files, "--epochs", "1", "--steps_per_epoch", "2", "--save_ckpt_freq", "1",
                 "--warmup_epochs", "1", "--layer_decay", "0.65", *extra)
    argv.remove("--eval")
    argv[argv.index("--output_dir") + 1] = str(out)
    return argv


def test_sngp_epoch_then_eval_matches_jax(files, tmp_path):
    """An --sngp epoch (the SNGP head and the spectral fc_norm) in the port:
    checkpoint-0.pth holds every parameter and buffer of both, the
    precision matrix and (u, v) moved. --eval from it in the port against
    the JAX driver's dispatch on the same weights and buffers: acc equal,
    metrics within 1e-4."""
    out = tmp_path / "sngp"
    _quiet(TFT.main, TFT.get_args_parser().parse_args(_train_argv(files, out, "--sngp")),
           device="cpu")
    ckpt = str(out / "checkpoint-0.pth")
    state = TC.load_torch_state_dict(ckpt)
    for key in ("fc_norm.weight_orig", "fc_norm.bias", "fc_norm.weight_u", "fc_norm.weight_v",
                "head._gp_input_normalize_layer.weight", "head._gp_input_normalize_layer.bias",
                "head._random_feature.weight", "head._random_feature.bias",
                "head._gp_output_layer.weight", "head.precision_matrix"):
        assert key in state, key
    assert not torch.equal(state["head.precision_matrix"], 1e-3 * torch.eye(32))
    argv = _argv(files, "--sngp")
    argv[argv.index("--finetune") + 1] = ckpt
    got, printed = _quiet(TFT.main, TFT.get_args_parser().parse_args(argv), device="cpu")
    assert "imported" in printed and " 0 missing" in printed
    jargs = JFT.get_args_parser().parse_args(argv)
    jmodel, _ = JFT.build_model(jargs, 100)
    template = jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))
    variables = jax_variables_from_state(template, state)
    val_loader, _ = JFT.B.build_loaders(jargs, is_train=False)
    want, _ = _quiet(JFT.run_eval_dispatch, jargs, jmodel, variables, val_loader, 100)
    assert list(got) == list(want) == ["eval"]
    _same_metrics(got["eval"], want["eval"], "sngp", N_TEST)


def test_sngp_exact_cov_resets_each_epoch_and_resumes(files, tmp_path):
    """--sngp_cov_momentum 0: at each epoch's start the precision matrix is
    ridge·I (read before the epoch's first step); a run of 2 epochs that
    auto-resumes from checkpoint-0.pth restores every parameter and buffer
    of it bit for bit."""
    out = tmp_path / "exact"
    seen = []
    make_step = TFT.make_finetune_train_step

    def watching(model, *a, **k):
        step = make_step(model, *a, **k)

        def watched(state, *args):
            seen.append((state.step, model.head.precision_matrix.clone()))
            return step(state, *args)

        return watched

    restored = []
    auto_load = TFT.C.auto_load

    def recording_auto_load(output_dir, state):
        state, epoch = auto_load(output_dir, state)
        restored.append({k: v.clone() for k, v in state.model.state_dict().items()})
        return state, epoch

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFT, "make_finetune_train_step", watching)
        mp.setattr(TFT.C, "auto_load", recording_auto_load)
        argv = _train_argv(files, out, "--gp_layer", "--sngp_cov_momentum", "0")
        _quiet(TFT.main, TFT.get_args_parser().parse_args(argv), device="cpu")
        saved = TC.load_torch_state_dict(str(out / "checkpoint-0.pth"))
        argv[argv.index("--epochs") + 1] = "2"
        _quiet(TFT.main, TFT.get_args_parser().parse_args(argv), device="cpu")
    ridge = 1e-3 * torch.eye(32)
    assert [s for s, _ in seen] == [0, 1, 2, 3]
    assert torch.equal(seen[0][1], ridge) and torch.equal(seen[2][1], ridge)
    assert not torch.equal(seen[1][1], ridge)
    got = restored[-1]
    assert list(got) == list(saved)
    assert all(torch.equal(got[k], saved[k]) for k in saved)
    assert not torch.equal(saved["head.precision_matrix"], ridge)


def test_het_eval_metrics_match_its_own_logits(files):
    """--het_layer --eval: reproducible from --seed, another seed draws
    other noise, and the printed metrics are those of the logits the same
    forward gives batch by batch from the --seed stream (within 1e-6)."""
    argv = _argv(files, "--het_layer")
    got, _ = _quiet(TFT.main, TFT.get_args_parser().parse_args(argv), device="cpu")
    again, _ = _quiet(TFT.main, TFT.get_args_parser().parse_args(argv), device="cpu")
    other, _ = _quiet(TFT.main, TFT.get_args_parser().parse_args(argv + ["--seed", "5"]),
                      device="cpu")
    assert got == again and got != other
    args = TFT.get_args_parser().parse_args(argv)
    model, cfg = TFT.build_model(args, 100, device="cpu")
    assert cfg.head_type == "het"
    TFT.load_variables(args, model)
    loader, _ = TB.build_loaders(args, is_train=False)
    fwd = make_eval_forward(model, het=True)
    fresh = per_call_generator(args.seed, "cpu")
    logits, labels = collect_logits(lambda x: fwd(x, fresh()),
                                    TFT._eval_batches(loader, args, torch.device("cpu")))
    assert logits.shape == (N_TEST, 100) and np.all(logits <= 0)
    want = {k: float(v) for k, v in TM.classification_metrics(
        torch.from_numpy(logits), torch.from_numpy(labels)).items()}
    want["loss"] = want["nll"]
    assert sorted(got["eval"]) == sorted(want)
    for k, v in want.items():
        assert abs(got["eval"][k] - v) <= 1e-6 * max(1.0, abs(v)), k


def test_head_flags_reach_the_config(files):
    """--het_layer, --gp_layer, --sngp and --sngp_cov_momentum map onto the
    config as the JAX builders map them."""
    for extra in (["--het_layer"], ["--gp_layer"], ["--sngp", "--sngp_cov_momentum", "0"]):
        args = TFT.get_args_parser().parse_args(_argv(files, *extra))
        jargs = JFT.get_args_parser().parse_args(_argv(files, *extra))
        cfg = TB.model_config_from_args(args, 10)
        jcfg = JFT.B.model_config_from_args(jargs, 10)
        assert {k: getattr(cfg, k) for k in cfg.__dataclass_fields__} == {
            k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__}
