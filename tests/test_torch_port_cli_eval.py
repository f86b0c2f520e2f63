"""PyTorch port: the finetune driver's evaluation from images
(``cli.finetune.main`` under ``--eval``, ``--mc_dropout``, ``--ensembles``)
against the JAX driver, on the same CIFAR-100 pickles and ``.pth`` files.

One module fixture writes the data (as tests/test_cli_integration.py does)
and two ``.pth`` files of seeded port models (``beit_test_patch16_32`` at
``--input_size 64``: the 32-pixel images go through the eval resize and
crop), then runs the JAX driver's ``main`` once per mode and the port's
``main(args, device="cpu")`` once per mode. ``--mc_dropout`` runs at
``--drop 0``, where every sample is the deterministic forward: the two
packages' masks cannot match. Tolerances: acc1 and acc5 equal (the same
count of correct images; their f32 percentages may differ in the last
ulp); every other
metric within 1e-4 (f32 forwards of two frameworks, and metric sums in
another order; tests/test_torch_port_eval.py holds the metrics alone at
1e-5). Both packages' module-global ``BOUNDED_SCORES``, which the drivers
set, are restored afterwards.
"""

import json
import math
import pickle

import numpy as np
import pytest
import torch

import uncertainty_vit_tpu.ops.flash_attention as JFA
from uncertainty_vit_tpu.cli import finetune as JFT
from uncertainty_vit_tpu.models import registry as JREG
from uncertainty_vit_tpu.models.dist_vit import DistCyclicalViT as JDistCyclical
from uncertainty_vit_tpu.models.dist_vit import DistVisionTransformer as JDistViT
from uncertainty_vit_tpu.train.engine_finetune import FinetuneState as JFinetuneState
from uncertainty_vit_tpu.utils import checkpoint as JC
from uncertainty_vit_tpu_torch.cli import common as TCOMMON
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.core.init import trunc_normal
from uncertainty_vit_tpu_torch.models import registry as TREG
from uncertainty_vit_tpu_torch.models.cyclical import CyclicalViT
from uncertainty_vit_tpu_torch.models.dist_vit import DistCyclicalViT, DistVisionTransformer
from uncertainty_vit_tpu_torch.models.mim import JointViT, MIMViT
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.utils.checkpoint import (_torch_key_for, flax_to_state_dict,
                                                      state_dict_to_flax)

METRIC_ATOL = 1e-4
N_TEST = 48
MODES = {
    "eval": [],
    "ensembles": ["--ensembles", "--ensemble_checkpoints", "{a}", "{b}"],
    "mc_dropout": ["--mc_dropout", "--mc_dropout_forwards", "3", "--drop", "0"],
}


def _pth(path, seed, num_classes=100, **overrides):
    """A .pth ({"model": state_dict}) of a seeded port model with the
    driver's default flags at --input_size 64: shared rel-pos table (drawn
    at std 0.2, so that the bias is not zero) and layer scale 0.1; the head
    drawn at std 0.5, so that the logits are well apart."""
    kw = dict(img_size=64, num_classes=num_classes, use_shared_rel_pos_bias=True,
              use_abs_pos_emb=False, init_values=0.1)
    cfg = get_preset("beit_test_patch16_32", **dict(kw, **overrides))
    gen = torch.Generator().manual_seed(seed)
    model = VisionTransformer(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("relative_position_bias_table"):
                trunc_normal(0.2, 2.0)(p, gen)
        trunc_normal(0.5, 2.0)(model.head.weight, gen)
    torch.save({"model": model.state_dict()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_eval")
    base = root / "cifar-100-python"
    base.mkdir()
    rs = np.random.RandomState(0)
    for name, n in (("train", 16), ("test", N_TEST)):
        data = rs.randint(0, 256, (n, 3072), dtype=np.uint8)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": (np.arange(n) % 100).tolist()}, f)
    a = _pth(root / "a.pth", 1)
    # a.pth's weights as the JAX package's finetune driver saves a model: an
    # orbax checkpoint-best directory of a FinetuneState
    params = state_dict_to_flax(torch.load(a)["model"])["params"]
    jax_dir = JC.save_checkpoint(str(root / "jax"), "best", JFinetuneState(
        params=params, opt_state=(), step=np.asarray(0, np.int32)))
    return {"root": str(root), "a": a, "b": _pth(root / "b.pth", 2), "out": str(root / "out"),
            "jax_dir": jax_dir}


def _argv(files, *extra):
    return ["--model", "beit_test_patch16_32", "--input_size", "64", "--data_set", "CIFAR100",
            "--data_path", files["root"], "--batch_size", "16", "--num_workers", "0",
            "--dtype", "float32", "--output_dir", files["out"], "--finetune", files["a"],
            "--eval", *[e.format(**files) for e in extra]]


@pytest.fixture(scope="module")
def runs(files):
    """{mode: (JAX driver's results, port driver's results)}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFA, "BOUNDED_SCORES", JFA.BOUNDED_SCORES)
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        mp.delenv("UVIT_ATTN_BOUNDED_SCORES", raising=False)
        for mode, extra in MODES.items():
            want = JFT.main(JFT.get_args_parser().parse_args(_argv(files, *extra)))
            got = TFT.main(TFT.get_args_parser().parse_args(_argv(files, *extra)), device="cpu")
            out[mode] = (want, got)
    return out


def _same_metrics(got, want, where):
    assert sorted(got) == sorted(want), where
    for k, v in want.items():
        assert math.isfinite(got[k]), (where, k)
        if k in ("acc1", "acc5"):
            # the same count of correct images; the f32 percentage of a count
            # may differ in its last ulp between the packages
            assert round(got[k] * N_TEST / 100) == round(v * N_TEST / 100), (where, k, got[k], v)
            assert abs(got[k] - v) <= 1e-5 * 100, (where, k, got[k], v)
        else:
            assert abs(got[k] - v) <= METRIC_ATOL, (where, k, got[k], v)


@pytest.mark.parametrize("mode", list(MODES))
def test_driver_matches_jax(runs, mode):
    """The same result dict as the JAX driver: its keys, acc1/acc5 equal
    and every other metric within 1e-4."""
    want, got = runs[mode]
    assert list(got) == list(want) == [mode]
    if mode == "ensembles":
        assert len(got[mode]["members"]) == len(want[mode]["members"]) == 2
        for i, (g, w) in enumerate(zip(got[mode]["members"], want[mode]["members"])):
            _same_metrics(g, w, f"member {i}")
        _same_metrics(got[mode]["ensemble"], want[mode]["ensemble"], "ensemble")
        assert got[mode]["members"][0] != got[mode]["members"][1]
    else:
        _same_metrics(got[mode], want[mode], mode)
    json.dumps(got)  # printable as the JAX driver prints it


def test_mc_dropout_at_rate_zero_is_the_plain_eval(runs):
    """With --drop 0 the MC mean is the deterministic forward: the port's
    two runs agree to the metrics' last sums."""
    _, eval_got = runs["eval"]
    _, mc_got = runs["mc_dropout"]
    for k, v in mc_got["mc_dropout"].items():
        assert abs(v - eval_got["eval"][k]) <= 1e-6, k


def test_drivers_set_bounded_scores(files):
    """The finetune driver turns the bounded softmax on, as the JAX driver
    does; the environment variable overrides it either way."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFA, "BOUNDED_SCORES", False)
        mp.delenv("UVIT_ATTN_BOUNDED_SCORES", raising=False)
        TCOMMON.setup(bounded_scores_default=True)
        assert TFA.BOUNDED_SCORES is True
        mp.setenv("UVIT_ATTN_BOUNDED_SCORES", "0")
        TCOMMON.setup(bounded_scores_default=True)
        assert TFA.BOUNDED_SCORES is False
        mp.setenv("UVIT_ATTN_BOUNDED_SCORES", "1")
        TCOMMON.setup(bounded_scores_default=False)
        assert TFA.BOUNDED_SCORES is True
        mp.setenv("UVIT_ATTN_LSE_BF16", "1")
        with pytest.raises(NotImplementedError, match="lse"):
            TCOMMON.setup(bounded_scores_default=True)


# (name, extra flags, a function of the files dir writing the checkpoint)
IMPORT_CASES = {
    "head_mismatch": ([], lambda d: _pth(d / "c10.pth", 3, num_classes=10)),
    "shared_to_per_block": (["--per_block_rel_pos_bias", "True", "--rel_pos_bias", "False"],
                            lambda d: _pth(d / "shared.pth", 4)),
    "model_prefix": (["--model_prefix", "backbone."], lambda d: _prefixed(d / "pre.pth", 5)),
    "reinit_final_norm": (["--reinit_final_norm"], lambda d: _pth(d / "norm.pth", 6)),
    "pos_embed_resize": (["--abs_pos_emb", "True"],
                         lambda d: _pth(d / "pos48.pth", 7, img_size=48, use_abs_pos_emb=True)),
}


def _prefixed(path, seed):
    _pth(path, seed)
    sd = torch.load(str(path))["model"]
    torch.save({"module": {"backbone." + k: v for k, v in sd.items()}}, str(path))
    return str(path)


@pytest.mark.parametrize("case", list(IMPORT_CASES))
def test_checkpoint_import_matches_jax(tmp_path, files, case, capsys):
    """The import of a .pth through both drivers' ``load_variables``: the
    same missing entries (JAX paths mapped to the port's keys), the same
    printed missing / unused counts, and the same weights everywhere the
    checkpoint filled them."""
    extra, write = IMPORT_CASES[case]
    path = write(tmp_path)
    argv = _argv(files, *extra)
    argv[argv.index("--finetune") + 1] = path
    jargs = JFT.get_args_parser().parse_args(argv)
    targs = TFT.get_args_parser().parse_args(argv)
    jmodel, _ = JFT.build_model(jargs, 100)
    sample = np.zeros((2, 64, 64, 3), np.float32)
    variables, jmissing = JFT.load_variables(jargs, jmodel, sample, return_missing=True)
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    model, _ = TFT.build_model(targs, 100, device="cpu")
    missing = TFT.load_variables(targs, model)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == jline and line.startswith("imported")
    assert sorted(missing) == sorted(_torch_key_for(tuple(p.split("/")))[0] for p in jmissing)
    expect_missing = {"head_mismatch": ["head.bias", "head.weight"],
                      "reinit_final_norm": ["fc_norm.bias", "fc_norm.weight"]}
    assert sorted(missing) == expect_missing.get(case, [])
    want = flax_to_state_dict(jax_numpy(variables["params"]))
    got = model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        if k not in missing:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=k)


def jax_numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def test_dual_finetune_raises_on_a_mismatched_head(tmp_path, files):
    """--dual_finetune keeps the checkpoint's head verbatim, so a head of
    another class count raises in both drivers."""
    path = _pth(tmp_path / "c10.pth", 3, num_classes=10)
    argv = _argv(files, "--dual_finetune")
    argv[argv.index("--finetune") + 1] = path
    jargs = JFT.get_args_parser().parse_args(argv)
    with pytest.raises(ValueError, match="dual_finetune"):
        JFT.load_variables(jargs, JFT.build_model(jargs, 100)[0], np.zeros((1, 64, 64, 3)))
    targs = TFT.get_args_parser().parse_args(argv)
    with pytest.raises(ValueError, match="dual_finetune"):
        TFT.load_variables(targs, TFT.build_model(targs, 100, device="cpu")[0])


# the attention variants under --seq_parallel: the Gumbel-drawing ones raise
# naming ROADMAP.md item 20's rest; the sinkformer runs since slice 18 (the
# evaluations, MC-dropout and the heads run there: test_torch_port_seq_eval.py)
SEQ_NOT_PORTED = ["--sinkformer", "--gumbel_softmax", "--h_sto_trans"]
NOT_PORTED = [
    *[["--seq_parallel", "2", flag] for flag in SEQ_NOT_PORTED],
    ["--ensembles", "--ensemble_checkpoints", "{jax_dir}", "{b}"],
]


def _case_id(extra):
    if extra[0] == "--seq_parallel":
        return "seq_parallel_" + extra[2].lstrip("-")
    return extra[0].lstrip("-") + "_orbax"


@pytest.mark.parametrize("extra", NOT_PORTED, ids=_case_id)
def test_unported_flags_raise(files, runs, extra):
    """Every flag whose feature is not ported raises NotImplementedError
    naming where the ROADMAP ports it; none is silently ignored. Under
    --seq_parallel the Gumbel-drawing attention variants raise before the
    ranks start, naming item 20's rest; the sinkformer, ported there since
    slice 18, gives one process's result (its column steps' logsumexp over
    both ranks' query rows). An orbax ensemble member of the JAX package, which
    raised here before ROADMAP.md item 23, is read: a.pth's weights saved
    by the JAX package give the .pth member's results to the bit, and the
    JAX driver's on the same directory."""
    args = TFT.get_args_parser().parse_args(_argv(files, *extra))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        if extra[0] == "--ensembles":
            mp.setattr(JFA, "BOUNDED_SCORES", JFA.BOUNDED_SCORES)
            got = TFT.main(args, device="cpu")["ensembles"]
            assert got == runs["ensembles"][1]["ensembles"]
            want = JFT.main(JFT.get_args_parser().parse_args(_argv(files, *extra)))
            for i, (g, w) in enumerate(zip(got["members"], want["ensembles"]["members"])):
                _same_metrics(g, w, f"member {i}")
            _same_metrics(got["ensemble"], want["ensembles"]["ensemble"], "ensemble")
            return
        if extra[2:] == ["--sinkformer"]:
            got = TFT.main(args, device="cpu")["eval"]
            one = _argv(files, "--sinkformer")
            want = TFT.main(TFT.get_args_parser().parse_args(one), device="cpu")["eval"]
            for k, v in want.items():
                assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
            return
        match = "ROADMAP.md item 20's rest" if extra[0] == "--seq_parallel" else "ROADMAP.md"
        with pytest.raises(NotImplementedError, match=match):
            TFT.main(args, device="cpu")


# what --seq_parallel still refuses, before the ranks start: (extra flags,
# whether they train, the error and its words; None: it reaches the ranks)
SEQ_REFUSED = {
    "mc_dropout_attn_drop": (["--mc_dropout", "--attn_drop_rate", "0.1"], False, ValueError,
                             "sequence-parallel attention requires attn_drop=0"),
    "adahessian_train": (["--opt", "adahessian"], True, None, None),
}


@pytest.mark.parametrize("case", sorted(SEQ_REFUSED))
def test_seq_parallel_refusals_before_the_ranks_start(files, case):
    """Under --seq_parallel 2: MC-dropout with attention dropout raises the
    JAX package's ValueError (its seq-sharded attention refuses a drawing
    forward with attn_drop > 0, models/layers.py:353-358), before any rank
    starts (``run_ranks`` is replaced by a failure). AdaHessian training,
    which runs on a seq group since slice 18, runs on the mesh's data axis
    too since slice 19 (``main(..., mesh=(2, 2, 1))`` reaches the ranks)."""
    extra, trains, error, words = SEQ_REFUSED[case]
    argv = _argv(files, "--seq_parallel", "2", *extra)
    if trains:
        argv.remove("--eval")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        args = TFT.get_args_parser().parse_args(argv)
        mesh = (2, 2, 1) if trains else None
        if error is None:
            mp.setattr(TFT.seq, "run_ranks", lambda *a, **k: ["the ranks started"])
            assert TFT.main(args, device="cpu", mesh=mesh) == "the ranks started"
            return
        mp.setattr(TFT.seq, "run_ranks", lambda *a, **k: pytest.fail("the ranks started"))
        with pytest.raises(error, match=words):
            TFT.main(args, device="cpu", mesh=mesh)


def test_training_and_orbax_checkpoints_raise(files, runs):
    """Without --eval the driver trains (tests/test_torch_port_cli_train.py):
    attention dropout under --seq_parallel raises there before any rank
    starts, with the JAX package's words. A --resume that is not a .pth is
    an orbax train state of the JAX package, whose optax state does not
    cross packages: it raises. A --finetune that is not a .pth is an orbax
    checkpoint too, read since ROADMAP.md item 23: a.pth's weights saved by
    the JAX package evaluate as a.pth does, to the bit."""
    argv = _argv(files)
    argv.remove("--eval")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        with pytest.raises(ValueError, match="sequence-parallel attention requires attn_drop=0"):
            TFT.main(TFT.get_args_parser().parse_args(
                argv + ["--seq_parallel", "2", "--attn_drop_rate", "0.1"]), device="cpu")
        with pytest.raises(NotImplementedError, match=r"--resume .*\.pth"):
            TFT.main(TFT.get_args_parser().parse_args(
                argv + ["--resume", files["root"] + "/checkpoint-3", "--epochs", "1"]),
                device="cpu")
        argv = _argv(files)
        argv[argv.index("--finetune") + 1] = files["jax_dir"]
        assert TFT.main(TFT.get_args_parser().parse_args(argv), device="cpu") == runs["eval"][1]


def test_parsers_take_the_jax_flags():
    """Every flag of the JAX driver's parser parses in the port's, with the
    same default."""
    jp, tp = JFT.get_args_parser(), TFT.get_args_parser()
    jflags = {s: a.default for a in jp._actions for s in a.option_strings}
    tflags = {s: a.default for a in tp._actions for s in a.option_strings}
    assert set(jflags) == set(tflags)
    differ = {s for s in jflags if jflags[s] != tflags[s]}
    assert differ == {"--device"}, differ  # "tpu" there, a no-op; "cuda" only here


@pytest.mark.parametrize("value", ["cpu", "cuda:1", "tpu"])
def test_device_flag_takes_only_the_card(files, value):
    """--device parses as in the JAX driver, but the port's driver runs on
    the one card: any other value raises instead of being ignored."""
    args = TFT.get_args_parser().parse_args(_argv(files, "--device", value))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        with pytest.raises(NotImplementedError, match="one card"):
            TFT.main(args, device="cpu")


def test_build_model_follows_the_flags(files):
    """--quant, --target_layer, --remove_final_norm, --use_cls and --dtype
    reach the model's config."""
    args = TFT.get_args_parser().parse_args(_argv(
        files, "--quant", "int8", "--target_layer", "0", "--remove_final_norm", "--use_cls",
        "--dtype", "bfloat16"))
    model, cfg = TFT.build_model(args, 7, device="cpu")
    assert (cfg.quant, cfg.depth, cfg.remove_final_norm, cfg.use_mean_pooling) == (
        "int8", 1, True, False)
    assert model.dtype == torch.bfloat16 and cfg.num_classes == 7
    jcfg = JFT.build_model(JFT.get_args_parser().parse_args(_argv(
        files, "--quant", "int8", "--target_layer", "0", "--remove_final_norm", "--use_cls")),
        7)[1]
    assert _fields(cfg) == _fields(jcfg)


def _fields(cfg):
    return {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}


def test_mc_mean_forward_draws_fresh_masks(files):
    """The -C/-P MC forward of the driver: at rate 0 the deterministic
    forward; at rate 0.3 each call draws new masks from the --seed stream,
    reproducibly."""
    images = torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    args = TFT.get_args_parser().parse_args(_argv(files, "--drop", "0.3",
                                                  "--mc_dropout_forwards", "2"))
    model, _ = TFT.build_model(args, 100, device="cpu")
    fwd = TFT._mc_mean_forward(args, model)
    a, b = fwd(images), fwd(images)
    assert a.shape == (4, 100) and not torch.equal(a, b)
    assert torch.equal(TFT._mc_mean_forward(args, model)(images), a)
    args.drop = 0.0
    model0, _ = TFT.build_model(args, 100, device="cpu")
    model0.load_state_dict(model.state_dict())
    det = TFT._default_eval_forward(args, model0)(images)
    torch.testing.assert_close(TFT._mc_mean_forward(args, model0)(images), det)


def test_create_model_matches_jax():
    """The registry's finetune, cyclical, MIM and joint families, their
    configs equal to the JAX registry's (a 1-deep ViT-B/16 224 to keep it
    cheap; the MIM, joint and dist models on the meta device); a dist_*
    name builds the dist models in the finetune and cyclical families, as
    the JAX registry does."""
    model, cfg = TREG.create_model("beit_base_patch16_224", depth=1, num_classes=10,
                                   device="cpu")
    _, jcfg = JREG.create_model("beit_base_patch16_224", depth=1, num_classes=10)
    assert isinstance(model, VisionTransformer) and len(model.blocks) == 1
    assert _fields(cfg) == _fields(jcfg)
    model, cfg = TREG.create_model("beit_base_patch16_224", "cyclical", depth=1, device="cpu")
    _, jcfg = JREG.create_model("beit_base_patch16_224", "cyclical", depth=1)
    assert isinstance(model, CyclicalViT) and len(model.blocks) == 1
    assert _fields(cfg) == _fields(jcfg) and cfg.head_type == "none"
    for name, cls in (("beit_base_patch16_224_8k_vocab", MIMViT),
                      ("beit_base_joint_patch16_224", JointViT)):
        model, cfg = TREG.create_model(name, depth=1, device="meta")
        _, jcfg = JREG.create_model(name, depth=1)
        assert isinstance(model, cls) and len(model.blocks) == 1
        assert _fields(cfg) == _fields(jcfg) and cfg.head_type == "none"
    for family, cls, jcls in ((None, DistVisionTransformer, JDistViT),
                              ("cyclical", DistCyclicalViT, JDistCyclical)):
        model, cfg = TREG.create_model("dist_beit_base_patch16_224", family, depth=1,
                                       device="meta")
        jmodel, jcfg = JREG.create_model("dist_beit_base_patch16_224", family, depth=1)
        assert isinstance(model, cls) and isinstance(jmodel, jcls) and len(model.blocks) == 1
        assert _fields(cfg) == _fields(jcfg)
    with pytest.raises(ValueError):
        TREG.create_model("vit_tiny", device="cpu")


def test_driver_runs_as_a_module():
    """``python -m uncertainty_vit_tpu_torch.cli.finetune`` is the entry
    point (its --help here; on a host without a card, an --eval run raises,
    as the driver builds on the card)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "uncertainty_vit_tpu_torch.cli.finetune",
                           "--help"], cwd=repo, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--ensemble_checkpoints" in proc.stdout and "--quant" in proc.stdout
