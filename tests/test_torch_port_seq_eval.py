"""PyTorch port: the finetune driver's evaluations under --seq_parallel 2
(MC-dropout folded and split, the SNGP / GP and heteroscedastic heads, -C,
-P, --laplace, --temp_scaling, --visualize_embedding) against one process
and against the JAX driver, and K8's row window.

One module fixture writes seeded CIFAR-100, CIFAR-C and CIFAR-P files and
a ``.pth`` of a seeded ``beit_test_patch16_32`` (2 blocks of width 32, N =
5 tokens, split 3 | 2 over two ranks), as tests/test_torch_port_cli_uq.py
does, trains an --sngp and a --het_layer epoch of 2 steps in one process,
then starts two gloo ranks once (``parallel.seq.run_ranks``) that run
every case through ``cli.finetune.run_rank`` in turn: the same two epochs
and each dispatch. While they run, the parent runs each dispatch in one
process and the JAX driver's where the dispatch draws nothing. Held:
rank 0's result against the one process's (acc1 / acc5 equal, every other
number within 1e-5; MC-dropout too, since K8 draws the unsharded masks'
rows), and against the JAX driver's at tests/test_torch_port_cli_uq.py's
tolerances; the two-rank epochs' parameters against one process's; each
fit's sample count on both ranks (every rank holds every sample, so no fit
counts one twice); rank 0 alone writes the embeddings.

The ranks import this module by name, so the JAX package is imported only
inside fixtures. Both packages' ``BOUNDED_SCORES``, which the drivers set,
are restored.
"""

import io
import math
import os
import pickle
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.evals import calibration as TCAL
from uncertainty_vit_tpu_torch.evals import robustness as TR
from uncertainty_vit_tpu_torch.models import layers as TL
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import dropout as DO
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.parallel import seq
from uncertainty_vit_tpu_torch.utils import checkpoint as TC

N_TRAIN, N_TEST, BATCH = 32, 40, 16
# every number but the counts within TOL · max(1, |value|): ranks against one
# process (f32 sums cut at another row), and against the JAX driver
# (tests/test_torch_port_cli_uq.py's 1e-4 on metrics below 1)
ATOL = 1e-5
JAX_ATOL = 1e-4
# the widest log step of fit_temperature's final grid
FINE_STEP = 2 * math.log(20.0 / 0.05) / 63 / 63 * 1.001
DISTORTIONS = ("gaussian_noise", "contrast")
PERTURBATIONS = ("shot_noise", "tilt")
MC = ["--mc_dropout", "--mc_dropout_forwards", "3", "--drop", "0.3"]
TRAIN = ["--epochs", "1", "--steps_per_epoch", "2", "--save_ckpt_freq", "1",
         "--warmup_epochs", "1", "--layer_decay", "0.65"]
# name → (extra flags, whether the JAX driver runs it: the dispatch draws
# nothing and its weights cross by its import); "{sngp}" / "{het}" are the
# one-process epochs' checkpoints (a later --finetune wins), the SNGP one
# held against JAX apart
EVALS = {
    "eval": ([], True),
    "mc_folded": (MC, False),
    "mc_split": (MC + ["--mc_dropout_split_at", "1", "--dropout_from_block", "1"], False),
    "sngp": (["--sngp", "--finetune", "{sngp}"], False),
    "gp_layer": (["--gp_layer"], False),
    "het": (["--het_layer", "--finetune", "{het}"], False),
    "temp_eval": (["--temp_scaling"], True),
    "temp_train": (["--temp_scaling", "--temp_scaling_split", "train"], True),
    "temp_heldout": (["--temp_scaling", "--temp_scaling_split", "heldout",
                      "--temp_scaling_heldout_frac", "0.25"], True),
    "laplace": (["--laplace"], True),
    "laplace_mc_link": (["--laplace", "--laplace_link", "mc"], False),
    "corrupted": (["--corrupted_data", "--corruption_data_path", "{c}"], True),
    "corrupted_mc": (["--corrupted_data", "--corruption_data_path", "{c}", *MC], False),
    "corrupted_laplace": (["--corrupted_data", "--corruption_data_path", "{c}", "--laplace"],
                          True),
    "perturbed": (["--perturbed_data", "--perturbation_data_path", "{p}"], True),
    "perturbed_mc": (["--perturbed_data", "--perturbation_data_path", "{p}", *MC], False),
    "embedding": (["--visualize_embedding"], True),
}
EPOCHS = {"sngp_train": ["--sngp"], "het_train": ["--het_layer"]}


@pytest.fixture(autouse=True)
def restore_bounded_scores():
    import uncertainty_vit_tpu.ops.flash_attention as JFA

    prev = (JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    yield
    JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


def _argv(files, name, s, *extra, train=False):
    argv = ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
            "--data_path", files["root"], "--batch_size", str(BATCH), "--num_workers", "0",
            "--dtype", "float32", "--output_dir", os.path.join(files["root"], f"s{s}_{name}"),
            "--finetune", files["pth"], *([] if train else ["--eval"]),
            *[e.format(**files) for e in extra], "--seq_parallel", str(s)]
    return argv


def _cases(files, s):
    """(name, argv, whether it trains): the two epochs, then every dispatch."""
    return ([(name, _argv(files, name, s, *extra, *TRAIN, train=True), True)
             for name, extra in EPOCHS.items()]
            + [(name, _argv(files, name, s, *extra), False)
               for name, (extra, _) in EVALS.items()])


def _result(res, trains):
    """What a run hands back: a training run's parameters and buffers."""
    if trains and res is not None:
        return {k: v.detach().clone() for k, v in res.model.state_dict().items()}
    return res


def _seq_rank(group, cases):
    """One rank: every case through ``run_rank``, what ``main`` runs on each
    rank. Returns {name: (result, stdout)} (rank 0's results; None on rank 1)
    and what the fits saw: each Laplace fit's sample count and factors, each
    temperature fit's sample count, each embedding dump."""
    torch.set_num_threads(1)
    TR.PERTURBATIONS = PERTURBATIONS
    seen = {"laplace": [], "temperature": [], "embedding_dumps": 0}
    fit_laplace, fit_temperature = TFT.LA.fit_last_layer_laplace, TCAL.fit_temperature
    dump = TFT.EMB.visualize_embedding

    def recorded_laplace(*a, **k):
        la = fit_laplace(*a, **k)
        seen["laplace"].append((la.n, float(la.a.sum()), float(la.g.sum()), la.loglik))
        return la

    def recorded_temperature(logits, labels, *a, **k):
        seen["temperature"].append(len(labels))
        return fit_temperature(logits, labels, *a, **k)

    def recorded_dump(*a, **k):  # counts the calls that wrote a dump
        out = dump(*a, **k)
        seen["embedding_dumps"] += out is not None
        return out

    TFT.LA.fit_last_layer_laplace, TCAL.fit_temperature = recorded_laplace, recorded_temperature
    TFT.EMB.visualize_embedding = recorded_dump
    out = {}
    for name, argv, trains in cases:
        buf = io.StringIO()
        with redirect_stdout(buf):
            res = TFT.run_rank(group, TFT.get_args_parser().parse_args(argv), "cpu")
        out[name] = (_result(res, trains), buf.getvalue())
    return out, seen


class _Ranks(threading.Thread):
    def __init__(self, cases):
        super().__init__(daemon=True)
        self.cases, self.result, self.error = cases, None, None

    def run(self):
        try:
            self.result = seq.run_ranks(_seq_rank, 2, self.cases, timeout=600.0)
        except BaseException as e:  # raised in the fixture
            self.error = e


def _quiet(fn, *a, **k):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*a, **k)
    return out, buf.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_eval")
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
            "sngp": str(root / "s1_sngp_train" / "checkpoint-0.pth"),
            "het": str(root / "s1_het_train" / "checkpoint-0.pth")}


@pytest.fixture(scope="module")
def runs(files):
    """{"s2": rank results, "seen": both ranks' fits, "s1": one process's
    {name: (result, stdout)}, "jax": the JAX driver's {name: result}}."""
    import uncertainty_vit_tpu.ops.flash_attention as JFA
    from uncertainty_vit_tpu.cli import finetune as JFT
    from uncertainty_vit_tpu.evals import robustness as JR

    out = {"s1": {}, "jax": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFA, "BOUNDED_SCORES", JFA.BOUNDED_SCORES)
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        mp.delenv("UVIT_ATTN_BOUNDED_SCORES", raising=False)
        mp.setattr(JR, "PERTURBATIONS", PERTURBATIONS)
        mp.setattr(TR, "PERTURBATIONS", PERTURBATIONS)
        cases = _cases(files, 1)
        for name, argv, trains in cases[:len(EPOCHS)]:  # the checkpoints the evals read
            res, printed = _quiet(TFT.main, TFT.get_args_parser().parse_args(argv), device="cpu")
            out["s1"][name] = (_result(res, trains), printed)
        ranks = _Ranks(_cases(files, 2))
        ranks.start()
        try:
            for name, argv, trains in cases[len(EPOCHS):]:
                out["s1"][name] = _quiet(TFT.main, TFT.get_args_parser().parse_args(argv),
                                         device="cpu")
            for name, (extra, with_jax) in EVALS.items():
                if with_jax:
                    argv = _argv(files, name, 1, *extra)
                    argv[argv.index("--output_dir") + 1] += "_jax"
                    out["jax"][name], _ = _quiet(JFT.main, JFT.get_args_parser().parse_args(
                        _jax_argv(argv)))
        finally:
            ranks.join()
    if ranks.error is not None:
        raise ranks.error
    (out["s2"], seen0), (rank1, seen1) = ranks.result
    out["seen"] = (seen0, seen1)
    out["rank1"] = rank1
    return out


def _jax_argv(argv):
    """The JAX driver's flags: the port's with --seq_parallel 1 dropped."""
    i = argv.index("--seq_parallel")
    return argv[:i] + argv[i + 2:]


def _close(got, want, where, atol, n=N_TEST):
    """Nested results: the same keys; acc1 / acc5 equal as counts; T* equal
    or one point of the final grid away; the prior precision and sample
    counts equal; every other number within ``atol`` · max(1, |want|)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}", atol, n)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]", atol, n)
    elif isinstance(want, str):
        assert got == want, where
    else:
        got, want = float(got), float(want)
        assert math.isfinite(got), where
        key = where.rsplit(".", 1)[-1]
        if key in ("acc1", "acc5"):
            assert round(got * n / 100) == round(want * n / 100), (where, got, want)
        elif key == "temperature":
            assert abs(math.log(got / want)) <= FINE_STEP, (where, got, want)
        elif key in ("prior_precision", "heldout_fit_samples"):
            assert got == want, (where, got, want)
        else:
            assert abs(got - want) <= atol * max(1.0, abs(want)), (where, got, want)


def _n(name):
    return N_TEST - (N_TEST // 4 if name == "temp_heldout" else 0)


@pytest.mark.parametrize("name", [n for n in EVALS if n != "embedding"])
def test_two_ranks_equal_one_process(runs, name):
    """Rank 0's result dict under --seq_parallel 2 against the same dispatch
    in one process: MC-dropout's masks are the same (K8's row window), the
    heads' noise the same stream."""
    (got, printed), (want, _) = runs["s2"][name], runs["s1"][name]
    assert list(got) == list(want)
    _close(got, want, name, ATOL, _n(name))
    assert runs["rank1"][name][0] is None and runs["rank1"][name][1] == ""
    assert "imported" in printed


@pytest.mark.parametrize("name", [n for n, (_, j) in EVALS.items() if j and n != "embedding"])
def test_two_ranks_match_the_jax_driver(runs, name):
    """Where the dispatch draws nothing: rank 0's result against the JAX
    driver's at tests/test_torch_port_cli_uq.py's tolerances (-C and -P
    dicts equal)."""
    got, want = runs["s2"][name][0], runs["jax"][name]
    if name.startswith(("corrupted", "perturbed")):
        assert got == want
    else:
        _close(got, want, name, JAX_ATOL, _n(name))


@pytest.mark.parametrize("name", sorted(EPOCHS))
def test_two_rank_epochs_end_with_one_process_parameters(runs, name):
    """An --sngp and a --het_layer epoch of 2 steps under --seq_parallel 2:
    rank 0's parameters and buffers (the precision matrix, the spectral (u,
    v), the het head) against one process's."""
    got, want = runs["s2"][name][0], runs["s1"][name][0]
    assert got.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-4, atol=1e-5, msg=k)
    assert runs["rank1"][name][0] is None


def test_fits_count_each_sample_once(runs):
    """The Laplace and temperature fits under a seq group: on both ranks the
    fit set holds each sample once (the train split's N_TRAIN, the eval
    split's N_TEST, the held-out carve-out's quarter), and the Laplace
    factors equal one process's; a fit that summed over the group would
    count each S times."""
    seen0, seen1 = runs["seen"]
    for fit in ("laplace", "temperature"):
        assert seen0[fit] == seen1[fit], fit
    # --laplace, its mc link, -C under it: each on the train split
    assert [n for n, *_ in seen0["laplace"]] == [N_TRAIN] * 3
    assert seen0["temperature"] == [N_TEST, N_TRAIN, N_TEST // 4]
    for printed in (runs["s2"]["laplace"][1], runs["s1"]["laplace"][1]):
        assert f"laplace: fit on {N_TRAIN} samples" in printed
    got = runs["s2"]["laplace"][0]["laplace"]["prior_precision"]
    assert got == runs["s1"]["laplace"][0]["laplace"]["prior_precision"]
    a_sum, g_sum = seen0["laplace"][0][1:3]
    assert a_sum > 0 and g_sum > 0


def test_sngp_eval_from_the_two_rank_checkpoint_matches_jax(runs, files):
    """--sngp --eval under --seq_parallel 2 from the one-process epoch's
    checkpoint against the JAX driver's dispatch given the same weights and
    buffers (mapped onto its variables)."""
    import jax

    from test_torch_port_cli_uq import jax_variables_from_state
    from uncertainty_vit_tpu.cli import finetune as JFT

    argv = _jax_argv(_argv(files, "sngp_jax", 1, *EVALS["sngp"][0]))
    jargs = JFT.get_args_parser().parse_args(argv)
    jmodel, _ = JFT.build_model(jargs, 100)
    template = jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32))
    variables = jax_variables_from_state(template, TC.load_torch_state_dict(files["sngp"]))
    val_loader, _ = JFT.B.build_loaders(jargs, is_train=False)
    want, _ = _quiet(JFT.run_eval_dispatch, jargs, jmodel, variables, val_loader, 100)
    got = runs["s2"]["sngp"][0]
    assert list(got) == list(want) == ["eval"]
    _close(got, want, "sngp", JAX_ATOL)


def test_rank0_alone_writes_the_embeddings(runs, files):
    """--visualize_embedding under --seq_parallel 2: rank 0 dumps once, rank
    1 runs the same forwards and writes nothing; the TSVs equal one
    process's within 1e-5 and the JAX driver's within 1e-5."""
    seen0, seen1 = runs["seen"]
    assert seen0["embedding_dumps"] == 1 and seen1["embedding_dumps"] == 0
    got, printed = runs["s2"]["embedding"]
    assert got == os.path.join(files["root"], "s2_embedding")
    assert f"embeddings written to {got}" in printed
    for tsv, atol in (("embeddings.tsv", 1e-5), ("embeddings_labels.tsv", 0)):
        mine = np.loadtxt(os.path.join(got, tsv))
        assert mine.shape[0] == N_TEST
        for other in (runs["s1"]["embedding"][0], runs["jax"]["embedding"]):
            np.testing.assert_allclose(mine, np.loadtxt(os.path.join(other, tsv)), rtol=0,
                                       atol=atol)


def test_mc_dropout_differs_from_the_deterministic_eval(runs):
    """The MC-dropout runs drew masks: their metrics, folded and split, are
    not the plain evaluation's, nor each other's."""
    plain = runs["s2"]["eval"][0]["eval"]
    folded = runs["s2"]["mc_folded"][0]["mc_dropout"]
    split = runs["s2"]["mc_split"][0]["mc_dropout"]
    assert folded["nll"] != plain["nll"] and split["nll"] != plain["nll"]
    assert folded["nll"] != split["nll"]


def test_perturbation_frames_above_256_raise_in_both_packages():
    """CIFAR-P frames are resized to 256 before their centre crop to the
    input size (uncertainty_evaluations.py:801-826), so -P above 256 has no
    frames to crop: the JAX package's slice raises, and the port's crop
    raises too instead of returning a smaller image. At 224 and 256 both
    give the input size."""
    import jax.numpy as jnp

    from uncertainty_vit_tpu.evals import robustness as JR

    frames = np.zeros((2, 32, 32, 3), np.uint8)
    for size in (224, 256):
        assert TR.process_p_frames(torch.from_numpy(frames), size).shape == (2, size, size, 3)
    with pytest.raises(TypeError):
        JR.process_p_frames(jnp.asarray(frames), 384)
    with pytest.raises(ValueError, match="centre crop of 384 from a resize to 256"):
        TR.process_p_frames(torch.from_numpy(frames), 384)


# ---------------------------------------------------------------------------
# K8's row window
# ---------------------------------------------------------------------------

# (n tokens, ranks, C, G = K·B): ragged splits, folds, and a C that takes the
# kernel's element path
WINDOW_CASES = [(577, 2, 768, 2), (5, 2, 768, 6), (5, 2, 5, 6), (577, 2, 64, 8), (13, 4, 96, 3)]


def _seed(value=0x00C0FFEE12345678):
    return torch.tensor([value], dtype=torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", WINDOW_CASES, ids=lambda c: "n{}_s{}_c{}_g{}".format(*c))
def test_window_is_the_unsharded_masks_rows(case, dtype):
    """``fused_dropout_plain`` over each rank's rows equals the unsharded
    call's rows to the bit; the whole sequence as its own window is the
    unwindowed call."""
    n, s, c, g = case
    x = torch.randn(g, n, c, generator=torch.Generator().manual_seed(n + c)).to(dtype)
    whole = DO.fused_dropout(x, 0.3, _seed())
    group = seq.SeqGroup(0, s)
    for r in range(s):
        start, stop = group.rows(n, r)
        got = DO.fused_dropout(x[:, start:stop].contiguous(), 0.3, _seed(), (start, n))
        assert torch.equal(got, whole[:, start:stop]), (r, start, stop)
    assert torch.equal(DO.fused_dropout_plain(x, 0.3, _seed(), (0, n)), whole)
    kept = (whole != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.05


def test_site_dropout_under_a_shard_draws_the_unsharded_rows():
    """The MC-dropout sites (``layers.site_dropout`` without grad) of each
    rank's rows of a K·B fold: the unsharded site's rows, from the same
    generator seed."""
    n, c, folds = 5, 32, 6
    x = torch.randn(folds, n, c, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        whole = TL.site_dropout(x, 0.2, True, torch.Generator().manual_seed(7))
        group = seq.SeqGroup(0, 2)
        for r in range(2):
            shard = seq.SeqShard(group, n, *group.rows(n, r))
            got = TL.site_dropout(x[:, shard.start:shard.stop], 0.2, True,
                                  torch.Generator().manual_seed(7), shard)
            assert torch.equal(got, whole[:, shard.start:shard.stop])


@pytest.mark.parametrize("window", [(3, 5), (-1, 5), (0, 1)])
def test_window_outside_the_sequence_raises(window):
    x = torch.zeros(2, 3, 8)
    with pytest.raises(ValueError, match="do not lie in a sequence"):
        DO.fused_dropout(x, 0.1, _seed(), window)


@pytest.mark.cuda
def test_window_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    seed = _seed().to(dev)
    for (n, s, c, g), dtype in zip(WINDOW_CASES * 2, [torch.bfloat16] * 5 + [torch.float32] * 5):
        x = torch.randn(g, n, c, device=dev).to(dtype)
        group = seq.SeqGroup(0, s)
        for r in range(s):
            start, stop = group.rows(n, r)
            part = x[:, start:stop].contiguous()
            got = DO.fused_dropout(part, 0.3, seed, (start, n))
            assert torch.equal(got, DO.fused_dropout_plain(part, 0.3, seed, (start, n)))
