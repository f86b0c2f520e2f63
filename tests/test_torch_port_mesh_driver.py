"""PyTorch port: the finetune driver on the data × seq mesh (``cli.finetune.main(args,
device, mesh=(D, S, 1))``, and a launcher's ranks), against one process
given the global batch, against the JAX driver, and the loader's shards
against the JAX package's ``BatchLoader``.

One module fixture writes seeded CIFAR-100 pickles (an odd train split,
whose shards are padded; a test split of 14, whose last global batch is
partial; a second test split of 15, whose shards are padded) and a ``.pth``
of a seeded ``beit_test_patch16_32`` (2 blocks of width 32, N = 5 tokens,
split 3 | 2 over a seq pair), then starts four gloo ranks once as the mesh
(2, 2, 1) (``parallel.seq.run_ranks``). They run every case through
``cli.finetune.run_rank``: on the whole mesh, and on each seq index's data
pair as a (2, 1, 1) mesh. Meanwhile the parent runs each case in one
process with a batch of 2 · --batch_size over the same global batches
(``BatchLoader(hosts_per_batch=2)``), and the JAX driver's deterministic
evaluation. Held: each metric of rank 0's result within 1e-5 of one
process's (MC-dropout and the het head too: every mask and every noise
draw is the global batch's, K8's keyed on the rank's rows of each fold),
the deterministic metrics against the JAX driver's within 1e-4, the two
training epochs' parameters and each epoch's loss, every rank's step count
(the padded shards), and the padded evaluation equal to the unpadded one
(``evals.collect.DataShards`` leaves the duplicates out).

The ranks import this module by name, so the JAX package is imported only
inside fixtures and tests.
"""

import contextlib
import functools
import io
import json
import os
import pickle
import socket
import threading

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from uncertainty_vit_tpu_torch.cli import builders as TB
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import ViTConfig, get_preset
from uncertainty_vit_tpu_torch.data.pipeline import BatchLoader
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import dropout as DO
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.ops import philox as P
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
from uncertainty_vit_tpu_torch.parallel import seq
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train.schedules import constant_schedule

N_TRAIN, N_TEST, N_ODD, BATCH = 11, 14, 15, 2
DATA = 2
# every metric but the counts within ATOL · max(1, |value|): the ranks
# against one process (f32 sums in another order); against the JAX driver
# (tests/test_torch_port_cli_eval.py's 1e-4)
ATOL = 1e-5
JAX_ATOL = 1e-4
MC = ["--mc_dropout", "--mc_dropout_forwards", "3", "--drop", "0.3"]
EPOCHS = ["--epochs", "2", "--warmup_epochs", "1", "--layer_decay", "0.65", "--save_ckpt_freq",
          "1", "--masked_position_prob", "0.2", "--drop", "0.1"]
# name → extra flags; each runs on the (2, 2, 1) mesh and on (2, 1, 1)
EVALS = {
    "eval": [],
    "mc_folded": MC,
    "mc_split": MC + ["--mc_dropout_split_at", "1", "--dropout_from_block", "1"],
    "het": ["--het_layer"],
    "eval_odd": ["--eval_data_path", "{odd}"],
}
TRAINS = {"train": EPOCHS}
# the post-hoc dispatches: the whole split on every rank, as one process
# reads it with the ranks' --batch_size (on the (2, 2, 1) mesh)
WHOLE = {"temp_scaling": ["--temp_scaling"], "laplace": ["--laplace"]}
MESHES = {"m221": (2, 2, 1), "m211": (2, 1, 1)}


@pytest.fixture(autouse=True)
def restore_bounded_scores():
    prev = TFA.BOUNDED_SCORES
    yield
    TFA.BOUNDED_SCORES = prev


def _write_cifar(root, splits):
    base = os.path.join(root, "cifar-100-python")
    os.makedirs(base, exist_ok=True)
    rs = np.random.RandomState(len(splits) + sum(splits.values()))
    for name, n in splits.items():
        data = rs.randint(0, 256, (n, 3072), dtype=np.uint8)
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": (np.arange(n) % 100).tolist()}, f)


def _argv(files, name, batch, seq_size, *extra, train=False):
    return ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
            "--data_path", files["root"], "--batch_size", str(batch), "--num_workers", "0",
            "--dtype", "float32", "--output_dir", os.path.join(files["root"], name),
            "--finetune", files["pth"], "--no_auto_resume", *([] if train else ["--eval"]),
            *[e.format(**files) for e in extra], "--seq_parallel", str(seq_size)]


def _cases(files):
    """(name, mesh key, argv, trains) of every run on the ranks."""
    out = []
    for key, (_, s, _) in MESHES.items():
        out += [(f"{key}_{n}", key, _argv(files, f"{key}_{n}", BATCH, s, *extra), False)
                for n, extra in EVALS.items()]
        out += [(f"{key}_{n}", key, _argv(files, f"{key}_{n}", BATCH, s, *extra, train=True),
                 True) for n, extra in TRAINS.items()]
    out += [(f"m221_{n}", "m221", _argv(files, f"m221_{n}", BATCH, 2, *extra), False)
            for n, extra in WHOLE.items()]
    return out


def _data_pair(mesh):
    """The (2, 1, 1) mesh of this rank's seq index: the data axis's ranks."""
    group = mesh.group(meshlib.DATA_AXIS)
    return meshlib.Mesh((mesh.size("data"), 1, 1), mesh.index("data"), (group, None, None), group)


def _mesh_rank(mesh, cases):
    """Every case through ``run_rank`` on the mesh or its data pair: {name:
    (the result of the run's rank 0, a training run's parameters; None on
    its other ranks; the train steps taken)}."""
    torch.set_num_threads(1)
    steps = []
    make = TFT.make_finetune_train_step

    def counted(*a, **k):
        step = make(*a, **k)

        def call(*sa, **sk):
            steps.append(1)
            return step(*sa, **sk)

        return call

    TFT.make_finetune_train_step = counted
    out = {}
    for name, key, argv, trains in cases:
        argv = list(argv)
        m = mesh
        if key == "m211":
            m = _data_pair(mesh)
            argv[argv.index("--output_dir") + 1] += f"_seq{mesh.index('seq')}"
        steps.clear()
        with contextlib.redirect_stdout(io.StringIO()):
            res = TFT.run_rank(m, TFT.get_args_parser().parse_args(argv), "cpu")
        if trains and res is not None:
            res = {k: v.detach().clone() for k, v in res.model.state_dict().items()}
        out[name] = (res, len(steps))
    return out, (mesh.index("data"), mesh.index("seq"))


class _Ranks(threading.Thread):
    def __init__(self, cases):
        super().__init__(daemon=True)
        self.cases, self.result, self.error = cases, None, None

    def run(self):
        try:
            self.result = seq.run_ranks(_mesh_rank, 4, self.cases, timeout=600.0,
                                        mesh=MESHES["m221"])
        except BaseException as e:  # raised in the fixture
            self.error = e


def _one(files, name, s, extra, train=False, global_batch=True):
    """One process's run of a case: a batch of DATA · BATCH over the mesh's
    global batches (or the plain loader at BATCH), quiet."""
    argv = _argv(files, f"one_{name}", DATA * BATCH if global_batch else BATCH, 1, *extra,
                 train=train)
    with pytest.MonkeyPatch.context() as mp:
        if global_batch:
            mp.setattr(TB, "BatchLoader", functools.partial(BatchLoader, hosts_per_batch=DATA))
        with contextlib.redirect_stdout(io.StringIO()):
            res = TFT.main(TFT.get_args_parser().parse_args(argv), device="cpu")
    if train:
        return {k: v.detach().clone() for k, v in res.model.state_dict().items()}
    return res


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_driver"))
    odd = os.path.join(root, "odd")
    _write_cifar(root, {"train": N_TRAIN, "test": N_TEST})
    _write_cifar(odd, {"test": N_ODD})
    cfg = get_preset("beit_test_patch16_32", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)
    gen = torch.Generator().manual_seed(1)
    model = VisionTransformer(cfg, device="cpu", generator=gen)
    with torch.no_grad():  # logits well apart, a rel-pos bias that is not zero
        model.head.weight.normal_(0.0, 0.5, generator=gen)
        model.rel_pos_bias.relative_position_bias_table.normal_(0.0, 0.2, generator=gen)
    torch.save({"model": model.state_dict()}, os.path.join(root, "a.pth"))
    return {"root": root, "pth": os.path.join(root, "a.pth"), "odd": odd}


@pytest.fixture(scope="module")
def runs(files):
    """{"ranks": [(rank results, (data, seq))], "one": {name: one process's
    result}, "odd": the unpadded one-process eval of the odd split, "jax":
    the JAX driver's eval}."""
    import uncertainty_vit_tpu.ops.flash_attention as JFA
    from uncertainty_vit_tpu.cli import finetune as JFT

    ranks = _Ranks(_cases(files))
    ranks.start()
    out = {"one": {}}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JFA, "BOUNDED_SCORES", JFA.BOUNDED_SCORES)
            mp.delenv("UVIT_ATTN_BOUNDED_SCORES", raising=False)
            for n, extra in EVALS.items():
                out["one"][n] = _one(files, n, 1, extra)
            for n, extra in TRAINS.items():
                out["one"][n] = _one(files, n, 1, extra, train=True)
            out["odd"] = _one(files, "odd_plain", 1, EVALS["eval_odd"], global_batch=False)
            for n, extra in WHOLE.items():
                out["one"][n] = _one(files, n, 1, extra, global_batch=False)
            argv = _argv(files, "jax", DATA * BATCH, 1)
            with contextlib.redirect_stdout(io.StringIO()):
                out["jax"] = JFT.main(JFT.get_args_parser().parse_args(argv[:-2]))
    finally:
        ranks.join()
    if ranks.error is not None:
        raise ranks.error
    out["ranks"] = ranks.result
    return out


def _close(got, want, where, atol, n):
    assert sorted(got) == sorted(want), where
    for k, v in want.items():
        if isinstance(v, dict):
            _close(got[k], v, f"{where}.{k}", atol, n)
        elif k in ("acc1", "acc5"):
            assert round(got[k] * n / 100) == round(v * n / 100), (where, k, got[k], v)
        else:
            assert abs(got[k] - v) <= atol * max(1.0, abs(v)), (where, k, got[k], v)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", [n for n in EVALS if n != "eval_odd"])
def test_mesh_eval_equals_one_process(runs, mesh, name):
    """Rank 0's --eval result on the mesh against one process given the
    global batches: the union of the data ranks' logits (each sample once)
    gives one process's metrics; MC-dropout's masks and the het head's noise
    are the global batch's rows. The other ranks return None."""
    res0, _ = runs["ranks"][0]
    _close(res0[f"{mesh}_{name}"][0], runs["one"][name], name, ATOL, N_TEST)
    for res, (d, q) in runs["ranks"]:
        # rank 0 of each run: (0, 0) of the mesh, data index 0 of each data pair
        assert (res[f"{mesh}_{name}"][0] is None) == (d > 0 or (q > 0 and mesh == "m221"))


@pytest.mark.parametrize("name", sorted(WHOLE))
def test_post_hoc_dispatches_read_the_whole_split(runs, name):
    """--temp_scaling and --laplace on the (2, 2, 1) mesh: every rank reads
    the whole split (the fits count each sample once, no padded duplicate)
    and rank 0's result is one process's."""
    res0, _ = runs["ranks"][0]
    _close(res0[f"m221_{name}"][0], runs["one"][name], name, ATOL, N_TEST)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_eval_matches_the_jax_driver(runs, mesh):
    """The deterministic evaluation's metrics against the JAX driver's
    ``evaluate`` on the same images and weights."""
    res0, _ = runs["ranks"][0]
    _close(res0[f"{mesh}_eval"][0], runs["jax"], "eval", JAX_ATOL, N_TEST)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_padded_eval_shards_count_each_sample_once(runs, mesh):
    """15 test images over 2 data ranks: the shards are padded (the forced
    padding), and the metrics are one process's over the 15 unpadded, not
    over 16."""
    res0, _ = runs["ranks"][0]
    _close(res0[f"{mesh}_eval_odd"][0], runs["odd"], "eval_odd", ATOL, N_ODD)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_training_equals_one_process(runs, mesh, files):
    """Two epochs on the mesh (mixup, RandAugment, erasing, drop-path,
    masking and dropout drawn for the global batch, this rank's rows kept)
    against one process with a batch of 2 · --batch_size over the same
    global batches: every rank's parameters, each epoch's loss in log.txt,
    and the steps: the odd train split's padded shards give every rank
    the same number."""
    want = runs["one"]["train"]
    per_rank = -(-N_TRAIN // DATA) // BATCH
    for res, (d, q) in runs["ranks"]:
        got, steps = res[f"{mesh}_train"]
        assert steps == 2 * per_rank, (d, q, steps)
        # the driver held every rank's parameters equal after each epoch
        assert (got is None) == (d > 0 or (q > 0 and mesh == "m221"))
        for k, v in ({} if got is None else want).items():
            torch.testing.assert_close(got[k], v, rtol=1e-4, atol=1e-5, msg=k)
    suffix = "_seq0" if mesh == "m211" else ""
    logs = []
    for tag in (f"{mesh}_train{suffix}", "one_train"):
        with open(os.path.join(files["root"], tag, "log.txt")) as f:
            logs.append([json.loads(line) for line in f])
    assert len(logs[0]) == len(logs[1]) == 2
    for g, w in zip(*logs):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-4)
        assert g["test_acc1"] == pytest.approx(w["test_acc1"], abs=1e-4)


# --- the loader's shards -----------------------------------------------------

class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 2, 3), i % 256, np.uint8), i


@pytest.mark.parametrize("n,hosts,batch", [(11, 2, 2), (15, 3, 4), (8, 2, 3)])
@pytest.mark.parametrize("shuffle,drop_last,pad", [(True, True, None), (False, False, None),
                                                   (False, False, True), (True, False, False)])
def test_loader_shards_equal_the_jax_loaders(n, hosts, batch, shuffle, drop_last, pad):
    """Every host's indices and batches over two epochs against the JAX
    package's ``BatchLoader`` with the same host_id / num_hosts /
    pad_shards, and the count of a shard's samples that are not padding."""
    from uncertainty_vit_tpu.data.pipeline import BatchLoader as JBatchLoader

    for host in range(hosts):
        kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=0, host_id=host,
                  num_hosts=hosts, pad_shards=pad, seed=3)
        mine, theirs = BatchLoader(_Indexed(n), batch, **kw), JBatchLoader(_Indexed(n), batch,
                                                                          **kw)
        for epoch in (0, 1):
            mine.set_epoch(epoch)
            theirs.set_epoch(epoch)
            np.testing.assert_array_equal(mine._indices(), theirs._indices())
            assert len(mine) == len(theirs)
            for a, b in zip(mine, theirs):
                np.testing.assert_array_equal(a[-1], b[-1])
        real = [i for i in mine._indices()[:mine.real_count()]]
        assert len(set(real)) == len(real)
        if not mine.pad_shards:
            assert mine.real_count() == len(mine._indices())


def test_loaders_on_a_data_axis_pad_with_the_jax_message(files):
    """Where the shards span data ranks, an unpadded loader (the evaluation's,
    a fit's pad_shards=False) is padded, with the JAX package's message; its
    indices are the JAX loader's with pad_shards=True. One host keeps the
    evaluation unpadded."""
    from uncertainty_vit_tpu.data.pipeline import BatchLoader as JBatchLoader

    args = TFT.get_args_parser().parse_args(_argv(files, "pad", BATCH, 1,
                                                  "--eval_data_path", files["odd"]))
    for pad_shards in (None, False):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            loader, _ = TB.build_loaders(args, is_train=False, host=(1, 2), pad_shards=pad_shards)
        assert "build_loaders: forcing pad_shards=True — unpadded shards would break " \
               "multi-host lockstep under --seq_parallel" in buf.getvalue()
        assert loader.pad_shards and loader.real_count() == 7 and len(loader._indices()) == 8
        want = JBatchLoader(_Indexed(N_ODD), BATCH, shuffle=False, drop_last=False, host_id=1,
                            num_hosts=2, pad_shards=True)
        np.testing.assert_array_equal(loader._indices(), want._indices())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loader, _ = TB.build_loaders(args, is_train=False, host=(0, 1))
    assert not loader.pad_shards and "forcing" not in buf.getvalue()


def test_global_order_reads_the_data_ranks_batches():
    """``BatchLoader(hosts_per_batch=h)`` on one host reads, batch by batch,
    the h padded shards' batches one after the other: one process's view of
    a mesh of h data ranks."""
    for shuffle, drop_last in ((True, True), (False, False)):
        ranks = [BatchLoader(_Indexed(11), 2, shuffle=shuffle, drop_last=drop_last,
                             num_workers=0, host_id=d, num_hosts=2, pad_shards=True)
                 for d in range(2)]
        one = BatchLoader(_Indexed(11), 4, shuffle=shuffle, drop_last=drop_last, num_workers=0,
                          hosts_per_batch=2)
        for loader in ranks + [one]:
            loader.set_epoch(1)
        per_rank = [list(r) for r in ranks]
        got = list(one)
        assert len(got) == len(per_rank[0]) == len(per_rank[1])
        for k, batch in enumerate(got):
            np.testing.assert_array_equal(batch[-1], np.concatenate(
                [per_rank[0][k][-1], per_rank[1][k][-1]]))
    with pytest.raises(ValueError, match="hosts_per_batch"):
        BatchLoader(_Indexed(11), 3, hosts_per_batch=2)


# --- K8's fold mapping -----------------------------------------------------

FOLDS = ((3, 2, 2, 5, 8), (2, 1, 3, 7, 6), (4, 3, 2, 4, 5))


@pytest.mark.parametrize("k,b,d_size,n,c", FOLDS)
def test_k8_fold_bits_are_one_process_rows(k, b, d_size, n, c):
    """The plain version's bits under the fold (b, B, d·b): data rank d's
    groups of a batch tiled k times (local k'·b + i) draw one process's
    rows k'·B + d·b + i of the unfolded call, and under a seq window too;
    ``philox.fold_images`` is ``parallel.mesh.fold_index``'s map."""
    seed = torch.tensor([0x1234ABCD], dtype=torch.int64)
    x = torch.randn(k * d_size * b, n, c, generator=torch.Generator().manual_seed(n * c))
    whole = DO.fused_dropout(x, 0.3, seed)
    for d in range(d_size):
        fold = (b, d_size * b, d * b)
        rows = P.fold_images(k * b, fold)
        index, total = meshlib.fold_index(k * b, (d * b, (d + 1) * b, d_size * b))
        assert torch.equal(rows, index) and total == k * d_size * b
        assert torch.equal(DO.fused_dropout(x[rows].contiguous(), 0.3, seed, None, fold),
                           whole[rows])
        for start, stop in ((0, n // 2 + 1), (n // 2 + 1, n)):
            part = x[rows, start:stop].contiguous()
            got = DO.fused_dropout(part, 0.3, seed, (start, n), fold)
            assert torch.equal(got, whole[rows, start:stop])
    with pytest.raises(ValueError, match="fold"):
        DO.fused_dropout(x[:3].contiguous(), 0.3, seed, None, (2, 4, 0))


@pytest.mark.cuda
def test_k8_fold_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    seed = torch.tensor([0x1234ABCD], dtype=torch.int64, device=dev)
    for (k, b, d_size, n, c), dtype in zip(FOLDS * 2, [torch.bfloat16] * 3 + [torch.float32] * 3):
        x = torch.randn(k * d_size * b, n, c, device=dev).to(dtype)
        whole = DO.fused_dropout(x, 0.3, seed)
        for d in range(d_size):
            fold = (b, d_size * b, d * b)
            rows = P.fold_images(k * b, fold).to(dev)
            part = x[rows].contiguous()
            got = DO.fused_dropout(part, 0.3, seed, None, fold)
            assert torch.equal(got, DO.fused_dropout_plain(part, 0.3, seed, None, fold))
            assert torch.equal(got, whole[rows])


def test_mc_forward_on_a_data_axis_draws_the_global_masks():
    """Folded and split MC-dropout forwards on a data axis (a mesh built
    without a process group: its draws need none) keep the rows of the
    global batch's forward in each fold."""
    cfg = get_preset("beit_test_patch16_32", num_classes=10, drop_rate=0.3)
    full = VisionTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    images = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    from uncertainty_vit_tpu_torch.evals.mc_dropout import make_mc_dropout_forward

    for split in (0, 1):
        want = make_mc_dropout_forward(full, 3, split_at=split)(
            images, torch.Generator().manual_seed(4))
        for d in range(2):
            part = VisionTransformer(cfg, device="cpu", mesh=meshlib.Mesh((2, 1, 1), d))
            part.load_state_dict(full.state_dict())
            got = make_mc_dropout_forward(part, 3, split_at=split)(
                images[2 * d:2 * d + 2], torch.Generator().manual_seed(4))
            torch.testing.assert_close(got, want[:, 2 * d:2 * d + 2], rtol=1e-5, atol=1e-6)


# --- what still raises -------------------------------------------------------

@pytest.mark.parametrize("case", ["int8_data", "gumbel_seq", "dual_sto_seq", "gumbel_data",
                                  "attn_drop_data", "adahessian_data"])
def test_mesh_refusals_before_the_ranks_start(files, case):
    """What the driver's mesh does not run raises before any rank starts:
    the Gumbel-drawing variants on any mesh (item 20's rest). Since slice
    19 a data axis refuses nothing of its own: --quant int8, attention
    dropout in training and AdaHessian training reach the ranks."""
    extra, train, mesh, words = {
        "int8_data": (["--quant", "int8"], False, (2, 1, 1), None),
        "gumbel_seq": (["--gumbel_softmax"], False, (1, 2, 1), "item 20's rest"),
        "dual_sto_seq": (["--h_sto_trans"], False, (2, 2, 1), "item 20's rest"),
        "gumbel_data": (["--gumbel_softmax"], True, (2, 1, 1), "item 20's rest"),
        "attn_drop_data": (["--attn_drop_rate", "0.1"], True, (2, 1, 1), None),
        "adahessian_data": (["--opt", "adahessian"], True, (2, 1, 1), None),
    }[case]
    argv = _argv(files, case, BATCH, mesh[1], *extra, train=train)
    with pytest.MonkeyPatch.context() as mp:
        if words is None:
            mp.setattr(TFT.seq, "run_ranks", lambda *a, **k: ["the ranks started"])
            assert TFT.main(TFT.get_args_parser().parse_args(argv), device="cpu",
                            mesh=mesh) == "the ranks started"
        else:
            mp.setattr(TFT.seq, "run_ranks", lambda *a, **k: pytest.fail("the ranks started"))
            with pytest.raises(NotImplementedError, match=words):
                TFT.main(TFT.get_args_parser().parse_args(argv), device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="seq axis is --seq_parallel"):
        TFT.main(TFT.get_args_parser().parse_args(_argv(files, "bad", BATCH, 1)),
                 device="cpu", mesh=(2, 2, 1))


def test_model_level_refusals_on_a_data_axis():
    """On a data axis the model builds its int8 trunk, and the finetune and
    dist engines take the AdaHessian pass (slice 19); the cyclical engine's
    pass under a seq group or a mesh, and any engine's under a model axis,
    still raise."""
    from uncertainty_vit_tpu_torch.models.cyclical import CyclicalViT
    from uncertainty_vit_tpu_torch.models.dist_vit import DistVisionTransformer
    from uncertainty_vit_tpu_torch.train import engine_cyclical as TEC
    from uncertainty_vit_tpu_torch.train import engine_finetune_dist as TED

    small = dict(img_size=32, patch_size=16, embed_dim=64, depth=1, num_heads=1,
                 num_classes=5)
    tp = ViTConfig(**dict(small, embed_dim=128, num_heads=2))  # heads split over a model axis
    data2 = meshlib.Mesh((2, 1, 1), 0)
    VisionTransformer(ViTConfig(**small, quant="int8"), device="cpu", mesh=data2)
    group = seq.SeqGroup(0, 2)

    def cyclical(m, o):
        return TEC.make_cyclical_train_step(m, o, TEC.CyclicalHParams(), constant_schedule(1e-3),
                                            use_hessian=True)

    def dist(m, o):
        return TED.make_dist_finetune_train_step(m, o, TED.DistFinetuneHParams(num_classes=5),
                                                 constant_schedule(1e-3), use_hessian=True)

    def finetune(m, o):
        return TE.make_finetune_train_step(m, o, TE.FinetuneHParams(num_classes=5),
                                           constant_schedule(1e-3), use_hessian=True)

    for model, make in (
            (CyclicalViT(ViTConfig(**small), device="cpu", mesh=meshlib.Mesh((1, 2, 1), 0)),
             cyclical),
            (CyclicalViT(ViTConfig(**small), device="cpu", mesh=data2), cyclical),
            (DistVisionTransformer(tp, device="cpu", mesh=meshlib.Mesh((1, 1, 2), 0)), dist),
            (VisionTransformer(tp, device="cpu", mesh=meshlib.Mesh((2, 1, 2), 0)), finetune)):
        opt = TO.make_optimizer(model, opt_name="adahessian")
        with pytest.raises(NotImplementedError, match="item 21"):
            make(model, opt)
    # a seq group, and a data axis, run the finetune and dist engines' pass
    for model, make in ((VisionTransformer(ViTConfig(**small), device="cpu", seq_group=group),
                         finetune),
                        (VisionTransformer(ViTConfig(**small), device="cpu", mesh=data2),
                         finetune),
                        (DistVisionTransformer(ViTConfig(**small), device="cpu", mesh=data2),
                         dist)):
        make(model, TO.make_optimizer(model, opt_name="adahessian"))


# --- a launcher's ranks --------------------------------------------------------

def _launched_rank(rank, port, argv, results):
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
                       "MASTER_PORT": str(port)})
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            res = TFT.main(TFT.get_args_parser().parse_args(argv), device="cpu")
        results.put((rank, res))
    except BaseException as e:  # reported to the parent
        results.put((rank, repr(e)))


def test_a_launchers_ranks_form_the_mesh(files, runs):
    """Two processes started as a launcher starts them (RANK, WORLD_SIZE,
    MASTER_ADDR / MASTER_PORT): without --seq_parallel they are the mesh
    (2, 1, 1), each evaluating its shard, and rank 0's result is the one
    ``main(..., mesh=(2, 1, 1))`` gives; a world that --seq_parallel does
    not divide raises."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    argv = _argv(files, "launched", BATCH, 1)
    procs = [ctx.Process(target=_launched_rank, args=(r, port, argv, results), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(results.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    assert got[1] is None, got[1]
    res0, _ = runs["ranks"][0]
    _close(got[0], res0["m211_eval"][0], "launched", 0.0, N_TEST)
    with pytest.MonkeyPatch.context() as m:
        for k, v in {"RANK": "0", "WORLD_SIZE": "3", "MASTER_ADDR": "localhost",
                     "MASTER_PORT": str(port)}.items():
            m.setenv(k, v)
        with pytest.raises(ValueError, match="does not split into --seq_parallel 2"):
            TFT.main(TFT.get_args_parser().parse_args(_argv(files, "bad", BATCH, 2)),
                     device="cpu")
