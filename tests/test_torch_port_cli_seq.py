"""PyTorch port: the finetune driver's train loop under --seq_parallel 2
against the JAX driver's, and against its own single rank.

``cli.finetune.main(args, device="cpu")`` runs two gloo ranks on the CPU
(one spawn in this file), each with half of every image's tokens, over
CIFAR-100 pickles whose images are each one colour: the random resized crop
and the flip of such an image are the image, so with RandAugment, colour
jitter, erasing, mixup and drop-path off the train transform draws nothing
that could differ between the packages, and the JAX driver (under
--seq_parallel 2 on the conftest's 8 virtual devices) trains on the same
tensors. Gradient accumulation is on (--update_freq 2, 3 mini-steps an
epoch). Held: the train log's loss per epoch within 1e-4 (f32 forwards and
backwards of two frameworks over two epochs), each epoch's evaluation (the
log's test_* metrics) with acc1 / acc5 equal and the rest within 1e-5; the
port's two ranks against its single rank likewise; only rank 0 writes
log.txt (one record an epoch) and the checkpoints.
"""

import io
import json
import math
import os
import pickle
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import uncertainty_vit_tpu.ops.flash_attention as JFA
from uncertainty_vit_tpu.cli import finetune as JFT
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.core.init import trunc_normal
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA

LOSS_ATOL, METRIC_ATOL = 1e-4, 1e-5
N_TRAIN, N_TEST, EPOCHS = 48, 32, 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{run: (output dir, returned state)} for the JAX driver and the port's
    under --seq_parallel 2, and the port's single rank."""
    root = tmp_path_factory.mktemp("cli_seq")
    base = root / "cifar-100-python"
    base.mkdir()
    rs = np.random.RandomState(0)
    for name, n in (("train", N_TRAIN), ("test", N_TEST)):
        colour = rs.randint(0, 256, (n, 3, 1), dtype=np.uint8)
        data = np.repeat(colour, 32 * 32, axis=2).reshape(n, 3072)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": (np.arange(n) % 100).tolist()}, f)
    cfg = get_preset("beit_test_patch16_32", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)
    gen = torch.Generator().manual_seed(1)
    model = VisionTransformer(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
        trunc_normal(0.5, 2.0)(model.head.weight, gen)
    torch.save({"model": model.state_dict()}, str(root / "init.pth"))

    def argv(out, s):
        return ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set",
                "CIFAR100", "--data_path", str(root), "--batch_size", "8", "--num_workers", "0",
                "--dtype", "float32", "--output_dir", str(out), "--finetune",
                str(root / "init.pth"), "--epochs", str(EPOCHS), "--steps_per_epoch", "3",
                "--update_freq", "2", "--warmup_steps", "1", "--lr", "2e-2",
                "--layer_decay", "0.75", "--aa", "none", "--color_jitter", "0", "--reprob", "0",
                "--mixup", "0", "--cutmix", "0", "--drop_path", "0", "--save_ckpt_freq", "1",
                "--seq_parallel", str(s)]

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFA, "BOUNDED_SCORES", JFA.BOUNDED_SCORES)
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        mp.delenv("UVIT_ATTN_BOUNDED_SCORES", raising=False)
        JFT.main(JFT.get_args_parser().parse_args(argv(root / "jax2", 2)))
        out["jax2"] = (root / "jax2", None)
        for name, s in (("port2", 2), ("port1", 1)):
            with redirect_stdout(io.StringIO()):
                state = TFT.main(TFT.get_args_parser().parse_args(argv(root / name, s)),
                                 device="cpu")
            out[name] = (root / name, state)
    return out


def _log(out_dir):
    with open(os.path.join(out_dir, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _same_records(got, want, where):
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == list(range(EPOCHS)), where
    for g, w in zip(got, want):
        assert abs(g["train_loss"] - w["train_loss"]) <= LOSS_ATOL, (where, g, w)
        assert abs(g["train_lr"] - w["train_lr"]) <= 1e-6 * w["train_lr"] + 1e-12, (where, g, w)
        for k in w:
            if not k.startswith("test_"):
                continue
            assert math.isfinite(g[k]), (where, k)
            if k in ("test_acc1", "test_acc5"):
                assert round(g[k] * N_TEST / 100) == round(w[k] * N_TEST / 100), (where, k)
            else:
                assert abs(g[k] - w[k]) <= METRIC_ATOL, (where, k, g[k], w[k])


@pytest.mark.parametrize("pair", [("port2", "jax2"), ("port2", "port1"), ("port1", "jax2")],
                         ids=lambda p: "_vs_".join(p))
def test_train_log_matches(runs, pair):
    """Each epoch's train loss and lr and its evaluation's metrics."""
    got, want = (_log(runs[name][0]) for name in pair)
    _same_records(got, want, pair)


def test_the_run_learned_something(runs):
    """The comparison is not of two standing runs: the test loss moves
    between the epochs."""
    log = _log(runs["port2"][0])
    assert abs(log[1]["test_loss"] - log[0]["test_loss"]) > 1e-3


def test_rank_0_alone_writes_and_returns(runs):
    """log.txt holds one record an epoch (a second rank appending would
    double them), the checkpoints are written, and the state rank 0
    returned is the single rank's within the train log's tolerance; the
    ranks' parameters were held equal after every epoch."""
    out, state = runs["port2"]
    assert len(_log(out)) == EPOCHS
    assert {f"checkpoint-{e}.pth" for e in range(EPOCHS)} | {"checkpoint-best.pth"} <= set(
        os.listdir(out))
    _, single = runs["port1"]
    assert state.step == single.step == 3 * EPOCHS
    assert state.optimizer.mini_step == single.optimizer.mini_step == 0
    two, one = state.model.state_dict(), single.model.state_dict()
    assert two.keys() == one.keys()
    for k, v in one.items():
        torch.testing.assert_close(two[k], v, rtol=1e-4, atol=1e-5, msg=k)
    saved = torch.load(os.path.join(out, f"checkpoint-{EPOCHS - 1}.pth"), weights_only=False)
    assert all(torch.equal(saved["model"][k], v) for k, v in two.items())
