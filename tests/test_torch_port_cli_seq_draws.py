"""PyTorch port: the finetune driver's train loop under --seq_parallel 2
with its random draws on, against its own single rank.

tests/test_torch_port_cli_seq.py holds the two ranks against the JAX driver
where nothing is drawn; here every draw of the step is on: token masking,
elem mixup on cutmix_minmax boxes, colour jitter, erasing, drop-path and
gradient accumulation, with RandAugment off to keep the CPU run short. Each
rank draws from the same per-step generators as the single rank (one data
host, the same batches), so the two runs see the same masks, mixes and
drop-path decisions and differ only in where the attention's sums are cut
and in the gradient sum over the ranks. One spawn of two gloo ranks on the
CPU. Held: each epoch's train loss within 1e-4 and its evaluation's
metrics (acc1 / acc5 equal, the rest within 1e-5), the final parameters,
and one log.txt record an epoch.
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

from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.core.init import trunc_normal
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA

LOSS_ATOL, METRIC_ATOL = 1e-4, 1e-5
N_TEST, EPOCHS = 32, 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{S: (output dir, returned state)} for --seq_parallel 2 and 1."""
    root = tmp_path_factory.mktemp("cli_seq_draws")
    base = root / "cifar-100-python"
    base.mkdir()
    rs = np.random.RandomState(0)
    for name, n in (("train", 48), ("test", N_TEST)):
        data = rs.randint(0, 256, (n, 3072), dtype=np.uint8)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": (np.arange(n) % 100).tolist()}, f)
    cfg = get_preset("beit_test_patch16_32", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)
    gen = torch.Generator().manual_seed(2)
    model = VisionTransformer(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
        trunc_normal(0.5, 2.0)(model.head.weight, gen)
    torch.save({"model": model.state_dict()}, str(root / "init.pth"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        for s in (2, 1):
            argv = ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set",
                    "CIFAR100", "--data_path", str(root), "--batch_size", "8",
                    "--num_workers", "0", "--dtype", "float32", "--output_dir",
                    str(root / f"s{s}"), "--finetune", str(root / "init.pth"), "--epochs",
                    str(EPOCHS), "--steps_per_epoch", "3", "--update_freq", "2",
                    "--warmup_steps", "1", "--lr", "1e-2", "--layer_decay", "0.75",
                    "--masked_position_prob", "0.2", "--mixup_mode", "elem",
                    "--cutmix_minmax", "0.25", "0.75", "--aa", "none", "--reprob", "0.25",
                    "--drop_path", "0.1", "--seq_parallel", str(s)]
            with redirect_stdout(io.StringIO()):
                state = TFT.main(TFT.get_args_parser().parse_args(argv), device="cpu")
            out[s] = (root / f"s{s}", state)
    return out


def _log(out_dir):
    with open(os.path.join(out_dir, "log.txt")) as f:
        return [json.loads(line) for line in f]


def test_two_ranks_train_as_one(runs):
    """Each epoch's train loss and lr, and its evaluation's metrics."""
    two, one = _log(runs[2][0]), _log(runs[1][0])
    assert [r["epoch"] for r in two] == [r["epoch"] for r in one] == list(range(EPOCHS))
    for g, w in zip(two, one):
        assert abs(g["train_loss"] - w["train_loss"]) <= LOSS_ATOL, (g, w)
        assert g["train_lr"] == w["train_lr"]
        for k in w:
            if not k.startswith("test_"):
                continue
            assert math.isfinite(g[k]), k
            if k in ("test_acc1", "test_acc5"):
                assert round(g[k] * N_TEST / 100) == round(w[k] * N_TEST / 100), k
            else:
                assert abs(g[k] - w[k]) <= METRIC_ATOL, (k, g[k], w[k])


def test_two_ranks_end_with_the_single_ranks_parameters(runs):
    """The model rank 0 returns (its mask token and accumulator included)
    against the single rank's."""
    (_, two), (_, one) = runs[2], runs[1]
    assert two.step == one.step == 3 * EPOCHS
    a, b = two.model.state_dict(), one.model.state_dict()
    assert "mask_token" in a and a.keys() == b.keys()
    for k, v in b.items():
        torch.testing.assert_close(a[k], v, rtol=1e-4, atol=1e-5, msg=k)
    acc_a = two.optimizer.state_dict()["multi_steps"]
    acc_b = one.optimizer.state_dict()["multi_steps"]
    assert acc_a["mini_step"] == acc_b["mini_step"] == 0
