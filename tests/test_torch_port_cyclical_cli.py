"""PyTorch port: the cyclical pretraining driver (``cli.pretrain_cyclical``)
over tiny CIFAR-100 pickles, and the pretrain → finetune hand-off, against
the JAX package.

The driver runs ``beit_test_patch16_32`` (2 blocks of width 32, the plain
attention) with ``main(args, device="cpu")``, as
tests/test_torch_port_cli_train.py runs the finetune driver. A run stopped
after an epoch and auto-resumed equals the uninterrupted run bit for bit
(the per-step generators, the loader's order and the masks are functions of
(seed, step); CPU arithmetic in the same order). log.txt's keys are the
JAX driver's: "epoch" and "train_" before each metric of the JAX step
(its metrics' names from ``jax.eval_shape`` of the step). The hand-off: a
port ``checkpoint-N.pth`` read by ``cli.finetune`` gives the missing and
unused keys JAX ``import_torch_params`` gives on the same state dict
(missing: fc_norm and the head; unused: mask_token, norm and lm_head), the
same weights, and then the finetune model's logits within 2e-4 / 2e-5 of
the JAX finetune model's, its fresh fc_norm and head set to the JAX
model's values. Both packages' ``BOUNDED_SCORES``, which the drivers set,
are restored after each test.
"""

import copy
import io
import json
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
from uncertainty_vit_tpu.core.config import ViTConfig as JConfig
from uncertainty_vit_tpu.models.cyclical import CyclicalViT as JCyclical
from uncertainty_vit_tpu.train import engine_cyclical as JE
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu.utils import checkpoint as JC
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.cli import pretrain_cyclical as P
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.ops import masking as TM
from uncertainty_vit_tpu_torch.utils import checkpoint as C

N_TRAIN, BATCH = 48, 8


@pytest.fixture(autouse=True)
def restore_bounded_scores():
    prev = (JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    yield
    JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_cyclical")
    base = root / "cifar-100-python"
    base.mkdir()
    rs = np.random.RandomState(0)
    for name, n in (("train", N_TRAIN), ("test", 16)):
        data = rs.randint(0, 256, (n, 3072), dtype=np.uint8)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": (np.arange(n) % 100).tolist()}, f)
    return root


def _args(root, out, *extra):
    return P.get_args_parser().parse_args([
        "--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
        "--data_path", str(root), "--batch_size", str(BATCH), "--num_workers", "0",
        "--dtype", "float32", "--output_dir", str(out), "--save_ckpt_freq", "1",
        "--steps_per_epoch", "2", "--warmup_epochs", "1", "--target_layers", "[0,1]",
        "--num_mask_patches", "2", "--min_mask_patches_per_block", "1", "--clip_grad", "3.0",
        "--drop_path", "0.25", "--attn_drop_rate", "0.05", "--mask_dropout_prob", "0.2",
        "--ema_decay", "0.99", "--ema_decay_init", "0.9", "--ema_start_at", "3", *extra])


def _run(root, out, *extra):
    buf = io.StringIO()
    with redirect_stdout(buf):
        state = P.main(_args(root, out, *extra), device="cpu")
    return state, buf.getvalue()


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _snapshot(state):
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "teacher": {k: v.detach().clone() for k, v in state.model_ema.items()},
            "optimizer": copy.deepcopy(state.optimizer.state_dict()), "step": state.step}


def _equal(a, b):
    assert a["step"] == b["step"]
    for part in ("model", "teacher"):
        assert a[part].keys() == b[part].keys()
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k, v in sa[i].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb[i][k])), (i, k)


def _jax_metric_names():
    """The metrics the JAX driver logs: those of its step with an lr
    schedule, by jax.eval_shape (traced, not run)."""
    cfg = JConfig(img_size=32, patch_size=16, embed_dim=16, depth=2, num_heads=2,
                  head_type="none", use_flash_attention=False)
    model = JCyclical(cfg=cfg)
    images, mask = jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 4))
    lr = JS.constant_schedule(1e-3)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), images, mask)["params"]
    tx = JO.make_optimizer(params, lr)
    state = jax.eval_shape(lambda: JE.init_cyclical_state(model, tx, jax.random.PRNGKey(0),
                                                          images, mask))
    step = JE.make_cyclical_train_step(model, tx, JE.CyclicalHParams(target_layers=(0, 1)), lr,
                                       donate=False)
    _, metrics = jax.eval_shape(step, state, images, mask, jax.random.PRNGKey(0))
    return set(metrics)


def test_train_checkpoint_resume_equals_the_straight_run(root, tmp_path, monkeypatch):
    """Two epochs of two steps straight, and one epoch then --epochs 2 on the
    same directory with --seed_model set (the seed goes in before the
    resume, so the resumed run takes the checkpoint's weights, not the
    seed's): the resumed state right after auto_load equals checkpoint-0.pth
    (student, teacher, AdamW moments, step), and the final states are equal
    bit for bit. log.txt: one record an epoch under the JAX driver's keys,
    finite losses, the mask count the masks' after mask dropout. Each step's
    masks are the host op's from the step's CPU generator."""
    straight, printed = _run(root, tmp_path / "straight", "--epochs", "2")
    assert straight.step == 4 and printed.rstrip().endswith("done.")
    log = _log(tmp_path / "straight")
    names = _jax_metric_names()
    assert names == {"loss", "loss_cyc", "loss_var0", "grad_norm", "mask_count", "lr"}
    assert [sorted(r) for r in log] == [sorted({"epoch"} | {f"train_{k}" for k in names})] * 2
    assert [r["epoch"] for r in log] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and 0 < r["train_mask_count"] <= 2 for r in log)
    assert {"checkpoint-0.pth", "checkpoint-1.pth"} <= set(os.listdir(tmp_path / "straight"))

    out = tmp_path / "resumed"
    first, _ = _run(root, out, "--epochs", "1")
    saved = torch.load(str(out / "checkpoint-0.pth"), weights_only=False)
    assert sorted(saved) == ["epoch", "model", "model_ema", "optimizer", "step"]
    assert saved["step"] == 2
    assert saved["model_ema"].keys() == dict(first.model.named_parameters()).keys()
    seed = tmp_path / "seed.pth"
    torch.save({"model": P.build_model(_args(root, out, "--seed", "9"), "cpu")[0].state_dict()},
               str(seed))
    loaded = []
    auto_load = C.auto_load

    def recording_auto_load(output_dir, state):
        state, epoch = auto_load(output_dir, state)
        loaded.append((epoch, _snapshot(state)))
        return state, epoch

    monkeypatch.setattr(P.C, "auto_load", recording_auto_load)
    resumed, printed = _run(root, out, "--epochs", "2", "--seed_model", str(seed))
    assert "seeded from" in printed and "auto-resumed from epoch 1" in printed
    epoch, at_load = loaded[0]
    assert epoch == 1
    _equal(at_load, {"model": saved["model"], "teacher": saved["model_ema"],
                     "optimizer": saved["optimizer"], "step": saved["step"]})
    _equal(_snapshot(resumed), _snapshot(straight))
    assert _log(out) == log


def test_seed_model_seeds_student_and_teacher(root, tmp_path):
    """--seed_model X.pth (an alias of --finetune): before the first step
    (--epochs 0) the student and the teacher hold the .pth's weights, in
    storage of their own."""
    seed = tmp_path / "seed.pth"
    src = P.build_model(_args(root, tmp_path, "--seed", "7"), "cpu")[0].state_dict()
    torch.save({"model": src}, str(seed))
    state, printed = _run(root, tmp_path / "out", "--epochs", "0", "--seed_model", str(seed))
    assert "seeded from" in printed and "0 missing, 0 unused" in printed
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, src[k]), k
    for k, v in state.model_ema.items():
        assert torch.equal(v, src[k]) and v.data_ptr() != state.model.state_dict()[k].data_ptr()


def test_masks_are_the_host_ops_from_the_step_generator(root, tmp_path, monkeypatch):
    """The masks each step receives are ``ops.masking``'s from
    mask_generator(seed, step); the softmax is exact for the run even where
    another driver set the bounded one."""
    got = []
    make = P.make_cyclical_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def recorded(state, images, masks, *rest):
            got.append((state.step, masks.clone(), TFA.BOUNDED_SCORES))
            return step(state, images, masks, *rest)

        return recorded

    monkeypatch.setattr(P, "make_cyclical_train_step", recording)
    TFA.BOUNDED_SCORES = True
    _run(root, tmp_path, "--epochs", "1", "--no_save_ckpt")
    assert [s for s, _, _ in got] == [0, 1] and not any(b for _, _, b in got)
    for step, masks, _ in got:
        want = TM.make_blockwise_masks(P.mask_generator(0, step), BATCH, (2, 2), 2, 1)
        np.testing.assert_array_equal(masks.numpy(), want)


def test_handoff_to_finetune_matches_jax(root, tmp_path, capsys):
    """A pretraining checkpoint-0.pth through cli.finetune --finetune: the
    missing and unused keys JAX's import gives on the same state dict, the
    same printed counts as the JAX driver's, the same weights, and the
    finetune's first logits as the JAX finetune model's."""
    _run(root, tmp_path / "pre", "--epochs", "1")
    pth = str(tmp_path / "pre" / "checkpoint-0.pth")
    argv = ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
            "--data_path", str(root), "--batch_size", "8", "--num_workers", "0",
            "--dtype", "float32", "--output_dir", str(tmp_path / "ft"), "--finetune", pth,
            "--eval"]
    jargs = JFT.get_args_parser().parse_args(argv)
    targs = TFT.get_args_parser().parse_args(argv)
    jmodel, _ = JFT.build_model(jargs, 100)
    images = np.random.RandomState(3).randn(4, 32, 32, 3).astype(np.float32)
    capsys.readouterr()
    variables, jmissing = JFT.load_variables(jargs, jmodel, images, return_missing=True)
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    model, _ = TFT.build_model(targs, 100, device="cpu")
    missing = TFT.load_variables(targs, model)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == jline

    _, jmiss, junused = JC.import_torch_params(JC.load_torch_state_dict(pth), variables["params"])
    _, tmiss, tunused = C.import_torch_state_dict(C.load_torch_state_dict(pth), model.state_dict())
    jkeys = sorted(C._torch_key_for(tuple(p.split("/")))[0] for p in jmiss)
    assert sorted(missing) == sorted(tmiss) == jkeys == sorted(
        C._torch_key_for(tuple(p.split("/")))[0] for p in jmissing)
    assert jkeys == ["fc_norm.bias", "fc_norm.weight", "head.bias", "head.weight"]
    assert sorted(tunused) == sorted(junused) == ["lm_head.bias", "lm_head.weight",
                                                  "mask_token", "norm.bias", "norm.weight"]

    want = C.flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables["params"]))
    state = model.state_dict()
    for k, v in want.items():
        if k not in missing:
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    with torch.no_grad():
        for k in missing:
            state[k].copy_(want[k])
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(images))
    jlogits = jmodel.apply(variables, jnp.asarray(images))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("update_freq", [1, 2])
def test_ema_thresholds_count_mini_steps_as_the_jax_driver(root, tmp_path, update_freq):
    """--skip_ema_during_lr_decay_for_tri and --ema_annealing_till_end: the
    thresholds in mini-steps, as JAX cli/pretrain_cyclical.py:107-119 counts
    them, while the EMA rule and the schedules count updates. Under
    --update_freq 1 the teacher freezes where the tri-phase decay starts;
    under 2 it never freezes within the run, and the annealing stops short
    of half of the way to --ema_decay (ROADMAP.md §3)."""
    from uncertainty_vit_tpu_torch.cli import builders as TB
    from uncertainty_vit_tpu_torch.train.ema import cyclical_ema_decay

    epochs, spe = 4, 8
    args = _args(root, tmp_path, "--epochs", str(epochs), "--steps_per_epoch", str(spe),
                 "--update_freq", str(update_freq), "--tri_phase_schedule", "(0.25,0.5)",
                 "--skip_ema_during_lr_decay_for_tri", "--ema_annealing_till_end")
    with redirect_stdout(io.StringIO()):
        hp = P.hparams(args, spe)
    # the JAX driver's formulas (:112, :118)
    assert hp.start_lr_decay_at_step == int((1 - 0.5) * epochs * spe)
    assert hp.ema_start_at == epochs * spe
    lr, _, total = TB.build_lr_schedules(args, spe)
    assert total == epochs * spe // update_freq
    decay_starts = total - int(0.5 * total)
    assert lr(decay_starts - 1) == args.lr and lr(decay_starts) == args.lr
    assert lr(decay_starts + 1) < args.lr
    frozen = [cyclical_ema_decay(u, args.ema_decay, args.ema_decay_init, hp.ema_start_at,
                                 hp.start_lr_decay_at_step) == 1.0 for u in range(total)]
    reached = (total - 1) / hp.ema_start_at  # the warm-up's share the last update reaches
    last = cyclical_ema_decay(total - 1, args.ema_decay, args.ema_decay_init, hp.ema_start_at,
                              -1)
    assert last == pytest.approx(args.ema_decay_init
                                 + reached * (args.ema_decay - args.ema_decay_init), rel=1e-6)
    if update_freq == 1:
        assert frozen.index(True) == decay_starts + 1 and reached == (total - 1) / total
    else:
        assert not any(frozen) and reached < 0.5
