"""PyTorch port: the finetune driver's train loop (``cli.finetune.main``
without ``--eval``), its schedules, optimizer, freezing, checkpoints and
loggers, against the JAX package.

The driver runs ``beit_test_patch16_32`` (2 blocks of width 32, the plain
attention) over tiny CIFAR-100 pickles written by a module fixture, as
tests/test_cli_integration.py:78-89 runs the JAX driver, with
``main(args, device="cpu")``. The pieces the driver builds from the flags are
held against the JAX package's: ``build_lr_schedules`` and
``build_optimizer`` by three updates of the same parameters with the same
gradients through the optax chain and through the port's AdamW (relative
1e-5: f32 Adam updates of two frameworks; the schedules, in f64 here and f32
there, within 1e-6 of max(|lr|, --lr)), ``freeze_all_except`` likewise (the frozen parameters exactly as
they were), the loggers by their numbers and lines for the same inputs
(equal). A run resumed from its checkpoint equals the uninterrupted run bit
for bit (the same per-step generators, the same loader order, CPU
arithmetic in the same order). Both packages' ``BOUNDED_SCORES``, which the
drivers set, are restored after each test.
"""

import io
import json
import math
import os
import pickle
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import uncertainty_vit_tpu.ops.flash_attention as JFA
from uncertainty_vit_tpu.cli import builders as JB
from uncertainty_vit_tpu.cli import finetune as JFT
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.utils import checkpoint as JC
from uncertainty_vit_tpu.utils import logging as JL
from uncertainty_vit_tpu_torch.cli import builders as TB
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train.optim import freeze_all_except
from uncertainty_vit_tpu_torch.utils import checkpoint as TC
from uncertainty_vit_tpu_torch.utils import logging as TL
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

UPDATE_RTOL = 1e-5
N_TRAIN, N_TEST, BATCH = 64, 32, 16


@pytest.fixture(autouse=True)
def restore_bounded_scores():
    prev = (JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    yield
    JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_train")
    base = root / "cifar-100-python"
    base.mkdir()
    rs = np.random.RandomState(0)
    for name, n in (("train", N_TRAIN), ("test", N_TEST)):
        data = rs.randint(0, 256, (n, 3072), dtype=np.uint8)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": (np.arange(n) % 100).tolist()}, f)
    cfg = get_preset("beit_test_patch16_32", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)
    model = VisionTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    torch.save({"model": model.state_dict()}, str(root / "init.pth"))
    return root


def _argv(root, out, *extra):
    return ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
            "--data_path", str(root), "--batch_size", str(BATCH), "--num_workers", "0",
            "--dtype", "float32", "--output_dir", str(out), "--save_ckpt_freq", "1",
            "--steps_per_epoch", "2", "--warmup_epochs", "1", "--layer_decay", "0.65",
            *extra]


def _run(root, out, *extra):
    args = TFT.get_args_parser().parse_args(_argv(root, out, *extra))
    buf = io.StringIO()
    with redirect_stdout(buf):
        state = TFT.main(args, device="cpu")
    return state, buf.getvalue()


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def test_train_writes_checkpoints_and_log(root, tmp_path):
    """Two epochs of two steps from the default train transform (RandAugment,
    erasing, mixup / cutmix) and a --finetune .pth: checkpoint-{0,1,best}.pth,
    a log.txt record an epoch with the test metrics, finite losses and the
    final line."""
    out = tmp_path / "run"
    state, printed = _run(root, out, "--epochs", "2", "--finetune", str(root / "init.pth"))
    assert state.step == 4
    assert {"checkpoint-0.pth", "checkpoint-1.pth", "checkpoint-best.pth", "log.txt"} <= set(
        os.listdir(out))
    log = _log(out)
    assert [r["epoch"] for r in log] == [0, 1]
    for r in log:
        assert math.isfinite(r["train_loss"]) and "test_acc1" in r and "test_ece" in r
        assert r["best_acc1"] == max(x["test_acc1"] for x in log[:r["epoch"] + 1])
    assert "imported" in printed and re.search(r"done\. best acc1 \d+\.\d{3}", printed)
    blob = torch.load(str(out / "checkpoint-1.pth"), weights_only=False)
    assert sorted(blob) == ["epoch", "model", "model_ema", "optimizer", "step"]
    assert (blob["step"], blob["epoch"], blob["model_ema"]) == (4, 1, None)
    for k, v in state.model.state_dict().items():
        assert torch.equal(blob["model"][k], v), k


# (name, extra flags): the warmup and cosine, a cosine weight decay with the
# rel-pos tables left undecayed and a clip, the tri-phase schedule
SCHEDULES = {
    "cosine": ["--warmup_epochs", "1", "--clip_grad", "0"],
    "weight_decay_end": ["--warmup_steps", "3", "--weight_decay_end", "0.2",
                         "--disable_weight_decay_on_rel_pos_bias", "--clip_grad", "0.01"],
    "tri_phase": ["--tri_phase_schedule", "(0.25,0.5)", "--min_lr", "1e-4",
                  "--warmup_lr", "1e-3"],
}


def _jax_and_port(argv, seed=0):
    """(JAX args, port args, JAX params, port model on those params)."""
    jargs = JFT.get_args_parser().parse_args(argv)
    targs = TFT.get_args_parser().parse_args(argv)
    jcfg = JB.model_config_from_args(jargs, 100)
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(JViT(cfg=jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))["params"]
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rs.randn(*s.shape)).astype(np.float32), shapes)
    model = VisionTransformer(TB.model_config_from_args(targs, 100), device="cpu")
    TC.load_flax_params(model, params)
    return jargs, targs, params, model


def _updates_agree(tx, params, model, optimizer, lr, wd, steps=3, seed=1):
    """Apply the same gradients through the optax chain and the port's
    optimizer; the parameters agree after each update, and the port's
    reported norm is the gradients' global norm."""
    rs = np.random.RandomState(seed)
    opt_state = tx.init(params)
    for s in range(steps):
        grads = jax.tree_util.tree_map(lambda p: rs.randn(*p.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        named = dict(model.named_parameters())
        for k, g in TC.flax_to_state_dict(grads).items():
            named[k].grad = g
        norm = optimizer.step(lr(s), wd(s))
        assert abs(float(norm) - float(JO.global_norm(grads))) <= 1e-5 * float(norm)
        want = TC.flax_to_state_dict(jax.device_get(params))
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=UPDATE_RTOL,
                                       atol=1e-7, err_msg=f"{k} after update {s}")
    return params


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedules_and_optimizer_groups_match_jax(root, tmp_path, case):
    """build_lr_schedules / build_optimizer of the same flags: the lr and wd
    at every update equal JAX's, three updates of the same gradients give
    the same parameters (the layer-decay scales, the decay mask, the skip
    list, the clip), and the driver's log.txt lr is the mean of JAX's lr over
    the epoch's updates."""
    argv = _argv(root, tmp_path, "--epochs", "3", *SCHEDULES[case])
    jargs, targs, params, model = _jax_and_port(argv)
    jlr, jwd, jtotal = JB.build_lr_schedules(jargs, 2)
    tlr, twd, ttotal = TB.build_lr_schedules(targs, 2)
    assert ttotal == jtotal == 6 and (twd is None) == (jwd is None) == (case != "weight_decay_end")
    for s in range(jtotal + 1):
        # JAX's schedule is f32 arithmetic on values the size of --lr
        assert abs(tlr(s) - float(jlr(s))) <= 1e-6 * max(abs(tlr(s)), targs.lr), (s, tlr(s))
        if twd is not None:
            assert abs(twd(s) - float(jwd(s))) <= 1e-6 * twd(s)
    tx = JB.build_optimizer(jargs, params, jlr, jwd, 2)
    optimizer = TB.build_optimizer(targs, model, 2)
    groups = {(g["lr_scale"], g["decayed"]) for g in optimizer.optimizer.param_groups}
    assert len({s for s, _ in groups}) == 4  # 0.65^3 .. 1 over depth 2 + 2
    decayed = {n for n, p in model.named_parameters()
               if any(p is q for g in optimizer.optimizer.param_groups if g["decayed"]
                      for q in g["params"])}
    assert ("rel_pos_bias.relative_position_bias_table" in decayed) == (
        case != "weight_decay_end")
    wd = twd or (lambda s: targs.weight_decay)
    _updates_agree(tx, params, model, optimizer, tlr, wd)
    # the driver's records over 3 epochs of 2 updates
    out = tmp_path / "run"
    _run(root, out, "--epochs", "3", *SCHEDULES[case])
    for r in _log(out):
        want = np.mean([float(jlr(2 * r["epoch"] + i)) for i in range(2)])
        assert abs(r["train_lr"] - want) <= 1e-6 * max(want, targs.lr), (r["epoch"], r["train_lr"])


def test_freeze_all_except_matches_the_optax_chain(root, tmp_path):
    """Linear-probe freezing: the frozen parameters stay as they were, bit
    for bit; the head moves as JAX's does, whose update sees the clip of the
    global norm over every gradient, frozen ones included."""
    argv = _argv(root, tmp_path, "--clip_grad", "0.05")
    jargs, targs, params, model = _jax_and_port(argv)
    lr, _, _ = TB.build_lr_schedules(targs, 2)
    jlr, _, _ = JB.build_lr_schedules(jargs, 2)
    optimizer = freeze_all_except(TB.build_optimizer(targs, model, 2), ["head"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    # updates at lr(1), lr(2), lr(3): the warmup's first value is 0
    tx = JO.freeze_all_except(JB.build_optimizer(jargs, params, lambda s: jlr(s + 1), None, 2),
                              params, ["head"])
    _updates_agree(tx, params, model, optimizer, lambda s: lr(s + 1),
                   lambda s: targs.weight_decay)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]) == (not k.startswith("head.")), k


def test_linear_probe_run_trains_only_the_head(root, tmp_path):
    """--linear_classifier with --finetune: the driver names the head as the
    trainable part, and after two steps every other parameter is the
    checkpoint's."""
    state, printed = _run(root, tmp_path / "probe", "--epochs", "1", "--linear_classifier",
                          "--finetune", str(root / "init.pth"), "--warmup_epochs", "0")
    assert "linear probe: trainable params = ['head']" in printed
    init = torch.load(str(root / "init.pth"))["model"]
    for k, v in state.model.state_dict().items():
        if k in init and not k.startswith("head."):
            assert torch.equal(v, init[k]), k
    assert not torch.equal(state.model.head.weight, init["head.weight"])


def test_ema_starts_from_the_imported_weights(root, tmp_path):
    """--model_ema with --finetune: the EMA starts from the checkpoint's
    weights, as the reference creates its ModelEma after the import
    (run_class_finetuning.py:545-553); after one update at decay 0.5 it is
    the mean of those and the updated parameters (the JAX driver's EMA
    starts from its random init, ROADMAP.md §3)."""
    state, _ = _run(root, tmp_path / "ema", "--epochs", "1", "--steps_per_epoch", "1",
                    "--warmup_epochs", "0", "--model_ema", "--model_ema_decay", "0.5",
                    "--finetune", str(root / "init.pth"))
    init = torch.load(str(root / "init.pth"))["model"]
    params = dict(state.model.named_parameters())
    assert state.model_ema.keys() == params.keys()
    moved = 0
    for k, e in state.model_ema.items():
        torch.testing.assert_close(e, 0.5 * init[k] + 0.5 * params[k].detach(), rtol=0,
                                   atol=1e-6)
        moved += int(not torch.equal(params[k], init[k]))
    assert moved > 0


def _state_blob(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            state.optimizer.state_dict(), state.step,
            None if state.model_ema is None else {k: v.clone() for k, v in state.model_ema.items()})


def _same_state(a, b):
    (ma, oa, sa, ea), (mb, ob, sb, eb) = a, b
    assert sa == sb
    assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)
    assert (ea is None) == (eb is None)
    if ea is not None:
        assert all(torch.equal(ea[k], eb[k]) for k in ea)
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def test_resumed_run_equals_the_uninterrupted_run(root, tmp_path):
    """Two epochs straight against one epoch and then the same command with
    --epochs 2, which auto-resumes from checkpoint-0.pth: the model, the
    AdamW moments, the step, the EMA and the second epoch's record are the
    same bit for bit."""
    extra = ["--finetune", str(root / "init.pth"), "--model_ema", "--model_ema_decay", "0.9"]
    straight, _ = _run(root, tmp_path / "a", "--epochs", "2", *extra)
    _run(root, tmp_path / "b", "--epochs", "1", *extra)
    resumed, printed = _run(root, tmp_path / "b", "--epochs", "2", *extra)
    assert "resuming from" in printed and "checkpoint-0.pth" in printed
    _same_state(_state_blob(straight), _state_blob(resumed))
    assert _log(tmp_path / "a") == _log(tmp_path / "b")


def test_checkpoint_round_trips(tmp_path):
    """save → restore into a fresh state: model, AdamW state, step and EMA
    as they were; a --finetune of the file reads its model."""
    cfg = get_preset("beit_test_patch16_32", num_classes=10, drop_path_rate=0.1)

    def fresh(seed):
        model = VisionTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
        opt = TB.build_optimizer(TFT.get_args_parser().parse_args(["--layer_decay", "0.7"]),
                                 model, cfg.depth)
        return TE.init_finetune_state(model, opt, use_model_ema=True)

    state = fresh(0)
    step = TE.make_finetune_train_step(state.model, state.optimizer,
                                       TE.FinetuneHParams(num_classes=10, model_ema_decay=0.5),
                                       lambda s: 1e-3)
    images = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    labels = torch.arange(4)
    for s in range(2):
        g = TE.step_generators(0, s, "cpu")
        step(state, images, labels, g.model, g.mix)
    path = TC.save_checkpoint(str(tmp_path), 7, state, epoch=7)
    assert os.path.basename(path) == "checkpoint-7.pth"
    other = fresh(1)
    assert not torch.equal(other.model.head.weight, state.model.head.weight)
    TC.restore_checkpoint(path, other)
    _same_state(_state_blob(state), _state_blob(other))
    sd = TC.load_torch_state_dict(path)
    assert all(torch.equal(sd[k], v) for k, v in state.model.state_dict().items())


def test_latest_checkpoint_and_auto_load_follow_jax(tmp_path):
    """The highest numbered checkpoint wins (best, temporaries and other
    names do not count), auto_load resumes at N + 1 and returns the state
    untouched (epoch 0) without one: the JAX package's rules on its own
    names."""
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert TC.latest_checkpoint(str(port)) is None and JC.latest_checkpoint(str(jax_dir)) is None
    port.mkdir()
    jax_dir.mkdir()
    sentinel = object()
    assert TC.auto_load(str(port), sentinel) == (sentinel, 0)
    assert JC.auto_load(str(jax_dir), sentinel) == (sentinel, 0)
    for n in ("0", "12", "3", "best"):
        (port / f"checkpoint-{n}.pth").write_bytes(b"")
        (jax_dir / f"checkpoint-{n}").mkdir()
    (port / "checkpoint-40.pth.tmp").write_bytes(b"")
    (port / "checkpoint-41").mkdir()
    (port / "xcheckpoint-50.pth").write_bytes(b"")
    (jax_dir / "checkpoint-40.tmp").mkdir()
    n, path = TC.latest_checkpoint(str(port))
    assert (n, os.path.basename(path)) == (12, "checkpoint-12.pth")
    assert JC.latest_checkpoint(str(jax_dir))[0] == n


def test_start_epoch_rules(root, tmp_path):
    """--start_epoch on a fresh run starts the epochs and the schedules there
    (the step is epoch × steps); a checkpoint found by auto-resume wins when
    it is later, --start_epoch when it is; --no_auto_resume ignores the
    checkpoints."""
    out = tmp_path / "run"
    state, _ = _run(root, out, "--epochs", "2", "--start_epoch", "1")
    assert state.step == 2 + 2 and [r["epoch"] for r in _log(out)] == [1]
    lr, _, _ = TB.build_lr_schedules(TFT.get_args_parser().parse_args(_argv(root, out,
                                                                           "--epochs", "2")), 2)
    assert abs(_log(out)[0]["train_lr"] - (lr(2) + lr(3)) / 2) <= 1e-12
    # auto-resume finds checkpoint-1 (next epoch 2) over --start_epoch 1
    state, _ = _run(root, out, "--epochs", "3", "--start_epoch", "1")
    assert state.step == 6 and [r["epoch"] for r in _log(out)] == [1, 2]
    # --start_epoch 4 over the checkpoint's 3: no epoch left to run
    state, printed = _run(root, out, "--epochs", "4", "--start_epoch", "4")
    assert state.step == 6 and "resuming from" in printed and len(_log(out)) == 2
    state, printed = _run(root, out, "--epochs", "1", "--no_auto_resume")
    assert state.step == 2 and "resuming" not in printed


def test_finetune_reads_the_ports_own_checkpoint(root, tmp_path):
    """--eval --finetune checkpoint-best.pth imports every entry (none
    missing) and gives the metrics its epoch logged."""
    out = tmp_path / "run"
    _run(root, out, "--epochs", "1")
    args = TFT.get_args_parser().parse_args(_argv(root, out, "--eval", "--finetune",
                                                  str(out / "checkpoint-best.pth")))
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = TFT.main(args, device="cpu")["eval"]
    assert "imported" in buf.getvalue() and ": 0 missing, 0 unused" in buf.getvalue()
    logged = _log(out)[0]
    for k, v in res.items():
        assert abs(v - logged[f"test_{k}"]) <= 1e-6 * max(abs(v), 1.0), k


def test_loggers_match_jax(tmp_path, monkeypatch, capsys):
    """SmoothedValue / MetricLogger (numbers, epoch summary and the lines
    log_every prints, on the same clock) and JsonlLogger (the same lines)
    against the JAX package's."""
    values = [3.5, 1.25, 7.0, 2.0, 9.5, 0.5]
    out = {}
    for name, mod in (("jax", JL), ("port", TL)):
        clock = iter(np.arange(0.0, 1000.0, 0.25))
        monkeypatch.setattr(mod.time, "time", lambda: float(next(clock)))
        monkeypatch.setattr(mod, "device_memory_mb", lambda: 0.0)
        sv = mod.SmoothedValue(window_size=4)
        for v in values:
            sv.update(v, n=2)
        logger = mod.MetricLogger()
        for i in logger.log_every(list(range(5)), 2, "Epoch: [3]"):
            logger.update(loss=values[i], lr=np.float32(0.5) * i, skip=None)
        printed = capsys.readouterr().out
        jsonl = mod.JsonlLogger(str(tmp_path / name))
        jsonl.write({"epoch": np.int64(3), "a": np.float32(0.25), "b": 1.5,
                     "c": jnp.asarray(2.0) if name == "jax" else torch.tensor(2.0)})
        with open(tmp_path / name / "log.txt") as f:
            line = f.read()
        out[name] = (sv.median, sv.avg, sv.global_avg, sv.max, sv.value, str(sv),
                     str(logger), logger.epoch_summary(), printed, line)
        monkeypatch.undo()
    assert out["port"] == out["jax"]
    assert "Epoch: [3] [4/5]" in out["port"][8]


def test_profile_trace_writes_a_trace(tmp_path):
    """profile_trace (the JAX package's jax.profiler context) writes a
    torch.profiler trace of what runs inside, and nothing when disabled."""
    with TL.profile_trace(str(tmp_path / "on")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = os.listdir(tmp_path / "on")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(tmp_path / "on" / traces[0]) as f:
        assert any("mm" in e.get("name", "") for e in json.load(f)["traceEvents"])
    with TL.profile_trace(str(tmp_path / "off"), enabled=False):
        torch.ones(2) + 1
    assert not os.path.exists(tmp_path / "off")
