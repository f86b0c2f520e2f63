"""PyTorch port, slice 7c: token masking, gradient accumulation, the driver
at a larger --input_size than its checkpoint's, and --eval under
--seq_parallel, against the JAX package.

Masking: a narrow model with ``has_masking`` on JAX weights crossed with
``load_flax_params`` and an injected ``bool_masked_pos``: training logits
and gradients against JAX ``model.apply(..., bool_masked_pos,
deterministic=False)`` at drop 0 (forward rtol 2e-4 / atol 2e-5, backward
rtol 1e-3 / atol 1e-4: tests/test_flash_attention.py:52,67); the JAX
attention runs its Pallas kernels in interpret mode, the port K1/K2's
plain versions. Accumulation: four mini-steps at update_freq 2 through the
port's step and the JAX step over ``optax.MultiSteps`` on the same
parameters and batches (drop 0, mixup off): the parameters after each
within ``UPDATE_RTOL`` (where Adam's first update is well posed, as
tests/test_torch_port_train.py holds one step), lr and grad_norm at rtol
1e-5. A driver run resumed where an epoch ends inside an accumulation window
equals the uninterrupted run bit for bit (CPU arithmetic in the same order).

One spawn of two gloo ranks: ``main(args, device="cpu")`` under --eval
--seq_parallel 2 at --input_size 96 from a .pth of the preset at 64 (the
pos-embed-free model's rel-pos tables resized on import), against the JAX
driver under --seq_parallel 2 on the conftest's 8 virtual devices and the
port's single rank: acc1 / acc5 equal, the other metrics within 1e-5.
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

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as JFA
from uncertainty_vit_tpu.cli import finetune as JFT
from uncertainty_vit_tpu.core.config import ViTConfig
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.train import engine_finetune as JE
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu.utils import checkpoint as JC
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils import checkpoint as TC

FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
BWD_RTOL, BWD_ATOL = 1e-3, 1e-4
UPDATE_RTOL = 1e-5
METRIC_ATOL = 1e-5
SMALL = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2, num_classes=10,
             init_values=0.1, use_shared_rel_pos_bias=True)
N_TEST = 32


@pytest.fixture(autouse=True)
def interpret_mode():
    prev = (JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    JFA.INTERPRET = True
    yield
    JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


def _numpy_params(shapes, seed):
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if "kernel" in name:
            return (rs.randn(*leaf.shape) / math.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return (0.2 * rs.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _models(seed=0, batch=4, **overrides):
    """(JAX model, its numpy params, the port's model on them, images, labels)."""
    kw = dict(SMALL, **overrides)
    rs = np.random.RandomState(seed + 100)
    images = rs.randn(batch, 32, 32, 3).astype(np.float32)
    labels = rs.randint(0, kw["num_classes"], size=batch).astype(np.int32)
    jmodel = JViT(cfg=ViTConfig(**kw))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    params = _numpy_params(shapes, seed)
    model = TC.load_flax_params(VisionTransformer(TViTConfig(**kw), device="cpu"), params)
    return jmodel, params, model, images, labels


# ---------------------------------------------------------------------------
# token masking
# ---------------------------------------------------------------------------

def test_masked_training_forward_and_grads_match_jax():
    """has_masking: the training forward with an injected mask and its
    gradients (the mask token's included) against JAX's."""
    jmodel, params, model, images, _ = _models(seed=1, has_masking=True)
    mask = (np.random.RandomState(3).rand(4, 4) < 0.5).astype(np.float32)
    mask[0] = [1, 0, 1, 0]  # some tokens masked and some not in every image
    cot = np.random.RandomState(4).randn(4, SMALL["num_classes"]).astype(np.float32)
    rngs = {"dropout": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(images), jnp.asarray(mask),
                              deterministic=False, rngs=rngs)
        return jnp.sum(logits * cot), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model.train()
    logits = model(torch.from_numpy(images), generator=torch.Generator().manual_seed(0),
                   bool_masked_pos=torch.from_numpy(mask))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    (logits * torch.from_numpy(cot)).sum().backward()
    want = TC.flax_to_state_dict(jgrads)
    assert "mask_token" in want and want["mask_token"].abs().max() > 0
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=BWD_RTOL, atol=BWD_ATOL,
                                   err_msg=k)
    # the mask changed the training forward
    unmasked = model(torch.from_numpy(images), generator=torch.Generator().manual_seed(0))
    assert (unmasked - logits).abs().max() > 1e-3


def test_evaluation_ignores_the_mask():
    """mask_only_when_training: the eval forward is the same with and
    without a mask, and JAX's deterministic apply with the mask."""
    jmodel, params, model, images, _ = _models(seed=2, has_masking=True)
    mask = torch.ones(4, 4)
    model.eval()
    with torch.no_grad():
        plain = model(torch.from_numpy(images))
        masked = model(torch.from_numpy(images), bool_masked_pos=mask)
        explicit = model(torch.from_numpy(images), deterministic=True, bool_masked_pos=mask)
    assert torch.equal(plain, masked) and torch.equal(plain, explicit)
    ref = jmodel.apply({"params": params}, jnp.asarray(images), jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), rtol=FWD_RTOL, atol=FWD_ATOL)


def test_mask_token_round_trips_through_export_and_import():
    """The JAX exporter's mask_token is the port's (load_flax_params and
    the .pth import); the port's state dict imports into the JAX params; a
    .pth without it leaves the model's init and lists it as missing, as the
    JAX import does."""
    _, params, model, _, _ = _models(seed=3, has_masking=True)
    exported = JC.export_torch_state_dict(params)
    np.testing.assert_array_equal(model.mask_token.detach().numpy(), exported["mask_token"])
    fresh = VisionTransformer(TViTConfig(**SMALL, has_masking=True), device="cpu",
                              generator=torch.Generator().manual_seed(9))
    state, missing, unused = TC.import_torch_state_dict(exported, fresh.state_dict())
    assert missing == [] and unused == []
    assert torch.equal(state["mask_token"], model.mask_token.detach())
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back, jmissing, _ = JC.import_torch_params(sd, params)
    assert jmissing == []
    np.testing.assert_array_equal(np.asarray(back["backbone"]["mask_token"]), sd["mask_token"])
    del sd["mask_token"]
    state, missing, _ = TC.import_torch_state_dict(sd, fresh.state_dict())
    _, jmissing, _ = JC.import_torch_params(sd, params)
    assert missing == ["mask_token"] and jmissing == ["backbone/mask_token"]
    assert torch.equal(state["mask_token"], fresh.mask_token.detach())


def test_masking_leaves_the_other_parameters_drawn_as_without_it():
    """The mask token is drawn after the blocks: every other parameter the
    backbone registers is the one the same seed gives without masking (the
    head, drawn after it, is not); it counts among the token parameters."""
    def build(masking):
        return VisionTransformer(TViTConfig(**SMALL, has_masking=masking), device="cpu",
                                 generator=torch.Generator().manual_seed(5))

    a, b = build(False), build(True)
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sb) - set(sa) == {"mask_token"}
    backbone = [k for k in sa if not k.startswith(("head.", "fc_norm."))]
    assert all(torch.equal(sa[k], sb[k]) for k in backbone)
    assert any(p is b.mask_token for p in b.token_parameters())


def test_train_step_draws_the_mask_at_its_rate():
    """The step draws bool_masked_pos [B, num_patches] f32 from its model
    generator at masked_position_prob (within 4σ), a new one each step, the
    same from the same seed."""
    _, _, model, _, _ = _models(seed=4, has_masking=True, drop_path_rate=0.0)
    seen = []
    forward = model.forward
    model.forward = lambda *a, **k: (seen.append(k["bool_masked_pos"]), forward(*a, **k))[1]
    opt = TO.make_optimizer(model)
    p = 0.3
    step = TE.make_finetune_train_step(
        model, opt, TE.FinetuneHParams(num_classes=10, mixup_active=False,
                                       masked_position_prob=p), TS.constant_schedule(1e-4))
    state = TE.init_finetune_state(model, opt)
    x = torch.randn(64, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.arange(64) % 10
    for seed in (0, 1, 0):
        step(state, x, y, torch.Generator().manual_seed(seed))
    m = seen[0]
    assert m.shape == (64, 4) and m.dtype == torch.float32 and set(m.unique().tolist()) <= {0, 1}
    n = m.numel()
    assert abs(m.mean().item() - p) < 4 * math.sqrt(p * (1 - p) / n)
    assert not torch.equal(seen[0], seen[1]) and torch.equal(seen[0], seen[2])


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------

def test_accumulated_steps_match_optax_multisteps():
    """Four mini-steps at update_freq 2, clip 0.5 (on the window's mean):
    the parameters after each mini-step against the JAX step over
    optax.MultiSteps, unchanged (bit for bit) inside a window; each
    mini-step's lr (at the update index) and grad_norm (of its own
    gradient); the EMA moves only on the boundaries."""
    jmodel, params, model, _, _ = _models(seed=5)
    rs = np.random.RandomState(11)
    batches = [(rs.randn(4, 32, 32, 3).astype(np.float32),
                rs.randint(0, 10, size=4).astype(np.int32)) for _ in range(4)]
    hp = dict(num_classes=10, mixup_active=False, label_smoothing=0.1, update_freq=2,
              model_ema_decay=0.5)
    kw = dict(weight_decay=0.05, clip_grad=0.5, layer_decay=0.65, depth=SMALL["depth"])
    lr = JS.cosine_schedule(1e-3, 1e-5, 10)
    tx = JO.make_optimizer(params, lr, accum_steps=2, **kw)
    jstate = JE.FinetuneState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros([], jnp.int32))
    jstep = JE.make_finetune_train_step(jmodel, tx, JE.FinetuneHParams(**hp), lr)
    opt = TO.make_optimizer(model, update_freq=2, **kw)
    state = TE.init_finetune_state(model, opt, use_model_ema=True)
    step = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**hp),
                                       TS.cosine_schedule(1e-3, 1e-5, 10))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ema_before = {k: v.clone() for k, v in state.model_ema.items()}

    def jgrad(p, x, y):
        targets = jax.nn.one_hot(y, 10) * 0.9 + 0.01
        logits = jmodel.apply({"params": p}, jnp.asarray(x), None, deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(0),
                                    "droppath": jax.random.PRNGKey(0)})
        return -jnp.mean(jnp.sum(targets * jax.nn.log_softmax(logits), -1))

    # Adam's update is lr·m̂/(√v̂ + eps): where a window's mean gradient is
    # ≲ 1e-6 the f32 rounding of it moves the update by up to one lr step,
    # in that update and the ones after
    well_posed = {k: torch.ones_like(v, dtype=torch.bool) for k, v in before.items()}
    grad = jax.jit(jax.grad(jgrad))
    for i, (x, y) in enumerate(batches):
        if i % 2 == 0:
            window = [grad(jstate.params, *batches[j]) for j in (i, i + 1)]
            mean = TC.flax_to_state_dict(jax.tree_util.tree_map(lambda a, b: (a + b) / 2,
                                                                *window))
            well_posed = {k: w & (mean[k].abs() > 1e-6) for k, w in well_posed.items()}
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(i))
        m = step(state, torch.from_numpy(x), torch.from_numpy(y).long(),
                 torch.Generator().manual_seed(i))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=(i, k))
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6, err_msg=i)
        assert m["lr"] == TS.cosine_schedule(1e-3, 1e-5, 10)(i // 2)
        now = model.state_dict()
        if i % 2 == 0:  # inside the window: nothing moves
            assert all(torch.equal(now[k], before[k]) for k in now), i
            assert all(torch.equal(state.model_ema[k], ema_before[k]) for k in ema_before), i
            assert opt.mini_step == 1
        else:
            assert opt.mini_step == 0
            ref = TC.flax_to_state_dict(jax.device_get(jstate.params))
            for k, v in now.items():
                w = well_posed[k]
                np.testing.assert_allclose(v[w].numpy(), ref[k][w].numpy(), rtol=UPDATE_RTOL,
                                           atol=1e-6, err_msg=(i, k))
                assert (v - ref[k]).abs().max().item() <= 2e-3, (i, k)
                assert w.float().mean().item() > 0.99, (i, k)
            for k, e in state.model_ema.items():
                torch.testing.assert_close(e, 0.5 * ema_before[k] + 0.5 * now[k], rtol=0,
                                           atol=1e-7)
            before = {k: v.clone() for k, v in now.items()}
            ema_before = {k: v.clone() for k, v in state.model_ema.items()}
    assert int(jstate.step) == state.step == 4


def test_accumulator_state_round_trips():
    """The optimizer's state dict carries the window's count and mean
    gradient; loading it into a fresh optimizer continues the window, and a
    state saved without accumulation does not load into one with it."""
    _, _, model, _, _ = _models(seed=6)
    opt = TO.make_optimizer(model, update_freq=3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step(1e-3, 0.0)
    sd = opt.state_dict()
    assert sd["multi_steps"]["mini_step"] == 1
    other = TO.make_optimizer(model, update_freq=3)
    other.load_state_dict(sd)
    assert other.mini_step == 1 and all(torch.equal(a, b) for a, b in zip(other._acc, opt._acc))
    with pytest.raises(ValueError, match="accumulation"):
        TO.make_optimizer(model).load_state_dict(sd)
    with pytest.raises(ValueError, match="accumulation"):
        other.load_state_dict(TO.make_optimizer(model).state_dict())


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """CIFAR-100 pickles of 48 train / 32 test seeded images and .pth files
    of the narrow preset at 32 and at 64 (shared rel-pos table at std 0.2,
    head at 0.5)."""
    from uncertainty_vit_tpu_torch.core.init import trunc_normal

    root = tmp_path_factory.mktemp("cli_7c")
    base = root / "cifar-100-python"
    base.mkdir()
    rs = np.random.RandomState(0)
    for name, n in (("train", 48), ("test", N_TEST)):
        data = rs.randint(0, 256, (n, 3072), dtype=np.uint8)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": (np.arange(n) % 100).tolist()}, f)
    for size, name in ((32, "init.pth"), (64, "init64.pth")):
        cfg = get_preset("beit_test_patch16_32", img_size=size, num_classes=100,
                         use_shared_rel_pos_bias=True, use_abs_pos_emb=False, init_values=0.1)
        gen = torch.Generator().manual_seed(1)
        model = VisionTransformer(cfg, device="cpu", generator=gen)
        with torch.no_grad():
            trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
            trunc_normal(0.5, 2.0)(model.head.weight, gen)
        torch.save({"model": model.state_dict()}, str(root / name))
    return root


def _argv(root, out, *extra):
    return ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
            "--data_path", str(root), "--batch_size", "16", "--num_workers", "0",
            "--dtype", "float32", "--output_dir", str(out), "--finetune", str(root / "init.pth"),
            *extra]


def _port(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = TFT.main(TFT.get_args_parser().parse_args(argv), device="cpu")
    return out, buf.getvalue()


def test_resume_inside_an_accumulation_window_equals_the_uninterrupted_run(root, tmp_path):
    """3 steps an epoch at update_freq 2, with token masking and elem mixup
    on cutmix_minmax boxes: checkpoint-0.pth falls inside a window, and the
    run resumed from it equals two epochs straight, bit for bit (model,
    AdamW moments, the window's count and mean gradient, step, EMA, log)."""
    extra = ["--steps_per_epoch", "3", "--update_freq", "2", "--masked_position_prob", "0.25",
             "--mixup_mode", "elem", "--cutmix_minmax", "0.25", "0.75", "--aa", "none",
             # a constant lr: the schedule's length is --epochs, which the
             # two runs differ in
             "--lr", "1e-3", "--min_lr", "1e-3", "--warmup_epochs", "0",
             "--model_ema", "--model_ema_decay", "0.9",
             "--layer_decay", "0.65", "--save_ckpt_freq", "1"]
    straight, _ = _port(_argv(root, tmp_path / "a", "--epochs", "2", *extra))
    _port(_argv(root, tmp_path / "b", "--epochs", "1", *extra))
    saved = torch.load(str(tmp_path / "b" / "checkpoint-0.pth"), weights_only=False)
    assert saved["optimizer"]["multi_steps"]["mini_step"] == 1
    resumed, printed = _port(_argv(root, tmp_path / "b", "--epochs", "2", *extra))
    assert "resuming from" in printed
    assert straight.step == resumed.step == 6
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(straight.model_ema[k], resumed.model_ema[k]) for k in a)
    oa, ob = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert oa["multi_steps"]["mini_step"] == ob["multi_steps"]["mini_step"] == 0
    assert all(torch.equal(x, y) for x, y in zip(oa["multi_steps"]["acc"],
                                                 ob["multi_steps"]["acc"]))
    for i, st in oa["state"].items():
        assert all(torch.equal(v, ob["state"][i][k]) for k, v in st.items()), i
    logs = [open(tmp_path / d / "log.txt").read() for d in "ab"]
    assert logs[0] == logs[1] and len(logs[0].splitlines()) == 2


def test_seq_parallel_refusals(root, tmp_path):
    """Under --seq_parallel, attention dropout raises with the JAX package's
    words before any rank starts wherever a forward draws: in training and
    under --mc_dropout. --mc_dropout alone runs there
    (tests/test_torch_port_seq_eval.py)."""
    with pytest.raises(ValueError, match="sequence-parallel attention requires attn_drop=0"):
        _port(_argv(root, tmp_path, "--eval", "--seq_parallel", "2", "--mc_dropout",
                    "--attn_drop_rate", "0.1"))
    with pytest.raises(ValueError, match="sequence-parallel attention requires attn_drop=0"):
        _port(_argv(root, tmp_path, "--seq_parallel", "2", "--attn_drop_rate", "0.1"))
    # a deterministic evaluation has no attention dropout to refuse: the JAX
    # driver's shared model builder takes the flag there too
    for extra in (["--attn_drop_rate", "0.1"], ["--mc_dropout"]):
        args = TFT.get_args_parser().parse_args(
            _argv(root, tmp_path, "--eval", "--seq_parallel", "2", *extra))
        TFT._check_seq_flags(args)


@pytest.fixture(scope="module")
def evals(root):
    """--eval at --input_size 96 from the 64 .pth: {run: results dict} for
    the JAX driver under --seq_parallel 2 and 1, the port under 2 (one
    spawn of two gloo ranks) and 1. (From 32 the JAX import cannot resize
    the rel-pos table: its bicubic spline needs more than 3 points an axis,
    and the 2 × 2 grid's table has 3.)"""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JFA, "BOUNDED_SCORES", JFA.BOUNDED_SCORES)
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        mp.delenv("UVIT_ATTN_BOUNDED_SCORES", raising=False)
        for s in (2, 1):
            argv = _argv(root, root / "out", "--eval", "--input_size", "96", "--seq_parallel",
                         str(s))
            argv[argv.index("--finetune") + 1] = str(root / "init64.pth")
            out[f"jax{s}"] = JFT.main(JFT.get_args_parser().parse_args(argv))
            out[f"port{s}"], out[f"printed{s}"] = _port(argv)
    return out


def _same_metrics(got, want, where):
    assert sorted(got) == sorted(want), where
    for k, v in want.items():
        assert math.isfinite(got[k]), (where, k)
        if k in ("acc1", "acc5"):
            assert round(got[k] * N_TEST / 100) == round(v * N_TEST / 100), (where, k, got[k], v)
        else:
            assert abs(got[k] - v) <= METRIC_ATOL, (where, k, got[k], v)


@pytest.mark.parametrize("run", ["port2", "port1"])
def test_eval_at_a_larger_input_size_matches_jax(evals, run):
    """The eval dict of the 64 checkpoint at 96 (eval resize and crop, the
    rel-pos tables resized on import) against the JAX driver's under the
    same --seq_parallel, and the port's two ranks against its single rank."""
    s = run[-1]
    assert list(evals[run]) == ["eval"]
    _same_metrics(evals[run]["eval"], evals[f"jax{s}"]["eval"], run)
    _same_metrics(evals["port2"]["eval"], evals["port1"]["eval"], "ranks")
    json.dumps(evals[run])


def test_seq_eval_imports_the_checkpoint_resized(evals):
    """The single-rank run printed the import (its model is the 64 .pth's at
    96: no entry missing, none unused); under --seq_parallel rank 0 printed
    in the ranks' own processes, not here."""
    assert ": 0 missing, 0 unused" in evals["printed1"]
    assert "imported" not in evals["printed2"]
