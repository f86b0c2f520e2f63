"""PyTorch port: the BEiT MIM, joint and dVAE-training drivers
(``cli.pretrain_beit``, ``cli.pretrain_joint``, ``cli.train_dvae``) over
tiny CIFAR-100 pickles, the tokenizer hand-off between them, and the
pretrain → finetune hand-off, against the JAX package.

The pretrainers run ``beit_test_patch16_32`` (2 blocks of width 32, the
plain attention, a 2×2 grid) with ``main(args, device="cpu")``; their
tokenizer is a DiscreteVAE of 2 layers on 8×8 views (2×2 tokens), trained
here by ``cli.train_dvae`` and read back through its
``checkpoint-dvae-weights.pth``. A run stopped after an epoch and
auto-resumed equals the uninterrupted run bit for bit (the per-step
generators, the loader's order and the masks are functions of (seed,
step)). log.txt's keys are the JAX drivers': the JAX steps' metric names
(by ``jax.eval_shape``), with "train_" before each for the dVAE trainer.
The hand-off: a port ``checkpoint-N.pth`` read by ``cli.finetune`` gives
the missing and unused keys JAX ``import_torch_params`` gives on the same
state dict, and the finetune model's logits within 2e-4 / 2e-5 of the JAX
finetune model's. Both packages' ``BOUNDED_SCORES``, which the drivers set,
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
from tests.test_torch_port_mim import save_dalle_pickles
from uncertainty_vit_tpu.cli import finetune as JFT
from uncertainty_vit_tpu.cli import train_dvae as JTD
from uncertainty_vit_tpu.core.config import ViTConfig as JConfig
from uncertainty_vit_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from uncertainty_vit_tpu.models.mim import JointViT as JJoint
from uncertainty_vit_tpu.models.mim import MIMViT as JMIM
from uncertainty_vit_tpu.train import engine_cyclical as JEC
from uncertainty_vit_tpu.train import engine_mim as JE
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu.utils import checkpoint as JC
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.cli import pretrain_beit as PB
from uncertainty_vit_tpu_torch.cli import pretrain_joint as PJ
from uncertainty_vit_tpu_torch.cli import train_dvae as TD
from uncertainty_vit_tpu_torch.models import dalle_vae as TDV
from uncertainty_vit_tpu_torch.models.dalle_vae import DalleVAE
from uncertainty_vit_tpu_torch.models.dvae import DiscreteVAE
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.ops import masking as TM
from uncertainty_vit_tpu_torch.train.engine_cyclical import mask_generator
from uncertainty_vit_tpu_torch.utils import checkpoint as C
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

N_TRAIN, BATCH = 48, 8
TOKENIZER = ["--vocab_size", "64", "--dvae_num_layers", "2", "--dvae_hidden_dim", "8"]


@pytest.fixture(autouse=True)
def restore_bounded_scores():
    prev = (JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    yield
    JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_mim")
    base = root / "cifar-100-python"
    base.mkdir()
    rs = np.random.RandomState(0)
    for name, n in (("train", N_TRAIN), ("test", 16)):
        data = rs.randint(0, 256, (n, 3072), dtype=np.uint8)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": (np.arange(n) % 100).tolist()}, f)
    return root


def _quiet(fn, *args, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _dvae_args(root, out, *extra):
    return TD.get_args_parser().parse_args([
        "--data_set", "CIFAR100", "--data_path", str(root), "--input_size", "8",
        "--batch_size", str(BATCH), "--num_workers", "0", "--output_dir", str(out),
        "--save_ckpt_freq", "1", "--steps_per_epoch", "2", "--temperature_anneal_steps", "3",
        *TOKENIZER, *extra])


@pytest.fixture(scope="module")
def dvae_weights(root, tmp_path_factory):
    """cli.train_dvae's weights after 2 epochs of 2 steps: the pretrainers'
    tokenizer (and the straight run the resumed one is held to)."""
    out = tmp_path_factory.mktemp("dvae")
    state, printed = _quiet(TD.main, _dvae_args(root, out, "--epochs", "2"), device="cpu")
    return str(out / "checkpoint-dvae-weights.pth"), state, out


def _pre_args(parser, root, out, *extra):
    return parser.parse_args([
        "--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
        "--data_path", str(root), "--batch_size", str(BATCH), "--num_workers", "0",
        "--dtype", "float32", "--output_dir", str(out), "--save_ckpt_freq", "1",
        "--steps_per_epoch", "2", "--warmup_epochs", "1", "--num_mask_patches", "2",
        "--min_mask_patches_per_block", "1", "--clip_grad", "3.0", "--drop_path", "0.25",
        "--attn_drop_rate", "0.05", "--second_input_size", "8", *TOKENIZER, *extra])


def _snapshot(state):
    teacher = state.model_ema
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "teacher": None if teacher is None else {k: v.detach().clone()
                                                     for k, v in teacher.items()},
            "optimizer": copy.deepcopy(state.optimizer.state_dict()), "step": state.step}


def _equal(a, b):
    assert a["step"] == b["step"]
    assert (a["teacher"] is None) == (b["teacher"] is None)
    for part in ("model", "teacher"):
        if a[part] is None:
            continue
        assert a[part].keys() == b[part].keys()
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k, v in sa[i].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb[i][k])), (i, k)


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _recording_auto_load(monkeypatch, module):
    loaded = []
    auto_load = C.auto_load

    def recording(output_dir, state):
        state, epoch = auto_load(output_dir, state)
        loaded.append((epoch, _snapshot(state)))
        return state, epoch

    monkeypatch.setattr(module.C, "auto_load", recording)
    return loaded


def _resumed_equals_straight(monkeypatch, module, straight, args_of, out):
    """One epoch, then --epochs 2 on the same directory: the state right
    after auto_load equals checkpoint-0.pth, the end equals ``straight``."""
    _quiet(module.main, args_of(out, "--epochs", "1"), device="cpu")
    saved = torch.load(str(out / "checkpoint-0.pth"), weights_only=False)
    assert sorted(saved) == ["epoch", "model", "model_ema", "optimizer", "step"]
    assert saved["step"] == 2
    loaded = _recording_auto_load(monkeypatch, module)
    resumed, printed = _quiet(module.main, args_of(out, "--epochs", "2"), device="cpu")
    assert "auto-resumed from epoch 1" in printed
    epoch, at_load = loaded[0]
    assert epoch == 1
    _equal(at_load, {"model": saved["model"], "teacher": saved["model_ema"],
                     "optimizer": saved["optimizer"], "step": saved["step"]})
    _equal(_snapshot(resumed), _snapshot(straight))
    return saved


# ---------------------------------------------------------------------------
# the JAX steps' metric names (traced, not run)
# ---------------------------------------------------------------------------

def _jax_names(kind):
    cfg = JConfig(img_size=32, patch_size=16, embed_dim=16, depth=2, num_heads=2,
                  head_type="none", use_flash_attention=False)
    vae = JDiscreteVAE(image_size=8, num_tokens=64, codebook_dim=8, num_layers=2, hidden_dim=8)
    images, views, mask = jnp.zeros((2, 32, 32, 3)), jnp.zeros((2, 8, 8, 3)), jnp.zeros((2, 4))
    vvars = vae.init(jax.random.PRNGKey(0), views)  # the steps close over concrete values
    lr = JS.constant_schedule(1e-3)
    if kind == "dvae":
        args = JTD.get_args_parser().parse_args(["--vocab_size", "64"])
        params = jax.eval_shape(lambda: vvars["params"])
        tx = JO.make_optimizer(params, lr)
        step = JTD.make_dvae_train_step(vae, tx, args)
        out = jax.eval_shape(step, {"params": params}, jax.eval_shape(tx.init, params),
                             jnp.zeros([], jnp.int32), views, jax.random.PRNGKey(0))
        return set(out[-1])
    model = (JMIM if kind == "mim" else JJoint)(cfg=cfg, vocab_size=64)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), images, mask)["params"]
    tx = JO.make_optimizer(params, lr)
    opt_state = jax.eval_shape(tx.init, params)
    if kind == "mim":
        state = JE.MIMState(params=params, opt_state=opt_state, step=jnp.zeros([], jnp.int32))
        step = JE.make_mim_train_step(model, vae, vvars, tx, lr)
        _, metrics = jax.eval_shape(step, state, images, views, mask, jax.random.PRNGKey(0))
    else:
        state = JEC.CyclicalState(params=params, opt_state=opt_state, ema_params=params,
                                  step=jnp.zeros([], jnp.int32))
        step = JE.make_joint_train_step(model, vae, vvars, tx,
                                        JE.JointHParams(target_layers=(0, 1)), lr)
        _, metrics = jax.eval_shape(step, state, images, views, mask, jnp.float32(0),
                                    jax.random.PRNGKey(0))
    return set(metrics)


# ---------------------------------------------------------------------------
# the dVAE trainer
# ---------------------------------------------------------------------------

def test_train_dvae_resumes_logs_and_exports_weights(root, tmp_path, monkeypatch, dvae_weights):
    """The dVAE trainer: the resumed run equals the straight one bit for
    bit; log.txt has one record an epoch under "train_" and the JAX step's
    metric names, the used fraction and perplexity in range, the temperature
    the schedule's; checkpoint-dvae-weights.pth is the final weights alone."""
    path, straight, out = dvae_weights
    names = _jax_names("dvae")
    assert names == {"loss", "recon_loss", "kl", "perplexity", "codebook_used_frac",
                     "temperature"}
    log = _log(out)
    assert [sorted(r) for r in log] == [sorted({"epoch"} | {f"train_{k}" for k in names})] * 2
    for r in log:
        assert np.isfinite(r["train_loss"]) and 0 < r["train_codebook_used_frac"] <= 1
        assert 1 <= r["train_perplexity"] <= 64
    temps = [TD.temperature_schedule(s, 1.0, 0.0625, 3) for s in range(4)]
    assert log[0]["train_temperature"] == pytest.approx((temps[0] + temps[1]) / 2, rel=1e-6)
    assert temps[3] == pytest.approx(0.0625) and temps[1] < 1.0
    weights = torch.load(path, weights_only=False)
    assert sorted(weights) == ["model"]
    assert all(torch.equal(v, straight.model.state_dict()[k]) for k, v in weights["model"].items())
    _resumed_equals_straight(monkeypatch, TD, straight,
                             lambda o, *e: _dvae_args(root, o, *e), tmp_path / "resumed")


def test_dvae_train_step_runs_in_f32(root, tmp_path):
    """The dVAE trainer's step runs its forward and its backward in float32
    (TF32 off in cuDNN and cuBLAS) with TF32 on in the process, and leaves
    the process's flags on."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32)
    args = _dvae_args(root, tmp_path)
    model = TD.build_model(args, "cpu")
    optimizer = TD.make_optimizer(model, weight_decay=0.0, clip_grad=None)
    step = TD.make_dvae_train_step(model, optimizer, args, lambda s: 1e-3)
    seen = []

    def flags():
        return cudnn.allow_tf32, matmul.allow_tf32

    def record(module, inputs, out):
        seen.append(("forward", flags()))
        out.register_hook(lambda grad: seen.append(("backward", flags())))

    for conv in (model.encoder[0], model.decoder[-1]):
        conv.register_forward_hook(record)
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        images = torch.rand(BATCH, 8, 8, 3, generator=torch.Generator().manual_seed(0))
        m = step(TD.FinetuneState(model=model, optimizer=optimizer), images,
                 torch.Generator().manual_seed(1))
        assert flags() == (True, True) and np.isfinite(float(m["loss"]))
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev
    assert seen == [("forward", (False, False))] * 2 + [("backward", (False, False))] * 2


def test_temperature_schedule_and_augment_match_jax():
    """The cosine temperature against JAX's in f32; the augmentation (flip,
    then the crop over (0.3, 1)) against JAX's on the JAX key's draws, with
    and without map_pixels."""
    from tests.test_torch_port_train_augment import RESAMPLE_ATOL, jax_rrc_draws

    for step in (0, 1, 7, 50, 99, 100, 150):
        want = float(JTD.temperature_schedule(jnp.int32(step), 1.0, 0.0625, 100))
        assert TD.temperature_schedule(step, 1.0, 0.0625, 100) == pytest.approx(want, rel=1e-6)
    u8 = np.random.RandomState(2).randint(0, 256, (5, 40, 40, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(4)
    kf, kc = jax.random.split(key)
    draws = TD.DVAEAugmentDraws(torch.from_numpy(np.array(jax.random.uniform(kf, (5,)))),
                                jax_rrc_draws(kc, 5))
    jax_augment = jax.jit(JTD.augment_batch, static_argnums=(2, 3))
    for mp in (False, True):
        want = np.asarray(jax_augment(key, jnp.asarray(u8), 16, mp))
        got = TD.augment_batch(draws, torch.from_numpy(u8), 16, mp)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESAMPLE_ATOL)


# ---------------------------------------------------------------------------
# the MIM driver
# ---------------------------------------------------------------------------

def test_pretrain_beit_resumes_logs_and_takes_the_trained_tokenizer(root, tmp_path, monkeypatch,
                                                                   dvae_weights):
    """The MIM driver with the dVAE trainer's weights: its tokenizer holds
    them, strictly; the resumed run equals the straight one bit for bit;
    log.txt's keys are the JAX driver's (no prefix); the masks each step
    gets are the host op's; the softmax is exact for the run even where
    another driver set the bounded one."""
    path = dvae_weights[0]
    built, got = [], []
    build = PB.B.build_discrete_vae
    monkeypatch.setattr(PB.B, "build_discrete_vae",
                        lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    make = PB.make_mim_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def recorded(state, images, masks, *rest):
            got.append((state.step, masks.clone(), TFA.BOUNDED_SCORES))
            return step(state, images, masks, *rest)

        return recorded

    monkeypatch.setattr(PB, "make_mim_train_step", recording)

    def args_of(out, *extra):
        return _pre_args(PB.get_args_parser(), root, out, "--discrete_vae_weight_path", path,
                         *extra)

    TFA.BOUNDED_SCORES = True
    straight, printed = _quiet(PB.main, args_of(tmp_path / "straight", "--epochs", "2"),
                               device="cpu")
    assert straight.step == 4 and printed.rstrip().endswith("done.")
    vae = built[0]
    assert isinstance(vae, DiscreteVAE) and not any(p.requires_grad for p in vae.parameters())
    ref = torch.load(path, weights_only=False)["model"]
    assert all(torch.equal(v, ref[k]) for k, v in vae.state_dict().items())
    assert [s for s, _, _ in got] == [0, 1, 2, 3] and not any(b for _, _, b in got)
    for step, masks, _ in got:
        want = TM.make_blockwise_masks(mask_generator(0, step), BATCH, (2, 2), 2, 1)
        np.testing.assert_array_equal(masks.numpy(), want)
    names = _jax_names("mim")
    assert names == {"loss", "mlm_acc", "grad_norm", "lr"}
    log = _log(tmp_path / "straight")
    assert [sorted(r) for r in log] == [sorted({"epoch"} | names)] * 2
    assert all(np.isfinite(r["loss"]) and 0 <= r["mlm_acc"] <= 1 for r in log)
    saved = _resumed_equals_straight(monkeypatch, PB, straight, args_of, tmp_path / "resumed")
    assert saved["model_ema"] is None
    assert _log(tmp_path / "resumed") == log


def test_pretrain_beit_reads_dall_e_pickles(root, tmp_path, monkeypatch):
    """--discrete_vae_type dall-e: the driver's tokenizer is the DALL-E
    network filled from encoder.pkl / decoder.pkl (here written by
    save_dalle_pickles at n_hid 16: build_discrete_vae's DalleVAE is made
    small); a pickle that leaves a parameter uncovered raises."""
    def small(*a, **k):
        return DalleVAE(*a, n_hid=16, n_init=8, **k)

    monkeypatch.setattr(TDV, "DalleVAE", small)
    src = small(16, 64, device="cpu", generator=torch.Generator().manual_seed(3))
    save_dalle_pickles(src, str(tmp_path))
    built = []
    build = PB.B.build_discrete_vae
    monkeypatch.setattr(PB.B, "build_discrete_vae",
                        lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    args = _pre_args(PB.get_args_parser(), root, tmp_path / "out", "--epochs", "1",
                     "--discrete_vae_type", "dall-e", "--second_input_size", "16",
                     "--discrete_vae_weight_path", str(tmp_path), "--no_save_ckpt")
    state, _ = _quiet(PB.main, args, device="cpu")
    assert state.step == 2
    assert all(torch.equal(v, src.state_dict()[k]) for k, v in built[0].state_dict().items())
    sd = C.load_dalle_pickle_state_dict(str(tmp_path / "encoder.pkl"))
    sd.pop("blocks.output.conv.w")
    torch.save(sd, str(tmp_path / "partial.pt"))
    monkeypatch.setattr(C, "load_dalle_pickle_state_dict",
                        lambda p: torch.load(str(tmp_path / "partial.pt")) if "encoder" in p
                        else src.decoder.state_dict())
    with pytest.raises(RuntimeError, match="blocks.output.conv.w"):
        PB.B.build_discrete_vae(args, None, "cpu")


@pytest.mark.parametrize("module,extra,error,match", [
    (PB, ["--resume", "x.pth"], ValueError, "--auto_resume"),
    (PB, ["--finetune", "x.pth"], ValueError, "--auto_resume"),
    (PJ, ["--mask_dropout_prob", "0.2"], ValueError, "mask dropout"),
    (PB, ["--stochastic"], ValueError, "not read by this driver"),
    (PJ, ["--stochastic"], ValueError, "not read by this driver"),
    (PB, ["--discrete_vae_weight_path", "dvae_dir"], None, None),
], ids=["beit_resume", "beit_finetune",
        "joint_mask_dropout", "beit_stochastic", "joint_stochastic", "beit_orbax_dir"])
def test_unported_and_unknown_flags_raise(root, tmp_path, module, extra, error, match,
                                          monkeypatch):
    """Each flag the port refuses raises with its words. An orbax
    directory of the JAX dVAE trainer (``checkpoint-dvae-weights``), which
    raised here before ROADMAP.md item 23, is read: the BEiT driver runs
    its epoch with a tokenizer whose codes are the JAX DiscreteVAE's."""
    if error is None:
        vae = JDiscreteVAE(image_size=8, num_tokens=64, num_layers=2, hidden_dim=8)
        variables = jax.jit(vae.init)(jax.random.PRNGKey(9), jnp.zeros((2, 8, 8, 3)))
        path = JC.save_checkpoint(str(tmp_path / extra[1]), "dvae-weights", variables)
        built = []
        build = PB.B.build_discrete_vae
        monkeypatch.setattr(PB.B, "build_discrete_vae",
                            lambda *a, **k: built.append(build(*a, **k)) or built[-1])
        state, _ = _quiet(module.main, _pre_args(module.get_args_parser(), root, tmp_path,
                                                 "--epochs", "1", "--no_save_ckpt",
                                                 extra[0], path), device="cpu")
        assert state.step == 2
        images = np.random.RandomState(2).rand(4, 8, 8, 3).astype(np.float32)
        want = vae.apply(variables, images, method=JDiscreteVAE.get_codebook_indices)
        got = built[0].get_codebook_indices(torch.from_numpy(images))
        assert np.array_equal(got.numpy(), np.asarray(want))
        return
    with pytest.raises(error, match=match):
        _quiet(module.main, _pre_args(module.get_args_parser(), root, tmp_path, "--epochs", "1",
                                      *extra), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the CPU-only host's behaviour")
@pytest.mark.parametrize("which", ["beit", "joint", "dvae"])
def test_drivers_raise_without_a_card_unless_the_cpu_is_asked(root, tmp_path, which):
    if which == "dvae":
        fn, args = TD.main, _dvae_args(root, tmp_path, "--epochs", "1")
    else:
        module = PB if which == "beit" else PJ
        fn, args = module.main, _pre_args(module.get_args_parser(), root, tmp_path, "--epochs",
                                          "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        _quiet(fn, args)


# ---------------------------------------------------------------------------
# the joint driver
# ---------------------------------------------------------------------------

def test_pretrain_joint_resumes_logs_and_anneals(root, tmp_path, monkeypatch, dvae_weights):
    """The joint driver: the resumed run (with --seed_model set: the seed
    goes in before the resume, so the resumed run takes the checkpoint's
    weights) equals the straight one bit for bit, teacher included;
    log.txt's keys are the JAX driver's; beit_weight 1 in epoch 0 and 1/2
    in epoch 1 of a 2-epoch annealing; --seed_model seeds student and
    teacher."""
    path = dvae_weights[0]

    def args_of(out, *extra):
        return _pre_args(PJ.get_args_parser(), root, out, "--discrete_vae_weight_path", path,
                         "--target_layers", "[0,1]", "--vae_loss_weight", "2",
                         "--ema_decay", "0.99", "--ema_decay_init", "0.9", "--ema_start_at", "3",
                         *extra)

    straight, _ = _quiet(PJ.main, args_of(tmp_path / "straight", "--epochs", "2"), device="cpu")
    names = _jax_names("joint")
    assert names == {"loss", "loss_cyc", "loss_beit", "mlm_acc", "beit_weight", "grad_norm",
                     "lr"}
    log = _log(tmp_path / "straight")
    assert [sorted(r) for r in log] == [sorted({"epoch"} | names)] * 2
    assert [r["beit_weight"] for r in log] == [1.0, 0.5]
    assert log[0]["loss"] == pytest.approx(log[0]["loss_beit"], rel=1e-6)

    seed = tmp_path / "seed.pth"
    src = PJ.build_model(args_of(tmp_path, "--seed", "9"), "cpu")[0].state_dict()
    torch.save({"model": src}, str(seed))
    seeded, printed = _quiet(PJ.main, args_of(tmp_path / "seeded", "--epochs", "0",
                                              "--seed_model", str(seed)), device="cpu")
    assert "seeded from" in printed and "0 missing, 0 unused" in printed
    for k, v in seeded.model.state_dict().items():
        assert torch.equal(v, src[k]), k
    for k, v in seeded.model_ema.items():
        assert torch.equal(v, src[k]) and v.data_ptr() != seeded.model.state_dict()[k].data_ptr()

    out = tmp_path / "resumed"
    _quiet(PJ.main, args_of(out, "--epochs", "1"), device="cpu")
    saved = torch.load(str(out / "checkpoint-0.pth"), weights_only=False)
    assert saved["model_ema"].keys() == dict(straight.model.named_parameters()).keys()
    loaded = _recording_auto_load(monkeypatch, PJ)
    resumed, printed = _quiet(PJ.main, args_of(out, "--epochs", "2", "--seed_model", str(seed)),
                              device="cpu")
    assert "seeded from" in printed and "auto-resumed from epoch 1" in printed
    _equal(loaded[0][1], {"model": saved["model"], "teacher": saved["model_ema"],
                          "optimizer": saved["optimizer"], "step": saved["step"]})
    _equal(_snapshot(resumed), _snapshot(straight))
    assert _log(out) == log


# ---------------------------------------------------------------------------
# the pretrain → finetune hand-off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mim", "joint"])
def test_handoff_to_finetune_matches_jax(root, tmp_path, capsys, dvae_weights, kind):
    """A MIM or joint checkpoint-0.pth through cli.finetune --finetune: the
    missing and unused keys JAX's import gives on the same state dict (the
    head and fc_norm missing; lm_head, beit_head, norm and mask_token
    unused), the same printed line as the JAX driver's, the same weights,
    and the finetune's first logits as the JAX finetune model's."""
    module = PB if kind == "mim" else PJ
    extra = () if kind == "mim" else ("--target_layers", "[0,1]")
    _quiet(module.main, _pre_args(module.get_args_parser(), root, tmp_path / "pre", "--epochs",
                                  "1", "--discrete_vae_weight_path", dvae_weights[0], *extra),
           device="cpu")
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
    assert capsys.readouterr().out.strip().splitlines()[-1] == jline

    _, jmiss, junused = JC.import_torch_params(JC.load_torch_state_dict(pth), variables["params"])
    _, tmiss, tunused = C.import_torch_state_dict(C.load_torch_state_dict(pth), model.state_dict())
    jkeys = sorted(C._torch_key_for(tuple(p.split("/")))[0] for p in jmiss)
    assert sorted(missing) == sorted(tmiss) == jkeys == sorted(
        C._torch_key_for(tuple(p.split("/")))[0] for p in jmissing)
    assert jkeys == ["fc_norm.bias", "fc_norm.weight", "head.bias", "head.weight"]
    heads = (["lm_head.bias", "lm_head.weight"] if kind == "mim" else
             ["beit_head.bias", "beit_head.weight", "lm_head.0.bias", "lm_head.0.weight",
              "lm_head.2.bias", "lm_head.2.weight"])
    assert sorted(tunused) == sorted(junused) == sorted(
        heads + ["mask_token", "norm.bias", "norm.weight"])

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
