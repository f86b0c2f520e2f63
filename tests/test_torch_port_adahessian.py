"""PyTorch port: the AdaHessian step (``use_hessian``) through the engines,
against the JAX package's ``use_hessian=True`` steps.

The Rademacher z is injected on both sides (``jax.random.rademacher`` by a
test-side monkeypatch, the port's ``optim.draw_rademacher``) from one seeded
numpy tree. The port's models take the attention kernels' route (the
Function over the plain versions on the CPU) in the step's own gradient and
the plain route in the Hessian pass (``plain_only()``); the JAX models run
their plain attention in both (an interpret-mode Pallas step compiles for
minutes; under ``forward_ad_safe()`` its pass is plain anyway). Loss and grad norm at rtol 1e-5; the
parameters after the step at rtol 1e-3 / atol 1e-4 (the train-step tests'
tolerance), widened where the first update, g/(|D| + eps), carries D's
own tolerance into it (a small D, the difference of products of larger
size, has a relative error of several percent in either package).
``optim.hutchinson_hessian_diag`` itself is held against JAX's in
tests/test_torch_port_optim_chain.py.

The port's pass replays the step's draws: the drop-path and dropout masks
(recorded), the buffers a train forward updates (the SNGP precision
matrix), the other generators' states; the kernel Functions are entered in
the step's own gradient and never inside the pass.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as JFA
from uncertainty_vit_tpu.core.config import ViTConfig as JConfig
from uncertainty_vit_tpu.models.cyclical import CyclicalViT as JCyclical
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.train import engine_cyclical as JEC
from uncertainty_vit_tpu.train import engine_finetune as JE
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.models.cyclical import CyclicalViT
from uncertainty_vit_tpu_torch.models.dist_vit import DistVisionTransformer
from uncertainty_vit_tpu_torch.models.mim import JointViT, MIMViT
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.ops import quant as TQ
from uncertainty_vit_tpu_torch.train import engine_cyclical as TEC
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import engine_finetune_dist as TED
from uncertainty_vit_tpu_torch.train import engine_mim as TEM
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils import checkpoint as C
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

SMALL = dict(img_size=16, patch_size=8, embed_dim=128, depth=2, num_heads=2, init_values=0.1,
             use_shared_rel_pos_bias=True, use_abs_pos_emb=False)
STEP = dict(rtol=1e-3, atol=1e-4)
LR = 1e-4


@pytest.fixture(autouse=True)
def interpret_exact():
    prev = (JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = True, False, False
    yield
    JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


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


def _inject_z(monkeypatch, params, model):
    """One seeded Rademacher tree for both packages; returns the port's z."""
    rs = np.random.RandomState(9)
    z_tree = jax.tree_util.tree_map(
        lambda p: rs.choice([-1.0, 1.0], size=np.shape(p)).astype(np.float32), params)
    state = {"leaves": None}

    def rademacher(key, shape, dtype):
        if state["leaves"] is None:
            state["leaves"] = iter(jax.tree_util.tree_leaves(z_tree))
        return jnp.asarray(next(state["leaves"]), dtype)

    monkeypatch.setattr(jax.random, "rademacher", rademacher)
    z = C.flax_to_state_dict(z_tree)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    monkeypatch.setattr(TO, "draw_rademacher", lambda ps, gen: [z[n] for n in names])


def _recording_hessian(monkeypatch):
    """Wraps the port's estimate: keeps each D and counts the kernel
    Functions entered inside the pass."""
    seen = {"d": [], "inside": 0, "calls": 0}
    orig_est = TO.hutchinson_hessian_diag
    orig_attn, orig_int8 = TFA._FusedQKVAttention.apply, TQ._Int8Dense.apply

    def counted(fn):
        def call(*a):
            seen["calls"] += 1
            if TFA.in_plain_only():
                seen["inside"] += 1
            return fn(*a)
        return staticmethod(call)

    def est(loss_fn, params, generator):
        d = orig_est(loss_fn, params, generator)
        seen["d"].append(d)
        return d

    monkeypatch.setattr(TFA._FusedQKVAttention, "apply", counted(orig_attn))
    monkeypatch.setattr(TQ._Int8Dense, "apply", counted(orig_int8))
    monkeypatch.setattr(TO, "hutchinson_hessian_diag", est)
    return seen


def _recording_jax_step(monkeypatch, engine):
    """Wraps (test-side) the JAX package's estimate and the ``engine``
    module's ``hessian_aware_update`` to copy each D and each gradient out
    of the jitted step; read after ``jax.effects_barrier()``."""
    seen = {"d": [], "g": []}
    orig_est, orig_update = JO.hutchinson_hessian_diag, engine.hessian_aware_update

    def keep(key, tree):
        jax.debug.callback(lambda t: seen[key].append(C.flax_to_state_dict(_np(t))), tree)

    def est(grad_fn, params, rng):
        d = orig_est(grad_fn, params, rng)
        keep("d", d)
        return d

    def update(tx, grads, opt_state, params, **kw):
        keep("g", grads)
        return orig_update(tx, grads, opt_state, params, **kw)

    monkeypatch.setattr(JO, "hutchinson_hessian_diag", est)
    monkeypatch.setattr(engine, "hessian_aware_update", update)
    return seen


def _hold_step(model, names, d, jax_seen, before, after):
    """The port's step against the JAX engine's: the gradient at the
    backward tolerance and the engine's D (the replayed pass) at the
    estimate's own (both rtol 1e-3 / atol 1e-4; D's is its hold in
    tests/test_torch_port_optim_chain.py); then the first AdaHessian
    update, Δ = −lr·(c·g/(|D| + eps) + wd·p)·scale (c ≤ 1 the clip, scale
    ≤ 1 the layer decay), at rtol 1e-3 of JAX's Δ, widened by what the two
    tolerances carry into it, lr·δg/|D| + lr·|g|·δD/D², and by four f32
    roundings of the parameters. Parameters left as they were (no update)
    must fall outside that bound in most entries. Returns the bound by
    name."""
    assert len(jax_seen["d"]) == len(jax_seen["g"]) == 1
    before, after = C.flax_to_state_dict(before), C.flax_to_state_dict(_np(after))
    bounds, unchanged, total = {}, 0, 0
    for k, dk in zip(names, d):
        g = model.get_parameter(k).grad
        np.testing.assert_allclose(g.numpy(), jax_seen["g"][0][k].numpy(), err_msg=k, **STEP)
        np.testing.assert_allclose(dk.numpy(), jax_seen["d"][0][k].numpy(), err_msg=k, **STEP)
        ad = dk.abs().clamp_min(1e-30)
        carried = (LR * (STEP["atol"] + STEP["rtol"] * g.abs()) / ad
                   + LR * g.abs() * (STEP["atol"] + STEP["rtol"] * ad) / ad.square())
        ref = after[k] - before[k]
        bound = (STEP["rtol"] * ref.abs() + carried
                 + 4 * 2.0 ** -23 * (before[k].abs() + after[k].abs()))
        err = (model.state_dict()[k] - before[k] - ref).abs()
        assert bool((err <= bound).all()), (k, float((err - bound).max()))
        unchanged += int((ref.abs() > bound).sum())
        total += dk.numel()
        bounds[k] = bound
    assert unchanged > 0.5 * total, (unchanged, total)
    return bounds


def test_finetune_step_matches_jax_engine(monkeypatch):
    """One AdaHessian step of a 2-deep width-128 model (mixup off, label
    smoothing 0.1, clip 3.0, weight decay 0.05, layer decay 0.75) against
    the JAX engine's: loss, grad norm and the parameters; the attention
    Function is entered twice (the step's two blocks), never in the pass."""
    cfg = JConfig(**SMALL, num_classes=10, use_flash_attention=False)
    rs = np.random.RandomState(0)
    images = rs.randn(4, 16, 16, 3).astype(np.float32)
    labels = np.array([1, 3, 5, 7])
    jmodel = JViT(cfg=cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    params = _numpy_params(shapes, 1)
    model = C.load_flax_params(VisionTransformer(ViTConfig(**SMALL, num_classes=10),
                                                 device="cpu"), params)
    _inject_z(monkeypatch, params, model)
    seen = _recording_hessian(monkeypatch)
    jax_seen = _recording_jax_step(monkeypatch, JE)
    kw = dict(weight_decay=0.05, clip_grad=3.0, layer_decay=0.75, depth=2,
              opt_name="adahessian")
    hp = dict(num_classes=10, mixup_active=False, label_smoothing=0.1)
    lr = JS.constant_schedule(LR)
    tx = JO.make_optimizer(params, lr, **kw)
    jstate = JE.FinetuneState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros([], jnp.int32))
    jstep = JE.make_finetune_train_step(jmodel, tx, JE.FinetuneHParams(**hp), lr,
                                        use_hessian=True)
    jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), jax.random.PRNGKey(0))
    jax.effects_barrier()

    opt = TO.make_optimizer(model, **kw)
    state = TE.init_finetune_state(model, opt)
    step = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**hp),
                                       TS.constant_schedule(LR), use_hessian=True)
    gens = TE.step_generators(0, 0, "cpu", hessian=True)
    m = step(state, torch.from_numpy(images), torch.from_numpy(labels), gens.model,
             hessian_generator=gens.hessian)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert seen["calls"] == 2 and seen["inside"] == 0 and len(seen["d"]) == 1
    names = [n for n, _ in model.named_parameters()]
    _hold_step(model, names, seen["d"][0], jax_seen, params, jstate.params)
    with pytest.raises(ValueError, match="hessian_generator"):
        step(state, torch.from_numpy(images), torch.from_numpy(labels), gens.model)


def test_finetune_warmup_updates_match_jax_engine(monkeypatch):
    """The smoke's AdaHessian recipe on the CPU in both engines (ROADMAP's
    question of the loss rise in ``chip_smoke.py`` phase 23c): weights
    seeded as the smoke seeds its .pth (the port's init, the rel-pos table
    at std 0.2, the head at 0.5; carried into the JAX tree by its importer),
    the lr warming up over 30 steps to 4e-3 (base·k/29 at step k), four
    steps (three updates) on one batch with one injected z. The losses and
    grad norms of both engines agree at rtol 1e-4 at every step (each
    update carries D's own tolerance, rtol 1e-3 in a small D, through
    lr·g/|D|: measured 2.8e-5 after two updates), and the loss does not rise
    in either (measured, port / JAX: 12.93606 → 12.91943 / 12.91907 →
    12.89811 / 12.89779; at ViT-B's width and depth, N = 5, another z,
    20.71663 → 20.69807 / 20.69680 → 20.67876 / 20.67820, f32 on the CPU):
    the port's step is not the rise's cause."""
    import itertools

    from uncertainty_vit_tpu.utils.checkpoint import import_torch_params
    from uncertainty_vit_tpu_torch.core.init import trunc_normal

    cfg = JConfig(**SMALL, num_classes=10, use_flash_attention=False)
    rs = np.random.RandomState(0)
    images = rs.randn(4, 16, 16, 3).astype(np.float32)
    labels = np.array([1, 3, 5, 7])
    jmodel = JViT(cfg=cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    gen = torch.Generator().manual_seed(130)
    model = VisionTransformer(ViTConfig(**SMALL, num_classes=10), device="cpu", generator=gen)
    with torch.no_grad():
        trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
        trunc_normal(0.5, 2.0)(model.head.weight, gen)
    params, missing, unused = import_torch_params(
        {k: v.numpy() for k, v in model.state_dict().items()},
        jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), shapes))
    assert missing == [] and unused == []
    z_tree = jax.tree_util.tree_map(
        lambda p: np.random.RandomState(9).choice([-1.0, 1.0], size=np.shape(p))
        .astype(np.float32), params)
    leaves = itertools.cycle(jax.tree_util.tree_leaves(z_tree))
    monkeypatch.setattr(jax.random, "rademacher",
                        lambda key, shape, dtype: jnp.asarray(next(leaves), dtype))
    z = C.flax_to_state_dict(z_tree)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    monkeypatch.setattr(TO, "draw_rademacher", lambda ps, gen: [z[n] for n in names])
    kw = dict(weight_decay=0.05, clip_grad=3.0, layer_decay=0.75, depth=2,
              opt_name="adahessian")
    hp = dict(num_classes=10, mixup_active=False, label_smoothing=0.1)
    jlr = JS.cosine_schedule(4e-3, 1e-6, 3, warmup_steps=30)
    tx = JO.make_optimizer(params, jlr, **kw)
    jstate = JE.FinetuneState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros([], jnp.int32))
    jstep = JE.make_finetune_train_step(jmodel, tx, JE.FinetuneHParams(**hp), jlr,
                                        use_hessian=True)
    opt = TO.make_optimizer(model, **kw)
    state = TE.init_finetune_state(model, opt)
    step = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**hp),
                                       TS.cosine_schedule(4e-3, 1e-6, 3, warmup_steps=30),
                                       use_hessian=True)
    got, want = [], []
    for i in range(4):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                           jax.random.PRNGKey(i))
        gens = TE.step_generators(0, i, "cpu", hessian=True)
        m = step(state, torch.from_numpy(images), torch.from_numpy(labels), gens.model,
                 hessian_generator=gens.hessian)
        want.append((float(jm["loss"]), float(jm["grad_norm"])))
        got.append((float(m["loss"]), float(m["grad_norm"])))
        assert float(m["lr"]) == pytest.approx(4e-3 * i / 29, rel=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for losses in (got, want):
        assert all(b[0] <= a[0] for a, b in zip(losses, losses[1:])), losses


def test_cyclical_step_matches_jax_engine(monkeypatch):
    """One AdaHessian step of the cyclical engine (targets of layers 0 and
    1, the EMA teacher after it) against JAX's: loss, grad norm, the
    parameters and the teacher."""
    cfg = JConfig(**SMALL, head_type="none", use_flash_attention=False)
    rs = np.random.RandomState(2)
    images = rs.randn(4, 16, 16, 3).astype(np.float32)
    mask = np.zeros((4, 4), np.float32)
    mask[:, :2] = 1.0
    jmodel = JCyclical(cfg=cfg)
    variables = _np(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(mask)))
    params = _numpy_params(variables["params"], 3)
    model = CyclicalViT(ViTConfig(**SMALL, head_type="none"), device="cpu")
    C.load_flax_params(model, params)
    _inject_z(monkeypatch, params, model)
    seen = _recording_hessian(monkeypatch)
    jax_seen = _recording_jax_step(monkeypatch, JEC)
    kw = dict(weight_decay=0.05, clip_grad=3.0, depth=2, opt_name="adahessian")
    lr = JS.constant_schedule(LR)
    tx = JO.make_optimizer(params, lr, **kw)
    hp = dict(target_layers=(0, 1), ema_decay=0.9, ema_decay_init=0.9)
    jstate = JEC.CyclicalState(params=params, opt_state=tx.init(params),
                               ema_params=jax.tree_util.tree_map(np.copy, params),
                               step=jnp.zeros([], jnp.int32))
    jstep = JEC.make_cyclical_train_step(jmodel, tx, JEC.CyclicalHParams(**hp), lr,
                                         donate=False, use_hessian=True)
    jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(mask), jax.random.PRNGKey(0))
    jax.effects_barrier()

    opt = TO.make_optimizer(model, **kw)
    state = TEC.init_cyclical_state(model, opt)
    step = TEC.make_cyclical_train_step(model, opt, TEC.CyclicalHParams(**hp),
                                        TS.constant_schedule(LR), use_hessian=True)
    gens = TEC.step_generators(0, 0, "cpu", hessian=True)
    m = step(state, torch.from_numpy(images), torch.from_numpy(mask), gens.model,
             hessian_generator=gens.hessian)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert seen["calls"] == 2 and seen["inside"] == 0
    names = [n for n, _ in model.named_parameters()]
    bounds = _hold_step(model, names, seen["d"][0], jax_seen, params, jstate.params)
    # the teacher, 0.9·teacher + 0.1·student, carries a tenth of the
    # student's bound and the roundings of its own sum
    ema_ref = C.flax_to_state_dict(_np(jstate.ema_params))
    for k, v in state.model_ema.items():
        bound = 0.1 * bounds[k] + 4 * 2.0 ** -23 * ema_ref[k].abs()
        assert bool(((v - ema_ref[k]).abs() <= bound).all()), (k, float(((v - ema_ref[k]).abs() - bound).max()))


@pytest.mark.parametrize("head", ["linear", "sngp", "het"])
def test_the_pass_replays_the_steps_draws(monkeypatch, head):
    """With drop-path 0.2, hidden dropout 0.1, and the SNGP or
    heteroscedastic head: the pass's loss is the step's to the bit (the
    same masks, the SNGP statistics as the step found them, the het noise
    replayed), the kernel Functions stay out of it, and the step leaves the
    buffers and generators where a step without the pass leaves them."""
    cfg = ViTConfig(**SMALL, num_classes=10, drop_rate=0.1, drop_path_rate=0.2,
                    use_flash_attention=False, head_type=head, het_num_factors=2,
                    het_train_mc_samples=4, het_test_mc_samples=4)
    images = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([1, 3, 5, 7])
    hp = TE.FinetuneHParams(num_classes=10, mixup_active=False, head_type=head)
    losses = []
    orig_est = TO.hutchinson_hessian_diag

    def est(loss_fn, params, generator):
        def recorded():
            loss = loss_fn()
            losses.append(loss.detach().clone())
            return loss
        return orig_est(recorded, params, generator)

    def run(opt_name):
        model = VisionTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        opt = TO.make_optimizer(model, opt_name=opt_name, weight_decay=0.05)
        step = TE.make_finetune_train_step(model, opt, hp, TS.constant_schedule(LR),
                                           use_hessian=TO.needs_hessian(opt_name))
        gens = TE.step_generators(3, 0, "cpu", het=head == "het", hessian=True)
        m = step(TE.init_finetune_state(model, opt), images, labels, gens.model,
                 mc_generator=gens.mc, hessian_generator=gens.hessian)
        return m, model, gens

    seen = _recording_hessian(monkeypatch)
    monkeypatch.setattr(TO, "hutchinson_hessian_diag", est)
    m, model, gens = run("adahessian")
    assert len(losses) == 1 and torch.equal(losses[0], m["loss"])
    assert seen["inside"] == 0
    m2, model2, gens2 = run("sgd")
    assert torch.equal(m["loss"], m2["loss"])
    for (k, b), b2 in zip(model.named_buffers(), model2.buffers()):
        assert torch.equal(b, b2), k
    if head == "het":
        assert torch.equal(gens.mc.get_state(), gens2.mc.get_state())


def test_mim_joint_and_dist_steps_take_the_pass(monkeypatch):
    """The MIM, joint and dist engines run the pass too (port-side: the
    estimate is made once a step, kernels stay out of it, the parameters
    move, the losses are finite)."""
    seen = _recording_hessian(monkeypatch)
    cfg = ViTConfig(**SMALL, head_type="none", drop_path_rate=0.1)
    images = torch.randn(2, 16, 16, 3)
    mask = torch.tensor([[1.0, 0, 1, 0], [0, 1, 0, 1]])
    tokens_in = torch.randn(2, 8, 8, 3)

    class Tok(torch.nn.Module):
        """A stand-in tokenizer: 16 codes for each of the 4 patches."""

        def get_codebook_indices(self, x):
            return x.reshape(2, 4, -1)[..., :16].argmax(-1)

    tokenizer = Tok()
    gens = TE.step_generators(0, 0, "cpu", hessian=True)
    mim = MIMViT(cfg, vocab_size=16, device="cpu")
    opt = TO.make_optimizer(mim, opt_name="adahessian")
    before = [p.clone() for p in opt.params]
    step = TEM.make_mim_train_step(mim, tokenizer, opt, TS.constant_schedule(LR),
                                   use_hessian=True)
    m = step(TE.FinetuneState(model=mim, optimizer=opt), (images, tokens_in), mask, gens.model,
             hessian_generator=gens.hessian)
    assert math.isfinite(float(m["loss"])) and len(seen["d"]) == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, opt.params))

    joint = JointViT(cfg, vocab_size=16, device="cpu")
    opt = TO.make_optimizer(joint, opt_name="lookahead_adahessian")
    state = TEC.init_cyclical_state(joint, opt)
    step = TEM.make_joint_train_step(joint, tokenizer, opt,
                                     TEM.JointHParams(target_layers=(0, 1)),
                                     TS.constant_schedule(LR), use_hessian=True)
    m = step(state, (images, tokens_in), mask, 0.0, gens.model, hessian_generator=gens.hessian)
    assert math.isfinite(float(m["loss"])) and len(seen["d"]) == 2

    dist = DistVisionTransformer(ViTConfig(**SMALL, num_classes=10), device="cpu")
    opt = TO.make_optimizer(dist, opt_name="adahessian")
    step = TED.make_dist_finetune_train_step(
        dist, opt, TED.DistFinetuneHParams(num_classes=10, mixup_active=False),
        TS.constant_schedule(LR), use_hessian=True)
    m = step(TE.FinetuneState(model=dist, optimizer=opt), images, images.flip(0), images * 0.5,
             torch.tensor([1, 2]), gens.model, hessian_generator=gens.hessian)
    assert math.isfinite(float(m["loss"])) and len(seen["d"]) == 3
    assert seen["inside"] == 0


# ---------------------------------------------------------------------------
# through the drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    import pickle

    root = tmp_path_factory.mktemp("adahessian_cli")
    base = root / "cifar-100-python"
    base.mkdir()
    rs = np.random.RandomState(0)
    for name, n in (("train", 32), ("test", 16)):
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (n, 3072), dtype=np.uint8),
                         b"fine_labels": (np.arange(n) % 100).tolist()}, f)
    return root


def _drive(module, root, out, *extra):
    import io
    from contextlib import redirect_stdout

    argv = ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
            "--data_path", str(root), "--batch_size", "8", "--num_workers", "0",
            "--dtype", "float32", "--output_dir", str(out), "--steps_per_epoch", "2",
            "--save_ckpt_freq", "1", *extra]
    with redirect_stdout(io.StringIO()), pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        return module.main(module.get_args_parser().parse_args(argv), device="cpu")


@pytest.mark.parametrize("opt", ["adahessian", "lookahead_adafactor"])
def test_finetune_driver_resumes_equal_to_the_straight_run(root, tmp_path, opt):
    """``cli.finetune --opt X`` (drop-path 0.1, --update_freq 2, no warm-up):
    two epochs straight, and the second epoch again, auto-resumed from the
    straight run's checkpoint-0.pth (the same --epochs, so the same
    schedules), equal to the bit; the checkpoint holds the chain's state
    under the optimizer's key."""
    import shutil

    from uncertainty_vit_tpu_torch.cli import finetune as TFT

    extra = ["--opt", opt, "--drop_path", "0.1", "--update_freq", "2", "--warmup_epochs", "0",
             "--epochs", "2"]
    straight = _drive(TFT, root, tmp_path / "s", *extra)
    (tmp_path / "r").mkdir()
    shutil.copy(tmp_path / "s" / "checkpoint-0.pth", tmp_path / "r" / "checkpoint-0.pth")
    resumed = _drive(TFT, root, tmp_path / "r", *extra)
    assert straight.step == resumed.step == 4
    for (k, v), w in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(v, w), k
    blob = torch.load(str(tmp_path / "r" / "checkpoint-0.pth"), weights_only=False)
    assert blob["optimizer"]["opt_name"] == opt and blob["optimizer"]["count"] == 1


def test_pretraining_drivers_take_adahessian(root, tmp_path):
    """``cli.pretrain_cyclical --opt adahessian`` (attention dropout 0.05,
    whose masks the pass draws from its own stream) trains an epoch."""
    from uncertainty_vit_tpu_torch.cli import pretrain_cyclical as PC

    state = _drive(PC, root, tmp_path, "--epochs", "1", "--opt", "adahessian",
                   "--target_layers", "[0,1]", "--num_mask_patches", "2",
                   "--min_mask_patches_per_block", "1", "--attn_drop_rate", "0.05",
                   "--drop_path", "0.1")
    assert state.step == 2 and state.optimizer.count == 2
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
