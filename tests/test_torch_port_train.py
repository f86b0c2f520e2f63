"""PyTorch port: the finetune train step and its parts against the JAX package.

Mixup (with the JAX package's draws injected into the port's pure mixing
function), the losses, the schedules, the layer-decay scales and decay mask,
the AdamW update and one whole train step of a small model are run on the
same numpy inputs through both packages. The port's model takes the fused
attention path: on CPU tensors its ``torch.autograd.Function`` runs K1's
plain forward and K2's plain backward (the path the kernels take on the
card). The JAX engine runs the Pallas kernels in interpret mode
(``FA.INTERPRET``), so both sides go through their kernel dispatchers.
Tolerances are stated per test; all comparisons are in f32.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import uncertainty_vit_tpu.ops.flash_attention as FA
from uncertainty_vit_tpu.core.config import ViTConfig
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.ops import losses as JL
from uncertainty_vit_tpu.ops import mixup as JM
from uncertainty_vit_tpu.train import engine_finetune as JE
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.models.layers import drop_path
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.ops.attention import naive_attention
from uncertainty_vit_tpu_torch.ops import losses as TL
from uncertainty_vit_tpu_torch.ops import mixup as TM
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.train.ema import ema_on_update_boundary, ema_update
from uncertainty_vit_tpu_torch.utils.checkpoint import (
    flax_leaves_by_torch_key, flax_to_state_dict, load_flax_params,
)

# the small model of the train-step test: depth 2, 2 heads of 64, image 32
SMALL = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2,
             num_classes=10, init_values=0.1, use_shared_rel_pos_bias=True)


@pytest.fixture(autouse=True)
def interpret_mode():
    prev = (FA.INTERPRET, FA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    FA.INTERPRET = True
    yield
    FA.INTERPRET, FA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


def _numpy_params(shapes, seed):
    """Seeded numpy values for every leaf of a JAX param-shape tree."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if "kernel" in name:
            return (rs.randn(*leaf.shape) / math.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return (0.2 * rs.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _small(seed=0, batch=4):
    cfg = ViTConfig(**SMALL)
    rs = np.random.RandomState(seed + 100)
    images = rs.randn(batch, 32, 32, 3).astype(np.float32)
    labels = rs.randint(0, cfg.num_classes, size=batch).astype(np.int32)
    jmodel = JViT(cfg=cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    params = _numpy_params(shapes, seed)
    model = load_flax_params(VisionTransformer(TViTConfig(**SMALL), device="cpu"), params)
    return jmodel, params, model, images, labels


# ---------------------------------------------------------------------------
# mixup
# ---------------------------------------------------------------------------

def _jax_batch_draws(rng, h, w, mixup_alpha, cutmix_alpha, prob, switch_prob):
    """The draws ``mixup_cutmix(mode="batch")`` makes from ``rng``
    (JAX ops/mixup.py:179-202), as the port's MixupDraws."""
    r_apply, r_switch, r_lam, r_box = jax.random.split(rng, 4)
    use_cutmix = bool(jax.random.bernoulli(r_switch, switch_prob))
    lam_mix = float(JM._beta(r_lam, mixup_alpha))
    lam_cut = float(JM._beta(jax.random.fold_in(r_lam, 2), cutmix_alpha))
    ry, rx = jax.random.split(r_box)
    cy = int(jax.random.randint(ry, (), 0, h))
    cx = int(jax.random.randint(rx, (), 0, w))
    apply = bool(jax.random.bernoulli(r_apply, prob))
    return TM.MixupDraws(apply, use_cutmix, lam_mix, lam_cut, cy, cx)


@pytest.mark.parametrize("seed", range(8))
def test_batch_mixup_with_jax_draws_matches_jax(seed):
    """Bit-for-bit: the same draws give the same images and targets. Seeds
    0-7 at prob 0.7 cover mixup, cutmix and the unapplied batch."""
    rs = np.random.RandomState(seed)
    images = rs.randn(6, 24, 20, 3).astype(np.float32)
    labels = rs.randint(0, 10, size=6).astype(np.int32)
    args = dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=0.7, switch_prob=0.5)
    rng = jax.random.PRNGKey(seed)
    ref_images, ref_targets = JM.mixup_cutmix(
        rng, jnp.asarray(images), jnp.asarray(labels), 10, label_smoothing=0.1, **args)
    draws = _jax_batch_draws(rng, 24, 20, **args)
    out_images, out_targets = TM.mix_batch(
        torch.from_numpy(images), torch.from_numpy(labels).long(), 10, 0.1, draws)
    np.testing.assert_array_equal(out_images.numpy(), np.asarray(ref_images))
    np.testing.assert_allclose(out_targets.numpy(), np.asarray(ref_targets), rtol=0, atol=1e-7)


def test_mixup_seeds_cover_every_branch():
    kinds = set()
    for seed in range(8):
        d = _jax_batch_draws(jax.random.PRNGKey(seed), 24, 20, 0.8, 1.0, 0.7, 0.5)
        kinds.add("off" if not d.apply else "cutmix" if d.use_cutmix else "mixup")
    assert kinds == {"off", "cutmix", "mixup"}


def test_mixup_draws_are_seeded_and_follow_their_distributions():
    a = TM.draw_mixup_batch(torch.Generator().manual_seed(3), 224, 224)
    b = TM.draw_mixup_batch(torch.Generator().manual_seed(3), 224, 224)
    assert a == b
    gen = torch.Generator().manual_seed(0)
    draws = [TM.draw_mixup_batch(gen, 224, 224, prob=0.8) for _ in range(2000)]
    lam_mix = np.array([d.lam_mix for d in draws])
    lam_cut = np.array([d.lam_cut for d in draws])
    # Beta(0.8, 0.8): mean 1/2, variance 1/(4·2.6); Beta(1, 1): uniform
    assert abs(lam_mix.mean() - 0.5) < 0.03
    assert abs(lam_mix.var() - 1 / (4 * 2.6)) < 0.01
    assert abs(lam_cut.mean() - 0.5) < 0.03 and abs(lam_cut.var() - 1 / 12) < 0.01
    assert abs(np.mean([d.use_cutmix for d in draws]) - 0.5) < 0.05
    assert abs(np.mean([d.apply for d in draws]) - 0.8) < 0.04
    cy = np.array([d.cy for d in draws])
    assert cy.min() >= 0 and cy.max() < 224 and abs(cy.mean() - 111.5) < 6


def test_one_hot_smooth_matches_jax():
    labels = np.array([0, 3, 9, 3], np.int32)
    ref = JM.one_hot_smooth(jnp.asarray(labels), 10, 0.1)
    out = TM.one_hot_smooth(torch.from_numpy(labels).long(), 10, 0.1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_unported_mixup_modes_raise():
    x, y = torch.zeros(2, 8, 8, 3), torch.zeros(2, dtype=torch.long)
    gen = torch.Generator()
    for kw in (dict(mode="elem"), dict(mode="pair"), dict(cutmix_minmax=(0.2, 0.8))):
        with pytest.raises(NotImplementedError):
            TM.mixup_cutmix(gen, x, y, 10, **kw)


# ---------------------------------------------------------------------------
# losses and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss", ["soft_target", "label_smoothing", "cross_entropy"])
def test_losses_match_jax(loss):
    rs = np.random.RandomState(0)
    logits = (rs.randn(8, 10) * 3).astype(np.float32)
    labels = rs.randint(0, 10, size=8).astype(np.int32)
    targets = rs.dirichlet(np.ones(10), size=8).astype(np.float32)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    if loss == "soft_target":
        ref = JL.soft_target_cross_entropy(jl, jnp.asarray(targets))
        out = TL.soft_target_cross_entropy(tl, torch.from_numpy(targets))
    elif loss == "label_smoothing":
        ref = JL.label_smoothing_cross_entropy(jl, jnp.asarray(labels), 0.1)
        out = TL.label_smoothing_cross_entropy(tl, torch.from_numpy(labels).long(), 0.1)
    else:
        ref = JL.cross_entropy(jl, jnp.asarray(labels))
        out = TL.cross_entropy(tl, torch.from_numpy(labels).long())
    assert out.dtype == torch.float32 and out.dim() == 0
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)


@pytest.mark.parametrize("warmup", [0, 1, 500])
def test_cosine_schedule_matches_jax(warmup):
    ref = JS.cosine_schedule(4e-3, 1e-6, 10_000, warmup_steps=warmup, start_warmup_value=1e-6)
    out = TS.cosine_schedule(4e-3, 1e-6, 10_000, warmup_steps=warmup, start_warmup_value=1e-6)
    for step in (0, 1, 2, 250, 499, 500, 501, 5000, 9999, 10_000):
        # JAX evaluates in f32, the port in f64: f32 rounding of terms the
        # size of the base value (1 + cos cancels near the end)
        np.testing.assert_allclose(out(step), float(ref(step)), rtol=2e-6, atol=1e-6 * 4e-3)
    assert TS.constant_schedule(0.05)(7) == pytest.approx(float(JS.constant_schedule(0.05)(7)))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_layer_decay_scales_and_mask_match_jax():
    _, params, model, _, _ = _small()
    depth = SMALL["depth"]
    ref_scales = flax_leaves_by_torch_key(JO.layer_decay_scales(params, 0.65, depth))
    ref_mask = flax_leaves_by_torch_key(JO.weight_decay_mask(params))
    scales = TO.layer_decay_scales(model, 0.65, depth)
    mask = TO.weight_decay_mask(model)
    assert set(scales) == set(ref_scales) == set(mask) == set(ref_mask)
    for k in scales:
        assert scales[k] == pytest.approx(float(ref_scales[k]), rel=1e-12), k
        assert mask[k] == bool(ref_mask[k]), k
    # spot checks of the reference's grouping on torch names
    assert scales["cls_token"] == scales["patch_embed.proj.weight"] == 0.65 ** 3
    assert scales["blocks.1.attn.qkv.weight"] == 0.65
    assert scales["head.weight"] == scales["rel_pos_bias.relative_position_bias_table"] == 1.0
    assert not mask["cls_token"] and not mask["blocks.0.gamma_1"] and mask["head.weight"]


@pytest.mark.parametrize("clip", [None, 1.0], ids=["no_clip", "clip"])
def test_adamw_steps_match_optax_chain(clip):
    """3 steps on the same params and grads: the port's AdamW groups against
    make_optimizer's optax chain, lr and wd read at the update index (the
    warmup makes lr(0) = 0)."""
    _, params, model, _, _ = _small()
    lr = JS.cosine_schedule(1e-2, 1e-4, 10, warmup_steps=2)
    wd = JS.cosine_schedule(0.05, 0.01, 10)
    tx = JO.make_optimizer(params, lr, weight_decay=0.05, wd_schedule=wd, clip_grad=clip,
                           layer_decay=0.65, depth=SMALL["depth"])
    opt = TO.make_optimizer(model, weight_decay=0.05, clip_grad=clip, layer_decay=0.65,
                            depth=SMALL["depth"])
    t_lr = TS.cosine_schedule(1e-2, 1e-4, 10, warmup_steps=2)
    t_wd = TS.cosine_schedule(0.05, 0.01, 10)
    state = tx.init(params)
    named = dict(model.named_parameters())
    rs = np.random.RandomState(7)
    for step in range(3):
        grads = jax.tree_util.tree_map(lambda p: rs.randn(*p.shape).astype(np.float32), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, g in flax_to_state_dict(grads).items():
            named[k].grad = g
        norm = opt.step(t_lr(step), t_wd(step))
        np.testing.assert_allclose(norm.item(), float(JO.global_norm(grads)), rtol=1e-5)
    ref = flax_to_state_dict(params)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_other_optimizers_raise():
    _, _, model, _, _ = _small()
    with pytest.raises(NotImplementedError):
        TO.make_optimizer(model, opt_name="lamb")


# ---------------------------------------------------------------------------
# EMA, drop-path
# ---------------------------------------------------------------------------

def test_ema_update_and_boundary():
    ema = {"w": torch.tensor([1.0, 2.0])}
    ema_update(ema, {"w": torch.tensor([3.0, 6.0])}, 0.75)
    torch.testing.assert_close(ema["w"], torch.tensor([1.5, 3.0]))
    calls = []
    for step in range(4):
        ema_on_update_boundary(lambda: calls.append(step) or ema, ema, step, 2)
    assert calls == [1, 3]


def test_drop_path_mask_follows_the_generator_seed():
    x = torch.ones(64, 5, 8)
    a = drop_path(x, 0.5, True, torch.Generator().manual_seed(0))
    b = drop_path(x, 0.5, True, torch.Generator().manual_seed(0))
    c = drop_path(x, 0.5, True, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    with pytest.raises(ValueError):
        drop_path(x, 0.5, True)  # no global-generator draws in training


def test_model_forward_draws_drop_path_from_its_generator():
    cfg = TViTConfig(**dict(SMALL, drop_path_rate=0.5))
    model = VisionTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(5))
        b = model(x, generator=torch.Generator().manual_seed(5))
        c = model(x, generator=torch.Generator().manual_seed(6))
        with pytest.raises(ValueError):
            model(x)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_plain_attention_draws_its_dropout_mask_from_its_generator():
    """``naive_attention`` with dropout raises without a generator; through
    the model two generators of one seed give equal outputs and the global
    generator's state is untouched."""
    q = torch.randn(2, 2, 5, 16, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        naive_attention(q, q, q, 0.25, dropout_rate=0.5, deterministic=False)
    naive_attention(q, q, q, 0.25, dropout_rate=0.5, deterministic=True)  # draws nothing

    cfg = TViTConfig(**dict(SMALL, use_flash_attention=False, attn_drop_rate=0.5))
    model = VisionTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    before = torch.get_rng_state()
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(5))
        b = model(x, generator=torch.Generator().manual_seed(5))
        c = model(x, generator=torch.Generator().manual_seed(6))
        with pytest.raises(ValueError):
            model(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(torch.get_rng_state(), before)


# ---------------------------------------------------------------------------
# the whole train step
# ---------------------------------------------------------------------------

def test_train_step_matches_jax_engine():
    """One step of the small model (mixup off, label smoothing 0.1,
    drop-path 0, layer decay 0.65, wd 0.05): loss and grad norm at rtol 1e-5,
    grads at rtol 1e-4 / atol 1e-6, parameters after the AdamW step at
    rtol 1e-5 / atol 1e-6. Adam's first update is lr·g/(|g| + eps): where
    |g| ≲ 1e-6 the f32 rounding of g moves it by up to one lr step, so there
    the bound is |Δ| ≤ lr. The JAX engine runs its Pallas attention kernels
    in interpret mode; the port runs K1/K2's plain versions through the
    autograd Function."""
    jmodel, params, model, images, labels = _small(seed=1)
    hp_kw = dict(num_classes=SMALL["num_classes"], mixup_active=False, label_smoothing=0.1)
    lr = JS.cosine_schedule(1e-3, 1e-6, 100)
    tx = JO.make_optimizer(params, lr, weight_decay=0.05, layer_decay=0.65,
                           depth=SMALL["depth"])
    state = JE.FinetuneState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros([], jnp.int32))
    jstep = JE.make_finetune_train_step(jmodel, tx, JE.FinetuneHParams(**hp_kw), lr)
    new_state, jmetrics = jstep(state, jnp.asarray(images), jnp.asarray(labels),
                                jax.random.PRNGKey(0))
    targets = JM.one_hot_smooth(jnp.asarray(labels), SMALL["num_classes"], 0.1)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(images), None, deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(1),
                                    "droppath": jax.random.PRNGKey(2)})
        return JL.soft_target_cross_entropy(logits, targets)

    jgrads = flax_to_state_dict(jax.grad(loss_fn)(params))

    opt = TO.make_optimizer(model, weight_decay=0.05, layer_decay=0.65, depth=SMALL["depth"])
    tstate = TE.init_finetune_state(model, opt, use_model_ema=True)
    tstep = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**hp_kw),
                                        TS.cosine_schedule(1e-3, 1e-6, 100))
    before = TFA.fused_qkv_attention_bwd.launches
    metrics = tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels).long(),
                    torch.Generator().manual_seed(0))
    assert TFA.fused_qkv_attention_bwd.launches == before  # CPU: plain versions
    assert tstate.step == 1
    for k in ("loss", "grad_norm", "class_acc"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(metrics["lr"], float(jmetrics["lr"]), rtol=1e-6)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    ref = flax_to_state_dict(jax.device_get(new_state.params))
    for k, v in model.state_dict().items():
        well_posed = jgrads[k].abs() > 1e-6
        np.testing.assert_allclose(v[well_posed].numpy(), ref[k][well_posed].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert (v - ref[k]).abs().max().item() <= 1e-3, k
        assert well_posed.float().mean().item() > 0.99, k
    # EMA after one update: d·p0 + (1 − d)·p1
    p0 = flax_to_state_dict(params)
    d = 0.9999
    for k, e in tstate.model_ema.items():
        np.testing.assert_allclose(e.numpy(), d * p0[k].numpy() + (1 - d) * ref[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_train_step_with_mixup_and_drop_path_is_seeded():
    """mixup on and drop-path 0.1: the same generator seeds repeat the step
    exactly; the attention gradient runs through the Function."""
    cfg = TViTConfig(**dict(SMALL, drop_path_rate=0.1))

    def run(seed):
        model = VisionTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        opt = TO.make_optimizer(model, layer_decay=0.65, depth=cfg.depth)
        step = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(num_classes=10),
                                           TS.cosine_schedule(4e-3, 1e-6, 100, warmup_steps=5))
        state = TE.init_finetune_state(model, opt)
        x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
        y = torch.tensor([0, 1, 2, 3])
        m = [step(state, x, y, torch.Generator().manual_seed(seed),
                  torch.Generator().manual_seed(seed)) for _ in range(2)]
        return m, model.state_dict()

    (m1, s1), (m2, s2), (m3, _) = run(0), run(0), run(1)
    assert all(torch.equal(a["loss"], b["loss"]) for a, b in zip(m1, m2))
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert not torch.equal(m1[0]["loss"], m3[0]["loss"])
    assert all(math.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0 for m in m1)


def test_unported_engine_options_raise():
    _, _, model, _, _ = _small()
    opt = TO.make_optimizer(model)
    lr = TS.constant_schedule(1e-3)
    for hp in (TE.FinetuneHParams(update_freq=2), TE.FinetuneHParams(head_type="sngp"),
               TE.FinetuneHParams(masked_position_prob=0.1)):
        with pytest.raises(NotImplementedError):
            TE.make_finetune_train_step(model, opt, hp, lr)
