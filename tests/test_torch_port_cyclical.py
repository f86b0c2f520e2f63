"""PyTorch port: the pieces of the cyclical (data2vec) pretraining step that
hold no model, against the JAX package: the regression losses, the EMA
decay schedule and the teacher's EMA rule, the blockwise masks and the
pretrain transform.

The masks and the transform take their draws apart from their ops:
``jax_mask_draws`` makes, from a JAX key, the uniforms the JAX mask
function takes from it (``split(key, B)``, then per attempt i
``split(fold_in(k, i), 4)``), and ``jax_pretrain_draws`` those of
``pretrain_augment_batch`` (``split(key, 3)`` into jitter, flip and crop,
each as the finetune transform's tests replay them). Tolerances: the losses
and schedules within 1e-6 relative (f32, the same operations); the EMA
within 1e-6 relative of JAX's f32 update; the masks, boxes, flips and
jitter orders equal; the transform within 1e-4 after normalizing (÷ std ≥
0.224 of resampled values within 1e-5), as
tests/test_torch_port_train_augment.py bounds it.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_data_ops import reference_blockwise_mask
from tests.test_torch_port_train_augment import (
    NORMALIZED_ATOL, jax_color_jitter_draws, jax_rrc_draws,
)
from uncertainty_vit_tpu.ops import augment as JA
from uncertainty_vit_tpu.ops import losses as JL
from uncertainty_vit_tpu.ops import masking as JM
from uncertainty_vit_tpu.train import ema as JE
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu_torch.ops import augment as TA
from uncertainty_vit_tpu_torch.ops import losses as TL
from uncertainty_vit_tpu_torch.ops import masking as TM
from uncertainty_vit_tpu_torch.train import ema as TE
from uncertainty_vit_tpu_torch.train import schedules as TS


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _regression_inputs(seed=0, b=3, n=10, c=8):
    rs = np.random.RandomState(seed)
    pred = (3 * rs.randn(b, n, c)).astype(np.float32)
    target = rs.randn(b, n, c).astype(np.float32)
    mask = (rs.rand(b, n) < 0.4).astype(np.float32)
    return pred, target, mask


@pytest.mark.parametrize("beta", [0.5, 2.0])
def test_smooth_l1_matches_jax(beta):
    pred, target, _ = _regression_inputs()
    np.testing.assert_allclose(TL.smooth_l1(_t(pred), _t(target), beta).numpy(),
                               np.asarray(JL.smooth_l1(pred, target, beta)), rtol=1e-6)


@pytest.mark.parametrize("l2", [False, True], ids=["smooth_l1", "l2"])
def test_masked_regression_loss_matches_jax(l2):
    pred, target, mask = _regression_inputs(1)
    for m in (mask, np.zeros_like(mask)):  # an empty mask divides by 1, not 0
        want = float(JL.masked_regression_loss(pred, target, m, beta=2.0, l2=l2))
        got = TL.masked_regression_loss(_t(pred), _t(target), _t(m), beta=2.0, l2=l2).item()
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("margin", [0.5, 4.0])
def test_masked_variance_hinge_matches_jax(margin):
    """margin 4 puts some channels' std under it (the hinge active), 0.5
    none of them."""
    pred, _, mask = _regression_inputs(2)
    want = float(JL.masked_variance_hinge(pred, mask, margin))
    got = TL.masked_variance_hinge(_t(pred), _t(mask), margin).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (want > 0) == (margin == 4.0)


# ---------------------------------------------------------------------------
# the EMA decay schedule and the teacher's rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start_at", [0, 7])
def test_ema_decay_schedule_matches_jax(start_at):
    want = JS.ema_decay_schedule(0.9998, 0.999, start_at)
    got = TS.ema_decay_schedule(0.9998, 0.999, start_at)
    for step in range(12):
        assert got(step) == float(want(step)), step


# (decay_init, ema_start_at, start_lr_decay_at_step, update_freq): the
# warm-up, a frozen teacher past the LR decay's start, a decay of 1
# (frozen throughout), and accumulation (the update on boundaries only, at
# the update index)
EMA_CASES = {
    "warmup": (0.5, 4, -1, 1),
    "freeze": (0.9, 0, 2, 1),
    "decay_one": (1.0, 0, -1, 1),
    "update_freq": (0.5, 3, -1, 2),
}


@pytest.mark.parametrize("case", list(EMA_CASES))
def test_cyclical_ema_step_matches_jax(case):
    """Six mini-steps of the teacher's rule on update boundaries against the
    JAX rule under ema_on_update_boundary, each mini-step's parameters a new
    draw."""
    decay_init, start_at, freeze_after, update_freq = EMA_CASES[case]
    decay = 1.0 if case == "decay_one" else 0.9
    rs = np.random.RandomState(3)
    shapes = {"a": (5, 4), "b": (7,)}
    ema_j = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    ema_t = {k: _t(v) for k, v in ema_j.items()}
    before = {k: v.clone() for k, v in ema_t.items()}
    for step in range(6):
        params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
        update = step // update_freq
        ema_j = JE.ema_on_update_boundary(
            lambda: JE.cyclical_ema_step(ema_j, params, jnp.int32(update), decay, decay_init,
                                         start_at, freeze_after),
            ema_j, jnp.int32(step), update_freq)
        TE.ema_on_update_boundary(
            lambda: TE.cyclical_ema_step(ema_t, {k: _t(v) for k, v in params.items()}, update,
                                         decay, decay_init, start_at, freeze_after),
            ema_t, step, update_freq)
        for k in shapes:
            np.testing.assert_allclose(ema_t[k].numpy(), np.asarray(ema_j[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{case} step {step} {k}")
        if case == "update_freq" and step == 0:
            assert all(torch.equal(ema_t[k], before[k]) for k in shapes)
    moved = not all(torch.equal(ema_t[k], before[k]) for k in shapes)
    assert moved == (case != "decay_one")
    assert TE.cyclical_ema_decay(3, 0.9, 0.9, 0, 2) == 1.0
    assert TE.cyclical_ema_decay(2, 0.9, 0.9, 0, 2) == np.float32(0.9)


# ---------------------------------------------------------------------------
# blockwise masks
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2))
def _mask_arrays(key, b, attempts):
    def one(k):
        def attempt(i):
            return jnp.stack([jax.random.uniform(kk)
                              for kk in jax.random.split(jax.random.fold_in(k, i), 4)])
        return jax.vmap(attempt)(jnp.arange(attempts))
    return jax.vmap(one)(jax.random.split(key, b))


def jax_mask_draws(key, b, num=120, min_num=16):
    """The [B, attempts, 4] uniforms ``batched_blockwise_mask(key, b, ...)``
    draws (JAX ops/masking.py:68-69, 113)."""
    return np.asarray(_mask_arrays(key, b, TM.default_attempts(num, min_num)))


# (grid, num, min, max, batch): the recipe's 14×14 / 120 / 16, a small grid,
# an oblong one with a block cap
MASK_CASES = {
    "recipe": ((14, 14), 120, 16, None, 128),
    "small": ((4, 4), 6, 2, None, 64),
    "oblong_capped": ((6, 5), 10, 3, 6, 64),
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_masks_on_jax_draws_equal_jax(case):
    """Bit for bit: given the uniforms the JAX function takes from its key,
    the port's op sets the same patches in every sample."""
    grid, num, min_num, max_num, b = MASK_CASES[case]
    key = jax.random.PRNGKey(11)
    want = np.asarray(JM.batched_blockwise_mask(key, b, grid, num, min_num, max_num))
    got = TM.blockwise_masks(jax_mask_draws(key, b, num, min_num), grid, num, min_num, max_num)
    assert got.dtype == np.float32 and got.shape == (b, grid[0] * grid[1])
    np.testing.assert_array_equal(got, want)
    assert got.sum(1).max() <= num


def test_mask_draws_are_reproducible_and_follow_the_reference():
    """The port's own draws: the same seed gives the same masks, another
    seed others; over 50 masks at the recipe's settings the mean count is
    within 6 of the reference generator's (tests/test_data_ops.py:18, as
    that file bounds the JAX function)."""
    a = TM.make_blockwise_masks(torch.Generator().manual_seed(4), 50)
    b = TM.make_blockwise_masks(torch.Generator().manual_seed(4), 50)
    c = TM.make_blockwise_masks(torch.Generator().manual_seed(5), 50)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    draws = TM.draw_blockwise(torch.Generator().manual_seed(4), 50, TM.default_attempts())
    assert tuple(draws.shape) == (50, 70, 4) and 0 <= float(draws.min()) and float(draws.max()) < 1
    rng = np.random.RandomState(0)
    ref = np.mean([reference_blockwise_mask(rng).sum() for _ in range(50)])
    assert abs(ref - a.sum(1).mean()) < 6.0, (ref, a.sum(1).mean())


# ---------------------------------------------------------------------------
# the pretrain transform
# ---------------------------------------------------------------------------

def jax_pretrain_draws(key, b, aug_level):
    """The port's draws of what JAX's pretrain_augment_batch(key, ...) draws
    at ``aug_level`` (JAX ops/augment.py:624)."""
    kj, kf, kc = jax.random.split(key, 3)
    return TA.PretrainAugmentDraws(
        jax_color_jitter_draws(kj, b) if aug_level in (4, -1) else None,
        _t(jax.random.uniform(kf, (b, 1, 1, 1))).reshape(b) if aug_level in (2, 3, 4, -1)
        else None,
        jax_rrc_draws(kc, b) if aug_level in (3, 4, -1) else None)


_jax_pretrain = jax.jit(JA.pretrain_augment_batch,
                        static_argnames=("out_size", "aug_level", "imagenet_default_mean_and_std",
                                         "color_jitter_strength"))


@pytest.mark.parametrize("letterbox", [False, True], ids=["canvas", "letterbox"])
@pytest.mark.parametrize("aug_level", [0, 1, 2, 3, -1])
def test_pretrain_augment_matches_jax(aug_level, letterbox):
    """Every level of the ladder (4 and -1 are one branch), on the whole
    canvas and on letterboxed extents (the crop inside the valid region, the
    flip after it, the box of levels 0-2 over the valid extent), given the
    JAX key's draws; the inception mean/std at level 2. The output 32 from
    40×48 images (48×40 at level 0: a crop larger than the image side on
    none of them)."""
    b, out = 6, 32
    h, w = (48, 40) if aug_level == 0 else (40, 48)
    rs = np.random.RandomState(aug_level + 1 + 10 * letterbox)
    u8 = rs.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    vhw = (np.stack([rs.randint(30, h + 1, b), rs.randint(20, w + 1, b)], 1).astype(np.int32)
           if letterbox else None)
    imagenet = aug_level != 2
    key = jax.random.PRNGKey(22 + aug_level)
    want = np.asarray(_jax_pretrain(key, jnp.asarray(u8), out_size=out, aug_level=aug_level,
                                    imagenet_default_mean_and_std=imagenet,
                                    valid_hw=None if vhw is None else jnp.asarray(vhw)))
    draws = jax_pretrain_draws(key, b, aug_level)
    got = TA.pretrain_augment_batch(draws, torch.from_numpy(u8), out, aug_level,
                                    imagenet_default_mean_and_std=imagenet,
                                    valid_hw=None if vhw is None else torch.from_numpy(vhw))
    assert tuple(got.shape) == want.shape == (b, out, out, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NORMALIZED_ATOL)


def test_pretrain_draws_are_reproducible_and_match_the_level():
    """Each level draws what it uses, from its generator alone; the
    transform built by make_pretrain_augment is the draws then the op."""
    u8 = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (4, 40, 40, 3)).astype(np.uint8))
    for level, parts in ((0, (False, False, False)), (1, (False, False, False)),
                         (2, (False, True, False)), (3, (False, True, True)),
                         (4, (True, True, True)), (-1, (True, True, True))):
        d = TA.draw_pretrain_augment(torch.Generator().manual_seed(1), 4, level)
        assert (d.color_jitter is not None, d.flip_u is not None, d.rrc is not None) == parts
    fn = TA.make_pretrain_augment(32)
    a = fn(torch.Generator().manual_seed(3), u8)
    b = fn(torch.Generator().manual_seed(3), u8)
    c = fn(torch.Generator().manual_seed(4), u8)
    d = TA.pretrain_augment_batch(TA.draw_pretrain_augment(torch.Generator().manual_seed(3), 4),
                                  u8, 32)
    assert torch.equal(a, b) and torch.equal(a, d) and not torch.equal(a, c)
