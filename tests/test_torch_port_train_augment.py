"""PyTorch port: the finetune train transform (the train half of
``ops/augment.py``) against the JAX package.

Each op of the port applies given draws; ``jax_train_draws`` makes, from a
JAX key, the draws the JAX function takes from that key (the same splits and
folds), so the JAX function with its key and the port's with those draws
see the same randomness. The draw functions are held by themselves: the same
seed gives the same draws, and they follow their distributions.

Tolerances: the crop's resample on [0, 1] values within 1e-5 (a [B, out, in]
f32 product per axis, summed in another order than XLA's); after
normalizing (÷ std ≥ 0.224) within 1e-4. The boxes, flips, erased regions
and their normals are equal. With RandAugment (a bf16 table), one bf16 ulp
of the value before normalizing, 2^-8 / 0.224, on every element and 1e-4 on
all but 1% of them (tests/test_torch_port_randaugment.py says why).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_port_randaugment import jax_round_draws
from uncertainty_vit_tpu.ops import augment as JA
from uncertainty_vit_tpu_torch.ops import augment as TA
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

RESAMPLE_ATOL = 1e-5
NORMALIZED_ATOL = 1e-4
BF16_NORMALIZED = 2.0**-8 / 0.224


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _rrc_arrays(kc, b, attempts):
    def one(k):
        ka, kr, ki, kj = jax.random.split(k, 4)
        return (jax.random.uniform(ka, (attempts,)), jax.random.uniform(kr, (attempts,)),
                jax.random.uniform(ki, ()), jax.random.uniform(kj, ()))

    return jax.vmap(one)(jax.random.split(kc, b))


def jax_rrc_draws(kc, b, attempts=10):
    return TA.RRCDraws(*map(_t, _rrc_arrays(kc, b, attempts)))


def jax_color_jitter_draws(kj, b):
    kb, kc, ks, ko = jax.random.split(kj, 4)
    u = [_t(jax.random.uniform(k, (b, 1, 1, 1))).reshape(b) for k in (kb, kc, ks)]
    return TA.ColorJitterDraws(*u, _t(jax.random.randint(ko, (), 0, 6)).long())


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _erasing_arrays(ke, shape, count, pixel, attempts):
    b = shape[0]
    rects = []
    for i in range(count):
        ka, kr, ki, kj, kn = jax.random.split(jax.random.fold_in(ke, 1 + i), 5)
        rects.append((jax.random.uniform(ka, (b, attempts)), jax.random.uniform(kr, (b, attempts)),
                      jax.random.uniform(ki, (b,)), jax.random.uniform(kj, (b,)),
                      jax.random.normal(kn, shape) if pixel else None))
    return jax.random.uniform(jax.random.fold_in(ke, 0), (b,)), rects


def jax_erasing_draws(ke, shape, count=1, mode="pixel", attempts=10):
    gate, rects = _erasing_arrays(ke, tuple(shape), count, mode == "pixel", attempts)
    return TA.ErasingDraws(_t(gate), [TA.EraseDraws(*(None if v is None else _t(v) for v in r))
                                      for r in rects])


def jax_train_draws(key, b, out, auto_augment, color_jitter=0.4, reprob=0.25, re_mode="pixel",
                    re_count=1):
    """The port's draws of what JAX's finetune_train_augment_batch(key, ...)
    draws."""
    kc, kf, kj, ke = jax.random.split(key, 4)
    return TA.TrainAugmentDraws(
        jax_rrc_draws(kc, b), _t(jax.random.uniform(kf, (b, 1, 1, 1))).reshape(b),
        jax_round_draws(kj, b) if auto_augment else None,
        jax_color_jitter_draws(kj, b) if not auto_augment and color_jitter else None,
        jax_erasing_draws(ke, (b, 3, out, out), re_count, re_mode) if reprob > 0 else None)


def _planar(b, h, w, seed):
    return np.random.RandomState(seed).rand(b, 3, h, w).astype(np.float32)


# (h, w, scale, ratio, letterboxed extents or None): a square and an oblong
# image; a scale range no attempt can meet on a 24 × 3 image, so the centre
# crop clamped to the ratio range (too tall) and its transpose (too wide);
# letterboxed extents per sample
RRC_CASES = {
    "square": (16, 16, (0.08, 1.0), (3 / 4, 4 / 3), None),
    "oblong": (20, 12, (0.08, 1.0), (3 / 4, 4 / 3), None),
    "fallback_tall": (24, 3, (0.9, 1.0), (3 / 4, 4 / 3), None),
    "fallback_wide": (3, 24, (0.9, 1.0), (3 / 4, 4 / 3), None),
    "letterbox": (20, 20, (0.08, 1.0), (3 / 4, 4 / 3),
                  [[20, 11], [7, 20], [20, 20], [13, 13], [5, 19], [20, 2]]),
}


@pytest.mark.parametrize("case", list(RRC_CASES))
def test_rrc_boxes_match_jax(case):
    """_rrc_params: the same (top, left, crop_h, crop_w) per sample as JAX's
    from the same draws, the ten attempts, the fallback and valid_hw."""
    h, w, scale, ratio, vhw = RRC_CASES[case]
    b = 6
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, b)
    if vhw is None:
        want = jax.jit(jax.vmap(lambda k: JA._rrc_params(k, h, w, scale, ratio)))(keys)
        got = TA._rrc_params(jax_rrc_draws(key, b), h, w, scale, ratio)
    else:
        vhw = np.asarray(vhw, np.int32)
        want = jax.jit(jax.vmap(lambda k, vh, vw: JA._rrc_params(k, vh, vw, scale, ratio)))(
            keys, jnp.asarray(vhw[:, 0]), jnp.asarray(vhw[:, 1]))
        got = TA._rrc_params(jax_rrc_draws(key, b), _t(vhw[:, 0]), _t(vhw[:, 1]), scale, ratio)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    if case.startswith("fallback"):
        np.testing.assert_array_equal(got[2].numpy(), np.full(b, 4 if case.endswith("tall")
                                                              else 3))


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_crop_and_resize_matches_jax(method):
    """Boxes up against every edge, inside, and larger than the output
    (taps clamped to the edge, not renormalized), up- and downsampling."""
    x = _planar(5, 17, 13, 1)
    top = np.asarray([0, 9, 3, 0, 14], np.int32)
    left = np.asarray([0, 0, 5, 8, 12], np.int32)
    ch = np.asarray([17, 8, 4, 2, 3], np.int32)
    cw = np.asarray([13, 13, 3, 5, 1], np.int32)
    for out in ((9, 11), (24, 20)):
        want = jax.jit(JA.crop_and_resize_batch, static_argnums=(5, 6))(
            jnp.asarray(x), *map(jnp.asarray, (top, left, ch, cw)), out, method)
        got = TA.crop_and_resize_batch(torch.from_numpy(x), *map(_t, (top, left, ch, cw)), out,
                                       method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RESAMPLE_ATOL)


@pytest.mark.parametrize("method,letterbox", [("bicubic", False), ("bilinear", False),
                                              ("bicubic", True)])
def test_random_resized_crop_matches_jax(method, letterbox):
    x = _planar(6, 20, 20, 2)
    key = jax.random.PRNGKey(3)
    vhw = np.asarray([[20, 11], [7, 20], [20, 20], [13, 13], [5, 19], [20, 2]], np.int32)
    want = jax.jit(JA.random_resized_crop_batch, static_argnames=("out_size", "method"))(
        key, jnp.asarray(x), out_size=12, method=method,
        valid_hw=jnp.asarray(vhw) if letterbox else None)
    got = TA.random_resized_crop_batch(jax_rrc_draws(key, 6), torch.from_numpy(x), 12,
                                       method=method, valid_hw=_t(vhw) if letterbox else None)
    assert got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RESAMPLE_ATOL)


def test_hflip_matches_jax():
    x = _planar(16, 4, 6, 3)
    key = jax.random.PRNGKey(4)
    want = np.asarray(JA.random_hflip_batch(key, jnp.asarray(x), 0.5))
    got = TA.random_hflip_batch(_t(jax.random.uniform(key, (16, 1, 1, 1))).reshape(16),
                                torch.from_numpy(x), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    flipped = [not np.array_equal(got[i], x[i]) for i in range(16)]
    assert 0 < sum(flipped) < 16


def _key_with_order(order):
    """A key whose color_jitter_batch draws the given op order."""
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        if int(jax.random.randint(jax.random.split(key, 4)[3], (), 0, 6)) == order:
            return key
    raise AssertionError(order)


@pytest.mark.parametrize("order", range(6))
def test_color_jitter_matches_jax_in_each_order(order):
    """Per-sample factors and each of the six op orders (the order selects
    its ops on the device)."""
    x = _planar(6, 8, 8, 5)
    key = _key_with_order(order)
    draws = jax_color_jitter_draws(key, 6)
    assert int(draws.order) == order
    want = jax.jit(JA.color_jitter_batch, static_argnums=(2, 3, 4))(key, jnp.asarray(x), 0.4,
                                                                    0.3, 0.5)
    got = TA.color_jitter_batch(draws, torch.from_numpy(x), 0.4, 0.3, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert not np.allclose(got.numpy(), x)


@pytest.mark.parametrize("mode,count", [("pixel", 2), ("const", 3)])
def test_random_erasing_matches_jax(mode, count):
    """The gate, the rectangles (count > 1 at a count-th of the area each)
    and their fill, equal to JAX's."""
    x = _planar(32, 12, 10, 6)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(JA.random_erasing_batch, static_argnames=("prob", "mode", "count"))(
        key, jnp.asarray(x), prob=0.5, mode=mode, count=count))
    got = TA.random_erasing_batch(jax_erasing_draws(key, x.shape, count, mode),
                                  torch.from_numpy(x), prob=0.5, mode=mode, count=count).numpy()
    np.testing.assert_array_equal(got, want)
    erased = (got != x).any(axis=(1, 2, 3))
    assert 0 < erased.sum() < 32


# (auto_augment, reprob, re_mode, re_count, interpolation, letterbox): the
# driver's defaults, then without --aa, then letterboxed with the other
# flags' other values
PIPELINE_CASES = {
    "randaugment": (True, 0.25, "pixel", 1, "bicubic", False),
    "color_jitter": (False, 0.25, "pixel", 1, "bicubic", False),
    "letterbox": (False, 0.5, "const", 2, "bilinear", True),
}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_finetune_train_augment_batch_matches_jax(case):
    """The whole transform from uint8: JAX's with its key against the port's
    with that key's draws."""
    aa, reprob, re_mode, re_count, interp, letterbox = PIPELINE_CASES[case]
    b, out = 6, 12
    imgs = np.random.RandomState(8).randint(0, 256, (b, 20, 16, 3), dtype=np.uint8)
    vhw = np.asarray([[20, 16], [9, 16], [20, 5], [14, 14], [20, 16], [3, 3]], np.int32)
    kw = dict(auto_augment=aa, reprob=reprob, re_mode=re_mode, re_count=re_count,
              interpolation=interp)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(JA.finetune_train_augment_batch(
            key, jnp.asarray(imgs), out, valid_hw=jnp.asarray(vhw) if letterbox else None, **kw))
        draws = jax_train_draws(key, b, out, aa, reprob=reprob, re_mode=re_mode,
                                re_count=re_count)
        got = TA.finetune_train_augment_batch(draws, torch.from_numpy(imgs), out,
                                              valid_hw=_t(vhw) if letterbox else None, **kw)
        assert tuple(got.shape) == want.shape == (b, out, out, 3)
        diff = np.abs(got.numpy() - want)
        if aa:
            assert diff.max() <= BF16_NORMALIZED, diff.max()
            assert (diff > NORMALIZED_ATOL).mean() <= 0.01
        else:
            assert diff.max() <= NORMALIZED_ATOL, diff.max()


def test_draws_are_reproducible_from_a_seed():
    """The same seed draws the same values, another seed others; the train
    transform built by make_finetune_train_augment is a function of its
    generator."""
    def draws(seed):
        g = torch.Generator().manual_seed(seed)
        return TA.draw_finetune_train_augment(g, 4, 8, auto_augment=True, re_count=2)

    def flat(d):
        out = [d.rrc.area_u, d.rrc.ratio_u, d.rrc.iu, d.rrc.ju, d.flip_u, d.erasing.gate_u]
        for r in d.rand_augment:
            out += [r.op.float(), r.z, r.sign_u, r.apply_u]
        for e in d.erasing.rects:
            out += [e.area_u, e.ratio_u, e.iu, e.ju, e.noise]
        return out

    a, b, c = flat(draws(0)), flat(draws(0)), flat(draws(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    moved = draws(0).to("cpu")  # a copy, as the card's draws go to the CPU
    assert all(torch.equal(x, y) for x, y in zip(a, flat(moved)))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    imgs = torch.randint(0, 256, (4, 10, 10, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(2))
    aug = TA.make_finetune_train_augment(8, auto_augment=True, re_count=2)
    one = aug(torch.Generator().manual_seed(3), imgs)
    assert torch.equal(one, aug(torch.Generator().manual_seed(3), imgs))
    assert not torch.equal(one, aug(torch.Generator().manual_seed(4), imgs))


def test_draws_follow_their_distributions():
    """The crop's area fraction lies in the scale range and its aspect in the
    ratio range where an attempt fits, the centre crop is the fallback; the
    flip and the erasing gate fire at their rates."""
    n = 20000
    g = torch.Generator().manual_seed(11)
    d = TA.draw_rrc(g, n)
    top, left, ch, cw = TA._rrc_params(d, 64, 48, (0.08, 1.0), (3 / 4, 4 / 3))
    area = (ch * cw).float() / (64 * 48)
    aspect = cw.float() / ch.float()
    # rounding the sides to pixels moves the area and aspect a little
    assert area.min() >= 0.075 and area.max() <= 1.0
    assert aspect.min() >= 0.7 and aspect.max() <= 1.4
    assert (top >= 0).all() and (top + ch <= 64).all() and (left >= 0).all()
    assert (left + cw <= 48).all()
    # the mean area fraction of the accepted draws: below the uniform's 0.54,
    # as large targets fail more often and the first fitting attempt wins
    assert 0.35 < float(area.mean()) < 0.54
    # a scale no attempt can meet: every sample takes the clamped centre crop
    top, left, ch, cw = TA._rrc_params(d, 30, 4, (0.99, 1.0), (3 / 4, 4 / 3))
    assert (ch == 5).all() and (cw == 4).all() and (top == 12).all() and (left == 0).all()
    flips = TA.random_hflip_batch(TA.draw_hflip(g, n), torch.arange(2.0).view(1, 1, 1, 2)
                                  .expand(n, 1, 1, 2), 0.5)[:, 0, 0, 0]
    assert abs(float(flips.mean()) - 0.5) < 0.015
    e = TA.draw_random_erasing(g, (n, 3, 8, 8), mode="const")
    erased = TA.random_erasing_batch(e, torch.ones(n, 3, 8, 8), prob=0.25, mode="const")
    rate = float((erased == 0).flatten(1).any(1).float().mean())
    assert abs(rate - 0.25) < 0.015, rate  # every gated 8 × 8 image fits a box
