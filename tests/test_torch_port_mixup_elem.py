"""PyTorch port: mixup's per-sample modes (elem, pair) and cutmix_minmax
against the JAX package (ops/mixup.py).

The JAX package's draws of a key (``_elem_params`` for elem and pair, the
batch mode's scalars and ``_rand_bbox_minmax``'s box) are handed to the
port's application (``mix_elem``, ``mix_batch``), and the result is held
against the JAX package's ``mixup_cutmix`` of the same key: images and
targets within 1e-6 (f32 products of the same operands in the same order;
in practice equal). The port's own draws are held to their distributions:
the box sides uniform on [⌊dim·min⌋, ⌊dim·max⌋) under cutmix_minmax, lam
the realized box area where cutmix was drawn. The errors (bounds that
collapse, an odd batch in pair mode) are the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uncertainty_vit_tpu.ops import mixup as JM
from uncertainty_vit_tpu_torch.ops import mixup as TM

ATOL = 1e-6
H, W, CLASSES = 24, 20, 10
RATES = dict(mixup_alpha=0.8, cutmix_alpha=1.0, prob=0.7, switch_prob=0.5)


def _batch(seed, b=6):
    rs = np.random.RandomState(seed)
    images = rs.randn(b, H, W, 3).astype(np.float32)
    labels = rs.randint(0, CLASSES, size=b).astype(np.int32)
    return images, labels


def _corners(box):
    """(y1, y2, x1, x2) of each [H, W] 0/1 box (0, 0, 0, 0 where empty)."""
    out = []
    for b in np.asarray(box):
        rows, cols = np.nonzero(b.any(1))[0], np.nonzero(b.any(0))[0]
        out.append((rows[0], rows[-1] + 1, cols[0], cols[-1] + 1) if rows.size else (0, 0, 0, 0))
    return [np.array(v, np.int64) for v in zip(*out)]


def _jax_elem_draws(rng, count, minmax):
    apply, use_cutmix, lam, box = JM._elem_params(rng, count, H, W, RATES["mixup_alpha"],
                                                  RATES["cutmix_alpha"], RATES["prob"],
                                                  RATES["switch_prob"], minmax)
    draws = TM.ElemDraws(np.asarray(apply), np.asarray(use_cutmix), np.asarray(lam),
                         *_corners(box))
    # the corners give back the box
    rows, cols = np.arange(H)[None, :, None], np.arange(W)[None, None, :]
    again = ((rows >= draws.y1[:, None, None]) & (rows < draws.y2[:, None, None])
             & (cols >= draws.x1[:, None, None]) & (cols < draws.x2[:, None, None]))
    np.testing.assert_array_equal(again, np.asarray(box) > 0)
    return draws


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["elem", "pair"])
@pytest.mark.parametrize("minmax", [None, (0.2, 0.8)], ids=["lam_box", "minmax"])
@pytest.mark.parametrize("seed", range(3))
def test_per_sample_modes_with_jax_draws_match_jax(mode, minmax, seed):
    """elem / pair: the JAX package's per-sample draws through the port's
    application give the JAX package's images and targets."""
    images, labels = _batch(seed)
    rng = jax.random.PRNGKey(seed)
    want = JM.mixup_cutmix(rng, jnp.asarray(images), jnp.asarray(labels), CLASSES,
                           label_smoothing=0.1, mode=mode, cutmix_minmax=minmax, **RATES)
    count = len(images) if mode == "elem" else len(images) // 2
    draws = _jax_elem_draws(rng, count, minmax)
    if mode == "pair":
        draws = draws.mirrored()
    got = TM.mix_elem(torch.from_numpy(images), torch.from_numpy(labels).long(), CLASSES, 0.1,
                      draws)
    _same(got, want)


def test_per_sample_seeds_cover_every_branch():
    """The seeds above draw applied mixup, applied cutmix and unapplied
    samples."""
    kinds = set()
    for seed in range(3):
        d = _jax_elem_draws(jax.random.PRNGKey(seed), 6, None)
        kinds |= {"off" if not a else "cutmix" if c else "mixup"
                  for a, c in zip(d.apply, d.use_cutmix)}
    assert kinds == {"off", "cutmix", "mixup"}


@pytest.mark.parametrize("seed", range(4))
def test_batch_mode_with_minmax_matches_jax(seed):
    """batch mode with cutmix_minmax: the JAX package's batch draws and its
    minmax box through ``mix_batch``."""
    images, labels = _batch(seed)
    rng = jax.random.PRNGKey(seed)
    minmax = (0.2, 0.8)
    want = JM.mixup_cutmix(rng, jnp.asarray(images), jnp.asarray(labels), CLASSES,
                           label_smoothing=0.1, cutmix_minmax=minmax, **RATES)
    r_apply, r_switch, r_lam, r_box = jax.random.split(rng, 4)
    box, _ = JM._rand_bbox_minmax(r_box, H, W, minmax)
    draws = TM.MixupDraws(
        apply=bool(jax.random.bernoulli(r_apply, RATES["prob"])),
        use_cutmix=bool(jax.random.bernoulli(r_switch, RATES["switch_prob"])),
        lam_mix=float(JM._beta(r_lam, RATES["mixup_alpha"])), lam_cut=1.0, cy=0, cx=0,
        box=tuple(int(v[0]) for v in _corners(np.asarray(box)[None])))
    got = TM.mix_batch(torch.from_numpy(images), torch.from_numpy(labels).long(), CLASSES, 0.1,
                       draws)
    _same(got, want)


@pytest.mark.parametrize("mode", ["batch", "elem", "pair"])
def test_port_draws_and_application_compose(mode):
    """``mixup_cutmix`` is its draws from the generator followed by their
    application; a seed repeats it, another seed changes it."""
    images, labels = (torch.from_numpy(a) for a in _batch(7, b=8))
    labels = labels.long()
    kw = dict(RATES, label_smoothing=0.1, mode=mode, cutmix_minmax=(0.3, 0.7))

    def run(seed):
        return TM.mixup_cutmix(torch.Generator().manual_seed(seed), images, labels, CLASSES, **kw)

    gen = torch.Generator().manual_seed(3)
    args = (H, W, *RATES.values(), (0.3, 0.7))
    if mode == "batch":
        want = TM.mix_batch(images, labels, CLASSES, 0.1, TM.draw_mixup_batch(gen, *args))
    else:
        count = 8 if mode == "elem" else 4
        draws = TM.draw_mixup_elem(gen, count, *args)
        want = TM.mix_elem(images, labels, CLASSES, 0.1,
                           draws if mode == "elem" else draws.mirrored())
    got = run(3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(run(4)[0], got[0])


def test_elem_draws_follow_their_distributions():
    """cutmix_minmax: sides uniform on [⌊dim·min⌋, ⌊dim·max⌋), boxes inside
    the image, lam = 1 − area / image where cutmix was drawn; without it the
    box's area corrects the cutmix lambda. The switch and apply rates
    within 4σ."""
    n, h, w = 4000, 224, 200
    gen = torch.Generator().manual_seed(0)
    d = TM.draw_mixup_elem(gen, n, h, w, 0.8, 1.0, 0.8, 0.5, (0.2, 0.8))
    cut_h, cut_w = d.y2 - d.y1, d.x2 - d.x1
    for cut, dim in ((cut_h, h), (cut_w, w)):
        lo, hi = int(dim * 0.2), int(dim * 0.8)
        assert cut.min() == lo and cut.max() == hi - 1
        counts = np.bincount(cut - lo, minlength=hi - lo)
        expect = n / (hi - lo)
        assert abs(counts.mean() - expect) < 1e-9 and counts.std() < 4 * np.sqrt(expect)
    assert (d.y1 >= 0).all() and (d.y2 <= h).all() and (d.x1 >= 0).all() and (d.x2 <= w).all()
    # the corner uniform where the box fits: its mean position halfway
    assert abs(np.mean(d.y1 / (h - cut_h)) - 0.5) < 4 * np.sqrt(1 / 12 / n)
    area = np.float32(1.0) - (cut_h * cut_w).astype(np.float32) / np.float32(h * w)
    np.testing.assert_array_equal(d.lam[d.use_cutmix], area[d.use_cutmix])
    for rate, p in ((d.use_cutmix.mean(), 0.5), (d.apply.mean(), 0.8)):
        assert abs(rate - p) < 4 * np.sqrt(p * (1 - p) / n)
    # Beta(0.8, 0.8) where mixup was drawn: mean 1/2, variance 1/(4·2.6)
    lam_mix = d.lam[~d.use_cutmix]
    assert abs(lam_mix.mean() - 0.5) < 0.03 and abs(lam_mix.var() - 1 / 10.4) < 0.01
    d = TM.draw_mixup_elem(torch.Generator().manual_seed(1), 500, h, w, 0.8, 1.0, 1.0, 1.0)
    area = np.float32(1.0) - ((d.y2 - d.y1) * (d.x2 - d.x1)).astype(np.float32) / np.float32(h * w)
    assert d.use_cutmix.all()
    np.testing.assert_array_equal(d.lam, area)


def test_collapsed_minmax_bounds_raise_as_in_jax():
    """Bounds that collapse after int() raise, in both packages, with the
    same words (timm's randint raises there too)."""
    msg = r"cutmix_minmax \(0\.199, 0\.2\) collapses at image size \(224, 224\)"
    with pytest.raises(ValueError, match=msg):
        JM._rand_bbox_minmax(jax.random.PRNGKey(0), 224, 224, (0.199, 0.2))
    with pytest.raises(ValueError, match=msg):
        TM.draw_mixup_elem(torch.Generator(), 4, 224, 224, cutmix_minmax=(0.199, 0.2))
    with pytest.raises(ValueError, match=msg):
        TM.draw_mixup_batch(torch.Generator(), 224, 224, cutmix_minmax=(0.199, 0.2))


def test_pair_mode_refuses_an_odd_batch_as_in_jax():
    images, labels = _batch(0, b=5)
    with pytest.raises(ValueError, match="even batch"):
        JM.mixup_cutmix(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(labels),
                        CLASSES, mode="pair")
    with pytest.raises(ValueError, match="even batch"):
        TM.mixup_cutmix(torch.Generator(), torch.from_numpy(images),
                        torch.from_numpy(labels).long(), CLASSES, mode="pair")
