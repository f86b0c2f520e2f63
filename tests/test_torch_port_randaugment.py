"""PyTorch port: RandAugment (``ops/randaugment.py``) and the driver's
``--aa`` parser against the JAX package.

The same numpy images go through both packages' ops. The draws are fed to
both: the port's ops take them as arguments, and the JAX package's
``_one_round`` draws through ``jax.random``, which ``fed_jax`` replaces for
the call by a stand-in returning the same values. ``rand_augment_batch`` is
also held against the JAX function with its own key, the port given the
draws that key makes (``jax_round_draws``).

Tolerances: the ops in f32 within 1e-6 of JAX's (the same elementwise
arithmetic; sharpness and the means sum in another order); the warps within
1e-5 (a 3×3 product and bilinear blends of f32 coordinates). A round and the
whole RandAugment compare after the bf16 table: an entry of the table is
the bf16 rounding of an f32 value, and two f32 values an ulp apart can round
to neighbouring bf16 values, so the bound there is one bf16 ulp of the
value (2^-8 of [0.5, 1)) on every element, and 1e-5 on all but 1% of them.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uncertainty_vit_tpu.cli import finetune as JFT
from uncertainty_vit_tpu.ops import randaugment as JR
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.ops import randaugment as TR

OP_ATOL = 1e-6
WARP_ATOL = 1e-5
BF16_ULP = 2.0**-8


def _images(b=4, h=16, w=12, seed=0, levels=True):
    """[B, C, H, W] f32 in [0, 1]: uint8 levels / 255 (what the train
    transform feeds RandAugment after the crop is not on the levels; both
    kinds are used)."""
    rs = np.random.RandomState(seed)
    if levels:
        return (rs.randint(0, 256, (b, 3, h, w)) / 255.0).astype(np.float32)
    return rs.rand(b, 3, h, w).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_round_draws(kj, b, num_layers=2):
    """The port's draws of the rounds that JAX's rand_augment_batch(kj, ...)
    draws (fold_in per round, then op / magnitude / sign / apply keys)."""
    out = []
    for r in range(num_layers):
        k_op, k_mag, k_sign, k_apply = jax.random.split(jax.random.fold_in(kj, r), 4)
        out.append(TR.RoundDraws(_t(jax.random.randint(k_op, (b,), 0, TR.NUM_OPS)).long(),
                                 _t(jax.random.normal(k_mag, (b,))),
                                 _t(jax.random.uniform(k_sign, (b,))),
                                 _t(jax.random.uniform(k_apply, (b,)))))
    return out


def fed_jax(draws: TR.RoundDraws):
    """A stand-in for the ``jax`` module inside JAX's randaugment whose
    random functions return ``draws`` (the op, the normal, then the sign's
    and the apply gate's bernoullis from their uniforms)."""
    uniforms = [draws.sign_u.numpy(), draws.apply_u.numpy()]

    def bernoulli(key, p, shape):
        return jnp.asarray(uniforms.pop(0) < np.float32(p))

    rnd = types.SimpleNamespace(
        split=jax.random.split, fold_in=jax.random.fold_in,
        randint=lambda key, shape, lo, hi: jnp.asarray(draws.op.numpy().astype(np.int32)),
        normal=lambda key, shape: jnp.asarray(draws.z.numpy()),
        bernoulli=bernoulli)
    return types.SimpleNamespace(random=rnd, lax=jax.lax, nn=jax.nn, numpy=jnp)


def _jax_round(x):
    """JAX's _one_round at magnitude 9 ± 0.5, gate 0.5, compiled as one
    program (its draws are those ``fed_jax`` feeds while it traces)."""
    return jax.jit(lambda key, x: JR._one_round(key, x, 9.0, 0.5, 0.5))(jax.random.PRNGKey(0), x)


def _magnitude_params(mag, sign):
    frac = np.float32(mag) / np.float32(10.0)
    f = np.float32(1.0) + np.float32(sign) * np.float32(0.9) * frac
    return frac, f


@pytest.mark.parametrize("mag", [0.0, 4.5, 9.0, 10.0])
@pytest.mark.parametrize("op", ["autocontrast", "equalize", "invert", "posterize", "solarize",
                                "solarize_add", "color", "contrast", "brightness", "sharpness"])
def test_pixel_ops_match_jax(op, mag):
    """Each of the ten pixel ops at the magnitude's parameters (timm's
    increasing maps: enhance factor 1 ± 0.9·m/10, posterize bits
    max(4 − ⌊4m/10⌋, 1), solarize threshold 1 − m/10, solarize-add
    110·m/10 levels), on levels and on off-level values, against JAX."""
    for levels in (True, False):
        x = _images(levels=levels, seed=int(mag * 10))
        b = x.shape[0]
        frac, f_up = _magnitude_params(mag, 1.0)
        _, f_down = _magnitude_params(mag, -1.0)
        f = np.asarray([f_up, f_down] * (b // 2), np.float32)
        params = {
            "posterize": np.full(b, max(4 - np.floor(frac * 4), 1), np.int32),
            "solarize": np.full(b, 1.0 - frac, np.float32),
            "solarize_add": np.full(b, frac * 110.0 / 255.0, np.float32),
            "color": f, "contrast": f, "brightness": f, "sharpness": f,
        }
        args = () if op not in params else (params[op],)
        want = np.asarray(jax.jit(getattr(JR, op))(jnp.asarray(x), *map(jnp.asarray, args)))
        got = getattr(TR, op)(torch.from_numpy(x), *map(_t, args)).numpy()
        if op == "equalize":  # a bf16 table
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=OP_ATOL, err_msg=op)


@pytest.mark.parametrize("op", ["ROTATE", "SHEAR_X", "SHEAR_Y", "TRANSLATE_X", "TRANSLATE_Y"])
def test_geometric_ops_match_jax(op):
    """The five geometric ops: their matrices at magnitudes 0 .. 10 and both
    signs, and the image through the three-shear warp and through the
    nearest / bilinear affine warps, against JAX's."""
    x = _images(b=6, h=16, w=12, levels=False)
    idx = np.full(6, getattr(TR, op), np.int32)
    mag = np.asarray([0.0, 3.0, 7.5, 9.0, 10.0, 5.5], np.float32)
    sign = np.asarray([1, -1, 1, -1, 1, -1], np.float32)
    want_m = np.asarray(jax.jit(JR._affine_for_op, static_argnums=(3, 4))(
        jnp.asarray(idx), jnp.asarray(mag), jnp.asarray(sign), 16, 12))
    got_m = TR._affine_for_op(_t(idx).long(), _t(mag), _t(sign), 16, 12).numpy()
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=OP_ATOL)
    mats = jnp.asarray(want_m)
    np.testing.assert_allclose(TR.shear_warp(torch.from_numpy(x), _t(want_m)).numpy(),
                               np.asarray(jax.jit(JR.shear_warp)(jnp.asarray(x), mats)),
                               rtol=0, atol=WARP_ATOL)
    for method in ("nearest", "bilinear"):
        np.testing.assert_allclose(
            TR.affine_warp(torch.from_numpy(x), _t(want_m), method).numpy(),
            np.asarray(jax.jit(JR.affine_warp, static_argnums=2)(jnp.asarray(x), mats, method)),
            rtol=0, atol=WARP_ATOL,
            err_msg=method)


def _held_after_the_table(got, want, what):
    diff = np.abs(got - want)
    assert diff.max() <= BF16_ULP, (what, diff.max())
    assert (diff > WARP_ATOL).mean() <= 0.01, (what, (diff > WARP_ATOL).mean())


def test_lut_ops_equal_at_all_256_levels():
    """An image holding every level in every channel through a round whose
    draws pick each of the eight table ops (magnitude 7, both signs, gate
    on): the port's tables and JAX's give the same pixels."""
    levels = np.arange(256, dtype=np.float32).reshape(16, 16) / 255.0
    ops = np.repeat(np.asarray(TR._LUT_OPS), 2)
    b = len(ops)
    x = np.stack([np.stack([levels, levels[::-1], levels.T])] * b)
    z = np.full(b, (7.0 - 9.0) / 0.5, np.float32)  # magnitude 9 + 0.5·z = 7
    draws = TR.RoundDraws(_t(ops).long(), _t(z), _t(np.tile([0.25, 0.75], b // 2).astype(
        np.float32)), _t(np.zeros(b, np.float32)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got, got_m = TR._one_round(draws, xb, 9.0, 0.5, 0.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "jax", fed_jax(draws))
        want, want_m = _jax_round(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # each op but autocontrast (the identity on an image that spans 0 .. 1)
    # moved the levels
    same = {int(ops[i]) for i in range(b) if np.array_equal(got[i].numpy(), xb[i].float().numpy())}
    assert same == {TR.AUTOCONTRAST}, same


@pytest.mark.parametrize("input_dtype", ["bfloat16", "float32"])
def test_one_round_matches_jax_with_fed_draws(input_dtype):
    """All 15 ops, each with both signs, the gate on and off, at drawn
    magnitudes: the round's pixels and matrices against JAX's _one_round
    given the same draws (bf16 is the first round's input, f32 the
    second's)."""
    b = 60
    rs = np.random.RandomState(3)
    draws = TR.RoundDraws(_t(np.arange(b) % 15).long(), _t(rs.randn(b).astype(np.float32)),
                          _t(rs.rand(b).astype(np.float32)),
                          _t(np.repeat([0.1, 0.9], b // 2).astype(np.float32)))
    x = _images(b=b, h=12, w=12, levels=False, seed=4)
    dt = getattr(torch, input_dtype)
    got, got_m = TR._one_round(draws, torch.from_numpy(x).to(dt), 9.0, 0.5, 0.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "jax", fed_jax(draws))
        want, want_m = _jax_round(jnp.asarray(x, getattr(jnp, input_dtype)))
    _held_after_the_table(got.numpy(), np.asarray(want), "round")
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=0, atol=OP_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rand_augment_batch_matches_jax(seed):
    """Two rounds and the composed warp: JAX's rand_augment_batch with its
    key against the port's given that key's draws."""
    x = _images(b=16, h=16, w=16, levels=False, seed=10 + seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(JR.rand_augment_batch(key, jnp.asarray(x)))
    got = TR.rand_augment_batch(jax_round_draws(key, 16), torch.from_numpy(x))
    assert got.dtype == torch.float32
    _held_after_the_table(got.numpy(), want, "rand_augment_batch")


def test_draws_follow_their_distributions():
    """The op is uniform over the 15, the gate and the sign are fair coins,
    and the draws are a function of the generator's seed."""
    g = torch.Generator().manual_seed(7)
    d = TR.draw_rand_augment(g, 30000, num_layers=1)[0]
    counts = np.bincount(d.op.numpy(), minlength=15)
    assert counts.min() > 1800 and counts.max() < 2200, counts  # 2000 ± 4.5σ
    for u in (d.sign_u, d.apply_u):
        assert abs(float((u < 0.5).float().mean()) - 0.5) < 0.013
    assert abs(float(d.z.mean())) < 0.03 and abs(float(d.z.std()) - 1.0) < 0.03
    again = TR.draw_rand_augment(torch.Generator().manual_seed(7), 30000, num_layers=1)[0]
    assert all(torch.equal(getattr(d, k), getattr(again, k)) for k in ("op", "z", "sign_u", "apply_u"))


AA_CASES = ["rand-m9-mstd0.5-inc1", "rand-m7-mstd0.3", "rand-m9-n2", "rand-mstd1.0-m3.5",
            "None", "none", "", "original", "rand-m9-n3", "rand-m9-p0.5", "rand-m1.2.3",
            "rand-mstdx", "rand-inc0", "augmix-m5"]


@pytest.mark.parametrize("aa", AA_CASES)
def test_aa_kwargs_match_jax(aa):
    """The driver's --aa parser: the same keyword arguments as the JAX
    driver's, or the same error."""
    args = types.SimpleNamespace(aa=aa)
    try:
        want = JFT._aa_kwargs(args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TFT._aa_kwargs(args)
        assert str(got.value) == str(e)
        return
    assert TFT._aa_kwargs(args) == want
