"""PyTorch port: the counter-based dropout bits, the fused dropout (K8) and the
attention kernels' dropout (K1) and mask replay (K2), on the CPU.

On CPU tensors the port's wrappers take the plain versions, which draw the
same mask as the CUDA kernels: a pure function of (seed, position) written
in ``ops/philox.py`` (the kernels themselves are held against the plain
versions on the card). The TPU kernels of the JAX package draw from the
core's hardware generator, which has no CPU lowering
(tests/test_flash_attention.py:98-101, tests/test_fused_dropout.py:56-59),
so the JAX side of a dropout-on comparison is flax ``nn.Dropout`` and the
comparison is one of distributions; dropout-off comparisons are exact.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

import uncertainty_vit_tpu.ops.flash_attention as JFA
from uncertainty_vit_tpu_torch.core import device as D
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.models import layers as TL
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import _native
from uncertainty_vit_tpu_torch.ops import dropout as DO
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.ops import philox as P

B, N, H, DH = 2, 13, 2, 64
C = H * DH
SCALE = DH**-0.5


def _seed(value=0x1234ABCD5678):
    return torch.tensor([value], dtype=torch.int64)


def _i64(*values):
    return [torch.tensor(v, dtype=torch.int64) for v in values]


# Known-answer vectors of Philox4x32-10 from the Random123 distribution
# (kat_vectors): counter, key → output.
KAT = {
    "zeros": ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    "ones": ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    "pi": ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
           (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
}


@pytest.mark.parametrize("case", sorted(KAT))
def test_philox_known_answer_vectors(case):
    counter, key, expected = KAT[case]
    out = P.philox4x32(*_i64(*counter), *_i64(*key))
    assert tuple(int(w) for w in out) == expected


def test_philox_mulhilo_is_the_exact_64_bit_product():
    rs = np.random.RandomState(0)
    c = rs.randint(0, 2**32, 1000, dtype=np.uint64)
    c[:3] = [0, 2**32 - 1, 2**31]
    for m in (P.M0, P.M1):
        hi, lo = P._mulhilo(m, torch.from_numpy(c.astype(np.int64)))
        prod = [int(m) * int(v) for v in c]
        assert hi.tolist() == [p >> 32 for p in prod]
        assert lo.tolist() == [p & 0xFFFFFFFF for p in prod]


def test_threshold_is_the_tpu_kernels():
    assert P.threshold(0.1) == int(0.1 * 2**32)
    assert P.threshold(0.5) == 2**31
    assert P.threshold(1.0) == 2**32 - 1
    assert P.threshold(0.0) == 0


def test_dropout_bits_of_a_slice_are_the_slice_of_the_bits():
    whole = P.dropout_bits(_seed(), 1001)
    assert whole.shape == (1001,) and int(whole.min()) >= 0 and int(whole.max()) < 2**32
    for offset, numel in ((0, 1001), (13, 10), (4, 4), (998, 3), (1, 1)):
        assert torch.equal(P.dropout_bits(_seed(), numel, offset=offset),
                           whole[offset:offset + numel])


def test_attention_bits_of_a_slice_are_the_slice_of_the_bits():
    """The property the backward's mask replay rests on: an entry's bits
    depend on its (image, head, row, column), not on the tile asking."""
    whole = P.attention_bits(_seed(), 3, H, 9, 11)
    assert whole.shape == (3, H, 9, 11)
    for image0, row0, col0, b, r, c in ((1, 3, 1, 2, 4, 3), (0, 0, 0, 3, 9, 11), (2, 8, 10, 1, 1, 1),
                                        (0, 1, 2, 1, 7, 8)):
        part = P.attention_bits(_seed(), b, H, r, c, image0=image0, row0=row0, col0=col0)
        assert torch.equal(part, whole[image0:image0 + b, :, row0:row0 + r, col0:col0 + c])


def test_same_seed_same_mask_other_seed_other_mask():
    a = P.dropout_bits(_seed(1), 4096)
    assert torch.equal(a, P.dropout_bits(_seed(1), 4096))
    assert not torch.equal(a, P.dropout_bits(_seed(2), 4096))
    # the high word of the seed is part of the key
    assert not torch.equal(a, P.dropout_bits(_seed(1 + 2**32), 4096))
    m = P.attention_bits(_seed(1), B, H, N, N)
    assert torch.equal(m, P.attention_bits(_seed(1), B, H, N, N))
    assert not torch.equal(m, P.attention_bits(_seed(2), B, H, N, N))
    # the two streams differ at the same counter and seed
    assert not torch.equal(P.dropout_bits(_seed(1), 4), P.attention_bits(_seed(1), 1, 1, 2, 2)
                           .reshape(-1))


def _philox_python(counter, key):
    """Philox4x32-10 on Python integers: an independent statement of the
    function, checked against the Random123 vectors above."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0, p1 = P.M0 * c[0], P.M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
        k = [(k[0] + P.W0) & 0xFFFFFFFF, (k[1] + P.W1) & 0xFFFFFFFF]
    return tuple(c)


# Known answers of the rounding stream for the seed 0x0123456789ABCDEF: entry
# (row, col) is word col & 3 of counter (col >> 2, row, 0, STREAM_QUANT).
QUANT_KAT = {(0, 0): 0x46C5FD35, (0, 5): 0xAC58CDE7, (7, 6): 0xFE87916C,
             (31519, 3071): 0xD6509C44, (131071, 2303): 0x45B1AB21}


@pytest.mark.parametrize("entry", sorted(QUANT_KAT))
def test_quant_stream_known_answer_vectors(entry):
    row, col = entry
    seed = _seed(0x0123456789ABCDEF)
    assert _philox_python(KAT["pi"][0], KAT["pi"][1]) == KAT["pi"][2]
    words = _philox_python((col >> 2, row, 0, P.STREAM_QUANT), (0x89ABCDEF, 0x01234567))
    assert words[col & 3] == QUANT_KAT[entry]
    bits = P.quant_bits(seed, 1, 1, row0=row, col0=col)
    assert int(bits[0, 0]) == QUANT_KAT[entry]
    u = P.quant_uniform(seed, 1, 1, row0=row, col0=col)
    assert u.dtype == torch.float32 and float(u[0, 0]) == (QUANT_KAT[entry] >> 8) / 2.0**24


def test_quant_bits_of_a_tile_are_the_tile_of_the_bits():
    """An entry's rounding bits depend on its (row, column), not on the tile
    that rounds it; the stream differs from the two dropout streams, and the
    uniforms fill [0, 1) evenly."""
    whole = P.quant_bits(_seed(), 37, 53)
    assert whole.shape == (37, 53) and int(whole.min()) >= 0 and int(whole.max()) < 2**32
    for row0, col0, r, c in ((0, 0, 37, 53), (5, 3, 8, 9), (36, 52, 1, 1), (1, 4, 30, 4)):
        assert torch.equal(P.quant_bits(_seed(), r, c, row0=row0, col0=col0),
                           whole[row0:row0 + r, col0:col0 + c])
    assert not torch.equal(whole, P.quant_bits(_seed(2), 37, 53))
    assert not torch.equal(P.quant_bits(_seed(), 1, 4).reshape(-1), P.dropout_bits(_seed(), 4))
    u = P.quant_uniform(_seed(3), 512, 512).double()
    n = u.numel()
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) <= 4 * np.sqrt(1 / 12 / n)
    assert abs(float(u.var()) - 1 / 12) <= 4 * np.sqrt(1 / 180 / n)
    k = u - 0.5
    for a, b in ((k[:, 1:], k[:, :-1]), (k[1:], k[:-1])):
        assert abs(float((a * b).mean()) * 12) <= 4 / np.sqrt(a.numel())


@pytest.mark.parametrize("rate", [0.05, 0.1, 0.3, 0.5])
@pytest.mark.parametrize("stream", ["dropout", "attention"])
def test_kept_fraction_within_4_sigma(stream, rate):
    if stream == "dropout":
        bits = P.dropout_bits(_seed(11), 1 << 20)
    else:
        bits = P.attention_bits(_seed(11), 8, 4, 181, 181)
    n = bits.numel()
    kept = float((bits >= P.threshold(rate)).double().mean())
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(kept - (1 - rate)) <= 4 * sigma, (kept, sigma)


@pytest.mark.parametrize("stream", ["dropout", "attention"])
def test_no_lag_1_correlation_along_rows_or_columns(stream):
    """The keep bits of neighbours along a row and along a column are
    uncorrelated: the sample correlation of n pairs of independent bits has
    standard deviation 1/sqrt(n); held at 4 of them."""
    rate = 0.3
    if stream == "dropout":
        keep = (P.dropout_bits(_seed(5), 1024 * 768) >= P.threshold(rate)).reshape(1024, 768)
    else:
        keep = (P.attention_bits(_seed(5), 4, 4, 197, 197) >= P.threshold(rate))
    k = keep.double() - keep.double().mean()
    var = float((k * k).mean())
    for a, b in ((k[..., :, 1:], k[..., :, :-1]), (k[..., 1:, :], k[..., :-1, :])):
        corr = float((a * b).mean()) / var
        assert abs(corr) <= 4 / np.sqrt(a.numel()), corr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_fused_dropout_plain_values(dtype, rate):
    """Kept entries are x/(1 − rate), dropped entries 0. The kernel and its
    plain version multiply by the f32 reciprocal and round once, as the TPU
    kernel does; flax divides, which may differ in the last bit: held at one
    f32 ulp, and at one bf16 rounding (2⁻⁸) in bf16."""
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 96).astype(np.float32)).to(dtype)
    y = DO.fused_dropout(x, rate, _seed())
    assert y.dtype == dtype and y.shape == x.shape
    keep = P.dropout_bits(_seed(), x.numel()).reshape(x.shape) >= P.threshold(rate)
    assert torch.equal(y != 0, keep & (x != 0))
    assert torch.all(y[~keep] == 0)
    rtol = 1.2e-7 if dtype == torch.float32 else 2.0**-8
    np.testing.assert_allclose(y[keep].float().numpy(), (x[keep].float() / (1 - rate)).numpy(),
                               rtol=rtol, atol=0)
    assert torch.equal(y, DO.fused_dropout_plain(x, rate, _seed()))


def test_fused_dropout_against_flax_dropout_statistics():
    """Against flax nn.Dropout (the reference's dropout wherever its TPU
    kernel does not run, models/layers.py:77) on the same 10⁶ entries: the
    same two values per entry, kept fractions within 4σ of 1 − rate and of
    one another, and means of y within 4σ of the mean of x, for both."""
    rate, n = 0.1, 1000 * 1000
    x = (np.random.RandomState(1).randn(1000, 1000) + 1.0).astype(np.float32)
    ours = DO.fused_dropout(torch.from_numpy(x), rate, _seed(3)).numpy()
    flax = np.asarray(nn.Dropout(rate, deterministic=False).apply(
        {}, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(3)}))
    sigma_keep = np.sqrt(rate * (1 - rate) / n)
    # Var[y_i] = x_i² · rate/(1 − rate) for the mean of y around the mean of x
    sigma_mean = np.sqrt((x.astype(np.float64) ** 2).sum() * rate / (1 - rate)) / n
    for y in (ours, flax):
        kept = y != 0
        np.testing.assert_allclose(y[kept], x[kept] / (1 - rate), rtol=1.2e-7)
        assert abs(kept.mean() - (1 - rate)) <= 4 * sigma_keep
        assert abs(y.astype(np.float64).mean() - x.astype(np.float64).mean()) <= 4 * sigma_mean
    assert abs((ours != 0).mean() - (flax != 0).mean()) <= 4 * np.sqrt(2) * sigma_keep
    # the two masks are independent draws: they agree where chance says
    agree = ((ours != 0) == (flax != 0)).mean()
    assert abs(agree - (rate**2 + (1 - rate) ** 2)) <= 0.01


def test_fused_dropout_rate_0_returns_x_itself_and_bad_arguments_raise():
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    assert DO.fused_dropout(x, 0.0, None) is x
    with pytest.raises(ValueError):
        DO.fused_dropout(x, 1.0, _seed())
    with pytest.raises(ValueError):
        DO.fused_dropout(x, 0.1, None)
    with pytest.raises(ValueError):
        DO.fused_dropout(x, 0.1, torch.tensor([1, 2], dtype=torch.int64))
    with pytest.raises(ValueError):
        DO.fused_dropout(x, 0.1, torch.tensor([1], dtype=torch.int32))


def test_fused_dropout_takes_the_plain_version_only_on_cpu_tensors():
    """``supported`` says what the kernel takes: nothing that lies on the
    CPU. A CPU call launches nothing."""
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    assert not DO.supported(x)
    before = DO.fused_dropout.launches
    DO.fused_dropout(x, 0.3, _seed())
    assert DO.fused_dropout.launches == before


def test_draw_seed_follows_the_generator():
    a = P.draw_seed(torch.Generator().manual_seed(5), "cpu")
    b = P.draw_seed(torch.Generator().manual_seed(5), "cpu")
    c = P.draw_seed(torch.Generator().manual_seed(6), "cpu")
    assert a.dtype == torch.int64 and a.shape == (1,) and int(a) >= 0
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = torch.Generator().manual_seed(5)
    assert not torch.equal(P.draw_seed(g, "cpu"), P.draw_seed(g, "cpu"))


# ---- attention with dropout ----

def _attention_inputs(seed=0):
    rs = np.random.RandomState(seed)
    qkv = torch.from_numpy(rs.randn(B, N, 3 * C).astype(np.float32))
    bias = torch.from_numpy((0.5 * rs.randn(H, N, N)).astype(np.float32))
    qvb = torch.from_numpy((0.3 * rs.randn(3, C)).astype(np.float32))
    qvb[1] = 0.0
    return qkv, bias, qvb


def _dense(qkv, bias, qvb, seed, rate):
    """softmax · mask · v written out, with the mask from ops/philox.py."""
    q, k, v = qkv.split(C, dim=-1)
    if qvb is not None:
        q, v = q + qvb[0], v + qvb[2]
    q, k, v = (t.reshape(B, N, H, DH).transpose(1, 2) for t in (q, k, v))
    s = q @ k.transpose(-1, -2) * SCALE
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    if rate > 0:
        keep = P.attention_bits(seed, B, H, N, N) >= P.threshold(rate)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros(()))
    return (p @ v).transpose(1, 2).reshape(B, N, C)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_attention_plain_with_dropout_matches_dense(rate, with_bias, bounded):
    """f32, at the forward tolerance of tests/test_flash_attention.py:52."""
    qkv, bias, qvb = _attention_inputs()
    b_ = bias if with_bias else None
    out, lse = TFA.fused_qkv_attention(qkv, b_, qvb, _seed(), SCALE, H, rate,
                                       bounded_scores=bounded, want_lse=True)
    np.testing.assert_allclose(out.numpy(), _dense(qkv, b_, qvb, _seed(), rate).numpy(),
                               rtol=2e-4, atol=2e-5)
    # the lse is the undropped softmax's
    _, lse0 = TFA.fused_qkv_attention(qkv, b_, qvb, None, SCALE, H, 0.0,
                                      bounded_scores=bounded, want_lse=True)
    assert torch.equal(lse, lse0)
    # and the mask is a function of the seed
    other = TFA.fused_qkv_attention(qkv, b_, qvb, _seed(99), SCALE, H, rate,
                                    bounded_scores=bounded)
    assert not torch.equal(out, other)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_attention_function_gradient_with_dropout_matches_autograd_of_dense(rate):
    """The Function's backward (the plain K2 with the replayed mask) against
    autograd through the dense form, at the backward tolerance of
    tests/test_flash_attention.py:67."""
    qkv, bias, qvb = _attention_inputs(1)
    g = torch.from_numpy(np.random.RandomState(2).randn(B, N, C).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (qkv, bias, qvb)]
    TFA.fused_qkv_attention(*leaves, _seed(), SCALE, H, rate, bounded_scores=False).backward(g)
    ref = [t.clone().requires_grad_() for t in (qkv, bias, qvb)]
    _dense(*ref, _seed(), rate).backward(g)
    for name, a, r in zip(("qkv", "bias", "qv_bias"), leaves, ref):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=name)
    assert torch.all(leaves[2].grad[1] == 0)


def test_dropout_backward_replays_forward_mask():
    """The Euler identity of tests/test_flash_attention.py:102-123: for
    fixed q and k the output is linear in v through the dropped
    probabilities, so f = Σ out² has ⟨∂f/∂v, v⟩ = 2f exactly when the
    backward's mask is the forward's; with another seed it breaks at the
    percent level."""
    qkv, _, _ = _attention_inputs(3)
    rate = 0.3
    leaf = qkv.clone().requires_grad_()
    f = (TFA.fused_qkv_attention(leaf, None, None, _seed(7), SCALE, H, rate) ** 2).sum()
    f.backward()
    f = f.item()
    inner = float((leaf.grad[..., 2 * C:] * qkv[..., 2 * C:]).sum())
    np.testing.assert_allclose(inner, 2.0 * f, rtol=1e-3)

    out, lse = TFA.fused_qkv_attention(qkv, None, None, _seed(7), SCALE, H, rate, want_lse=True)
    wrong = TFA.fused_qkv_attention_bwd(qkv, None, None, lse, 2.0 * out, SCALE, H, out=out,
                                        seed=_seed(8), dropout_rate=rate)[0]
    inner_wrong = float((wrong[..., 2 * C:] * qkv[..., 2 * C:]).sum())
    assert abs(inner_wrong - 2.0 * f) > 1e-2 * 2.0 * f
    right = TFA.fused_qkv_attention_bwd(qkv, None, None, lse, 2.0 * out, SCALE, H, out=out,
                                        seed=_seed(7), dropout_rate=rate)[0]
    assert torch.equal(right, leaf.grad)


def test_plain_versions_of_a_batch_slice_are_the_slice_of_the_batch():
    """``image0`` lets the plain forward and backward be computed a slice of
    the batch at a time with the mask of the whole batch (how a large batch
    is held against the kernel on the card)."""
    qkv, bias, qvb = _attention_inputs(4)
    g = torch.from_numpy(np.random.RandomState(5).randn(B, N, C).astype(np.float32))
    kw = dict(seed=_seed(), dropout_rate=0.3)
    out, lse = TFA.fused_qkv_attention_plain(qkv, bias, qvb, SCALE, H, bounded_scores=False, **kw)
    dqkv, _, _ = TFA.fused_qkv_attention_bwd_plain(qkv, bias, qvb, lse, g, SCALE, H, **kw)
    assert B >= 2
    for i in range(B):
        out_i, _ = TFA.fused_qkv_attention_plain(qkv[i:i + 1], bias, qvb, SCALE, H,
                                                 bounded_scores=False, image0=i, **kw)
        np.testing.assert_allclose(out_i.numpy(), out[i:i + 1].numpy(), rtol=1e-6, atol=1e-7)
        dqkv_i, _, _ = TFA.fused_qkv_attention_bwd_plain(qkv[i:i + 1], bias, qvb, lse[i:i + 1],
                                                         g[i:i + 1], SCALE, H, image0=i, **kw)
        np.testing.assert_allclose(dqkv_i.numpy(), dqkv[i:i + 1].numpy(), rtol=1e-6, atol=1e-7)
    # without the offset the second image draws the first image's mask
    wrong, _ = TFA.fused_qkv_attention_plain(qkv[1:2], bias, qvb, SCALE, H,
                                             bounded_scores=False, **kw)
    assert not torch.allclose(wrong, out[1:2], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("bounded", [False, True])
def test_attention_at_rate_0_ignores_the_seed_and_matches_the_jax_kernel(bounded):
    """Dropout off is exact against the JAX package's kernel in interpret
    mode (forward tolerance), whatever seed is passed."""
    qkv, bias, _ = _attention_inputs(4)
    prev = (JFA.INTERPRET, JFA.BOUNDED_SCORES)
    JFA.INTERPRET, JFA.BOUNDED_SCORES = True, bounded
    try:
        ref = JFA.fused_qkv_attention(jnp.asarray(qkv.numpy()), jnp.asarray(bias.numpy()), None,
                                      jnp.zeros((1,), jnp.int32), SCALE, H, 0.0)
    finally:
        JFA.INTERPRET, JFA.BOUNDED_SCORES = prev
    out = TFA.fused_qkv_attention(qkv, bias, None, _seed(), SCALE, H, 0.0, bounded_scores=bounded)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)
    assert torch.equal(out, TFA.fused_qkv_attention(qkv, bias, None, None, SCALE, H, 0.0,
                                                    bounded_scores=bounded))


def test_attention_dropout_bad_arguments_raise():
    qkv, _, _ = _attention_inputs()
    with pytest.raises(ValueError):
        TFA.fused_qkv_attention(qkv, None, None, None, SCALE, H, 0.1)
    with pytest.raises(ValueError):
        TFA.fused_qkv_attention(qkv, None, None, torch.tensor([1.0]), SCALE, H, 0.1)
    with pytest.raises(ValueError):
        TFA._dropout_args(_seed(), 1.0, torch.device("cpu"))
    assert TFA._dropout_args(None, 0.0, torch.device("cpu")) == (None, 0, 1.0)


# ---- the model's dropout sites ----

def test_dropout_sites_take_the_fused_dropout_without_grad_and_the_plain_one_with(monkeypatch):
    """Attention-projection and MLP-fc2 dropout go through K8's wrapper when
    no gradient is wanted, and keep the framework's dropout under grad mode
    (K8 is forward only, as in the reference)."""
    calls = []
    real = TL.fused_dropout
    monkeypatch.setattr(TL, "fused_dropout", lambda x, r, s: calls.append(r) or real(x, r, s))
    gen = torch.Generator().manual_seed(0)
    block = TL.Block(C, H, drop=0.25, device="cpu", generator=gen)
    x = torch.randn(2, 5, C, generator=gen)
    with torch.no_grad():
        y1, _ = block(x, generator=torch.Generator().manual_seed(1), deterministic=False)
        y2, _ = block(x, generator=torch.Generator().manual_seed(1), deterministic=False)
        y3, _ = block(x, generator=torch.Generator().manual_seed(2), deterministic=False)
    assert calls == [0.25] * 6
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    del calls[:]
    y, _ = block(x, generator=torch.Generator().manual_seed(1), deterministic=False)
    assert calls == [] and y.requires_grad
    block.eval()
    det, _ = block(x)
    assert calls == [] and not torch.equal(det, y)
    with torch.no_grad(), pytest.raises(ValueError):
        block(x, deterministic=False)  # a draw needs its generator


def test_model_attention_dropout_draws_its_seed_from_the_generator():
    cfg = TViTConfig(img_size=32, patch_size=16, embed_dim=C, depth=2, num_heads=H,
                     num_classes=5, attn_drop_rate=0.3)
    model = VisionTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(2), deterministic=False)
        b = model(x, generator=torch.Generator().manual_seed(2), deterministic=False)
        c = model(x, generator=torch.Generator().manual_seed(3), deterministic=False)
        det = model(x)
        with pytest.raises(ValueError):
            model(x, deterministic=False)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, det)
    # under grad mode the same draw goes through the Function, with the
    # same forward values
    model.train()
    d = model(x, generator=torch.Generator().manual_seed(2))
    assert d.requires_grad
    np.testing.assert_allclose(d.detach().numpy(), a.numpy(), rtol=1e-5, atol=1e-6)


# ---- the default device and the build ----

def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        D.default_device()
    with pytest.raises(RuntimeError):
        D.resolve(None)
    assert D.resolve("cpu") == torch.device("cpu")
    cfg = TViTConfig(img_size=32, patch_size=16, embed_dim=C, depth=1, num_heads=H, num_classes=3)
    with pytest.raises(RuntimeError):
        VisionTransformer(cfg)
    for build in (lambda: TL.Block(C, H), lambda: TL.Mlp(C, 2 * C, C),
                  lambda: TL.Attention(C, H), lambda: TL.PatchEmbed(16, 3, C),
                  lambda: TL.RelativePositionBias((2, 2), H)):
        with pytest.raises(RuntimeError):
            build()
    model = VisionTransformer(cfg, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edited header must not load a stale library."""
    monkeypatch.setattr(_native, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// kernel\n")
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = _native._digest(tmp_path / "k.cu")
    assert first == _native._digest(tmp_path / "k.cu")
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = _native._digest(tmp_path / "k.cu")
    (tmp_path / "k.cu").write_text("// kernel 2\n")
    third = _native._digest(tmp_path / "k.cu")
    assert len({first, second, third}) == 3
    assert first != hashlib.sha256(b"// kernel\n").hexdigest()[:16]


def test_kernel_sources_share_the_generator_header():
    attention = ("flash_attention_stream_fwd", "flash_attention_stream_bwd")
    quant = ("quant_fwd", "quant_wgrad")
    for name in ("dropout",) + attention + quant:
        assert '#include "philox.cuh"' in (_native.CSRC / f"{name}.cu").read_text()
    assert (_native.CSRC / "philox.cuh").exists()
    # the attention kernels share their fragment and copy helpers too, the
    # two int8 kernels their roundings and their mma wrapper
    for name in attention:
        assert '#include "attention_common.cuh"' in (_native.CSRC / f"{name}.cu").read_text()
    for name in quant:
        assert '#include "quant_common.cuh"' in (_native.CSRC / f"{name}.cu").read_text()
    # the attention kernels share their TMA, mbarrier and wgmma pieces
    for name in attention:
        assert '#include "hopper_common.cuh"' in (_native.CSRC / f"{name}.cu").read_text()
    headers = {p.name for p in _native.CSRC.glob("*.cuh")}
    assert headers == {"philox.cuh", "attention_common.cuh", "quant_common.cuh",
                       "hopper_common.cuh"}
    # every header enters every library's hash
    digest = _native._digest(_native.CSRC / "dropout.cu")
    assert len(digest) == 16 and sorted(p.stem for p in _native.CSRC.glob("*.cu")) == sorted(
        ("dropout",) + attention + quant)


@pytest.mark.cuda
def test_fused_dropout_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    seed = _seed().to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(197, 768, device=dev).to(dtype)
        before = DO.fused_dropout.launches
        y = DO.fused_dropout(x, 0.1, seed)
        assert DO.fused_dropout.launches == before + 1
        assert torch.equal(y, DO.fused_dropout_plain(x, 0.1, seed))


@pytest.mark.cuda
def test_attention_dropout_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    seed = _seed().to(dev)
    qkv = torch.randn(2, 50, 3 * 128, device=dev)
    out, lse = TFA.fused_qkv_attention(qkv, None, None, seed, 0.125, 2, 0.3, want_lse=True)
    ref, _ = TFA.fused_qkv_attention_plain(qkv, None, None, 0.125, 2, bounded_scores=False,
                                           seed=seed, dropout_rate=0.3)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-4)
    g = torch.randn(2, 50, 128, device=dev)
    got = TFA.fused_qkv_attention_bwd(qkv, None, None, lse, g, 0.125, 2, out=out, seed=seed,
                                      dropout_rate=0.3)[0]
    want = TFA.fused_qkv_attention_bwd_plain(qkv, None, None, lse, g, 0.125, 2, seed=seed,
                                             dropout_rate=0.3)[0]
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-4)
