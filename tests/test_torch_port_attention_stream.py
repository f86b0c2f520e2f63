"""PyTorch port: the large-N attention route (kernels K3 and K4) against the
JAX package's streaming route.

On CPU tensors the port's route above ``BWD_MAX_N`` tokens runs the plain
versions that stand beside the streaming kernels: ``stream_fwd_plain`` and
the two halves ``stream_bwd_dq_plain`` / ``stream_bwd_dkv_plain``. The JAX
side is ``fused_qkv_attention`` with the streaming route forced exactly as
tests/test_flash_attention.py:185-192 forces it (``_FORCE_STREAM`` and
``_STREAM_CAPS = (8,)`` set on the imported module, so N=13 makes two query
tiles with a ragged last one), its Pallas kernels in interpret mode. The
port's threshold is lowered to 8 in the same fixture so that N=13 takes its
streaming route too. Inputs and cotangents are made with numpy from a seed
and handed to both. Forward: rtol 2e-4 / atol 2e-5
(tests/test_flash_attention.py:206); gradients: rtol 1e-3 / atol 1e-4
(:229). The JAX kernels' in-kernel dropout has no CPU lowering
(tests/test_flash_attention.py:100), so with dropout on the port is held
against itself (same mask forward and backward) and against the JAX
package's unfused attention in distribution.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as FA
from uncertainty_vit_tpu.ops.attention import naive_attention
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA

B, H, D, N = 2, 2, 64, 13
C = H * D
SCALE = D**-0.5
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture
def stream_routes():
    """Both packages on their large-N route at N=13."""
    prev = (FA.INTERPRET, FA.BOUNDED_SCORES, FA._FORCE_STREAM, FA._STREAM_CAPS,
            TFA.BOUNDED_SCORES, TFA.BWD_MAX_N)
    FA.INTERPRET, FA._FORCE_STREAM, FA._STREAM_CAPS = True, True, (8,)
    TFA.BWD_MAX_N = 8
    yield
    (FA.INTERPRET, FA.BOUNDED_SCORES, FA._FORCE_STREAM, FA._STREAM_CAPS,
     TFA.BOUNDED_SCORES, TFA.BWD_MAX_N) = prev


def _inputs(with_bias=True, with_qvb=True, seed=0, n=N):
    rs = np.random.RandomState(seed)
    qkv = rs.randn(B, n, 3 * C).astype(np.float32)
    bias = (rs.randn(H, n, n) * 0.5).astype(np.float32) if with_bias else None
    qvb = None
    if with_qvb:
        qvb = (rs.randn(3, C) * 0.3).astype(np.float32)
        qvb[1] = 0.0  # the reference's structurally zero key bias
    g = rs.randn(B, n, C).astype(np.float32)
    return qkv, bias, qvb, g


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _leaf(x):
    return None if x is None else torch.from_numpy(x).requires_grad_()


def _seed(v=0x1234ABCD5678):
    return torch.tensor([v], dtype=torch.int64)


@pytest.mark.parametrize("n,want", [(1, "fused"), (50, "fused"), (197, "fused"), (256, "fused"),
                                    (257, "stream"), (577, "stream"), (1025, "stream")])
def test_route_by_token_count(n, want):
    """One threshold, the fused backward's limit, for forward and backward:
    the 224 presets stay on K1/K2, the 384 and 512 presets take K3/K4."""
    assert TFA.BWD_MAX_N == 256
    assert TFA.route(n) == want


@pytest.mark.parametrize("bounded", [False, True], ids=["exact", "bounded"])
@pytest.mark.parametrize("with_qvb", [False, True], ids=["no_qvb", "qvb"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
def test_stream_forward_matches_jax(stream_routes, with_bias, with_qvb, bounded):
    qkv, bias, qvb, _ = _inputs(with_bias, with_qvb)
    FA.BOUNDED_SCORES = bounded
    assert FA._route(H, D, N) == "stream" and TFA.route(N) == "stream"
    ref = FA.fused_qkv_attention(_j(qkv), _j(bias), _j(qvb), jnp.zeros((1,), jnp.int32), SCALE,
                                 H, 0.0)
    out = TFA.fused_qkv_attention(_t(qkv), _t(bias), _t(qvb), None, SCALE, H,
                                  bounded_scores=bounded)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, N, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_RTOL, atol=FWD_ATOL)
    plain, _ = TFA.stream_fwd_plain(_t(qkv), _t(bias), _t(qvb), SCALE, H, bounded_scores=bounded)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("bounded", [False, True], ids=["exact", "bounded"])
def test_stream_lse_matches_jax(stream_routes, bounded):
    """The port's [B, H, N] lse against the JAX streaming forward's
    [B, G, N, group] one."""
    qkv, bias, qvb, _ = _inputs()
    FA.BOUNDED_SCORES = bounded
    _, lse = FA._stream_fwd_impl(_j(qkv), _j(bias), _j(qvb), jnp.zeros((1,), jnp.int32), SCALE,
                                 H, 0.0, want_lse=True)
    ref = np.asarray(lse).transpose(0, 1, 3, 2).reshape(B, H, N)
    _, got = TFA.fused_qkv_attention(_t(qkv), _t(bias), _t(qvb), None, SCALE, H,
                                     bounded_scores=bounded, want_lse=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=FWD_RTOL, atol=FWD_ATOL)


def _jax_grads(qkv, bias, qvb, g, bounded):
    FA.BOUNDED_SCORES = bounded
    seed = jnp.zeros((1,), jnp.int32)

    def f(qkv_, bias_, qvb_):
        return jnp.sum(FA.fused_qkv_attention(qkv_, bias_, qvb_, seed, SCALE, H, 0.0) * _j(g))

    args = [_j(x) for x in (qkv, bias, qvb)]
    argnums = tuple(i for i, a in enumerate(args) if a is not None)
    grads = jax.grad(f, argnums=argnums)(*args)
    out = [None, None, None]
    for i, gr in zip(argnums, grads):
        out[i] = np.asarray(gr)
    return out


@pytest.mark.parametrize("bounded", [False, True], ids=["exact", "bounded"])
@pytest.mark.parametrize("with_qvb", [False, True], ids=["no_qvb", "qvb"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
def test_stream_grads_match_jax(stream_routes, with_bias, with_qvb, bounded):
    """The Function on the port's streaming route (the two plain halves)
    against ``jax.grad`` through the JAX streaming kernels."""
    qkv, bias, qvb, g = _inputs(with_bias, with_qvb)
    ref = _jax_grads(qkv, bias, qvb, g, bounded)
    leaves = [_leaf(x) for x in (qkv, bias, qvb)]
    before = TFA.fused_qkv_attention_bwd.stream_launches
    TFA.fused_qkv_attention(*leaves, None, SCALE, H, bounded_scores=bounded).backward(_t(g))
    assert TFA.fused_qkv_attention_bwd.stream_launches == before  # CPU: the plain versions
    for name, leaf, r in zip(("dqkv", "dbias", "dqvb"), leaves, ref):
        if leaf is None:
            continue
        assert leaf.grad.dtype == torch.float32 and leaf.grad.shape == r.shape
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=RTOL, atol=ATOL, err_msg=name)
    if with_qvb:
        assert torch.all(leaves[2].grad[1] == 0)  # no key bias, no gradient


@pytest.mark.parametrize("bounded", [False, True], ids=["exact", "bounded"])
def test_plain_halves_from_jax_lse_match_jax_stream_kernels(stream_routes, bounded):
    """``stream_bwd_dq_plain`` and ``stream_bwd_dkv_plain`` fed the JAX
    forward's saved lse reproduce ``_stream_bwd_impl``'s two kernels."""
    qkv, bias, qvb, g = _inputs(seed=3)
    FA.BOUNDED_SCORES = bounded
    seed = jnp.zeros((1,), jnp.int32)
    j = [_j(x) for x in (qkv, bias, qvb, g)]
    out, lse = FA._stream_fwd_impl(j[0], j[1], j[2], seed, SCALE, H, 0.0, want_lse=True)
    dqkv, dbias, dqvb = FA._stream_bwd_impl(j[0], j[1], j[2], seed, lse, j[3], SCALE, H, 0.0)
    lse_bhn = _t(np.array(lse).transpose(0, 1, 3, 2).reshape(B, H, N))
    t = [_t(x) for x in (qkv, bias, qvb)]
    dq, got_dbias, c = TFA.stream_bwd_dq_plain(*t, lse_bhn, _t(g), SCALE, H,
                                               out=_t(np.array(out)))
    dk, dv = TFA.stream_bwd_dkv_plain(*t, lse_bhn, c, _t(g), SCALE, H)
    assert tuple(c.shape) == (B, H, N) and c.dtype == torch.float32
    ref = np.asarray(dqkv)
    for name, a, r in (("dq", dq, ref[..., :C]), ("dk", dk, ref[..., C:2 * C]),
                       ("dv", dv, ref[..., 2 * C:]), ("dbias", got_dbias, np.asarray(dbias))):
        np.testing.assert_allclose(a.numpy(), r, rtol=RTOL, atol=ATOL, err_msg=name)
    got_dqvb = TFA.reduce_qv_bias_grad(torch.cat([dq, dk, dv], dim=-1))
    np.testing.assert_allclose(got_dqvb.numpy(), np.asarray(dqvb), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_halves_match_the_fused_plain_backward(dtype, rate):
    """The two halves compute the function ``fused_qkv_attention_bwd_plain``
    computes: the same products on the same rounded operands, the row sums
    handed from the first half to the second. Without the forward's output
    the first half sums t over the keys as the fused backward does, and the
    halves equal it to the bit; given the output it forms the row sums as
    g·o, and dq and dbias then differ from it only by those sums' rounding
    (f32: 1e-5; bf16: o rounded to bf16, K2's bound)."""
    qkv, bias, qvb, g = _inputs(seed=4, n=50)
    qkv_t, g_t = _t(qkv).to(dtype), _t(g).to(dtype)
    seed = _seed() if rate > 0 else None
    out, lse = TFA.stream_fwd_plain(qkv_t, _t(bias), _t(qvb), SCALE, H, bounded_scores=False,
                                    seed=seed, dropout_rate=rate)
    ref = TFA.fused_qkv_attention_bwd_plain(qkv_t, _t(bias), _t(qvb), lse, g_t, SCALE, H,
                                            seed=seed, dropout_rate=rate)
    dq, dbias, c = TFA.stream_bwd_dq_plain(qkv_t, _t(bias), _t(qvb), lse, g_t, SCALE, H,
                                           seed=seed, dropout_rate=rate)
    dk, dv = TFA.stream_bwd_dkv_plain(qkv_t, _t(bias), _t(qvb), lse, c, g_t, SCALE, H,
                                      seed=seed, dropout_rate=rate)
    assert dq.dtype == dk.dtype == dv.dtype == dtype and dbias.dtype == torch.float32
    torch.testing.assert_close(torch.cat([dq, dk, dv], dim=-1), ref[0], rtol=0, atol=0)
    torch.testing.assert_close(dbias, ref[1], rtol=1e-6, atol=1e-6)
    # the row sums from the output, as the CUDA kernels form them
    dq, dbias, c = TFA.stream_bwd_dq_plain(qkv_t, _t(bias), _t(qvb), lse, g_t, SCALE, H, out=out,
                                           seed=seed, dropout_rate=rate)
    dk, dv = TFA.stream_bwd_dkv_plain(qkv_t, _t(bias), _t(qvb), lse, c, g_t, SCALE, H,
                                      seed=seed, dropout_rate=rate)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for got, r in ((dq, ref[0][..., :C]), (dk, ref[0][..., C:2 * C]), (dv, ref[0][..., 2 * C:]),
                   (dbias, ref[1])):
        assert (got.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()
    # a batch slice of either half is the slice of the batch (its mask by image0)
    dq1, _, c1 = TFA.stream_bwd_dq_plain(qkv_t[1:], _t(bias), _t(qvb), lse[1:], g_t[1:], SCALE, H,
                                         out=out[1:], seed=seed, dropout_rate=rate, image0=1)
    dk1, dv1 = TFA.stream_bwd_dkv_plain(qkv_t[1:], _t(bias), _t(qvb), lse[1:], c1, g_t[1:], SCALE,
                                        H, seed=seed, dropout_rate=rate, image0=1)
    for a, r in ((dq1, dq[1:]), (dk1, dk[1:]), (dv1, dv[1:]), (c1, c[1:])):
        torch.testing.assert_close(a, r, rtol=1e-6, atol=1e-6)


def test_function_through_the_stream_route_matches_autograd_of_plain_forward(stream_routes):
    qkv, bias, qvb, g = _inputs(seed=5)
    a = [_leaf(x) for x in (qkv, bias, qvb)]
    b = [_leaf(x) for x in (qkv, bias, qvb)]
    assert TFA.route(N) == "stream"
    TFA.fused_qkv_attention(*a, None, SCALE, H, bounded_scores=False).backward(_t(g))
    out, _ = TFA.stream_fwd_plain(*b, SCALE, H, bounded_scores=False)
    out.backward(_t(g))
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=RTOL, atol=ATOL)


def test_stream_route_backward_replays_the_forward_mask(stream_routes):
    """Euler identity: out is linear in v through the dropped probabilities,
    so <df/dv, v> = 2f for f = sum(out²) exactly when the backward's two
    halves replay the forward's mask, and not from another seed."""
    qkv, _, _, _ = _inputs(seed=6)
    leaf = _leaf(qkv)
    out = TFA.fused_qkv_attention(leaf, None, None, _seed(), SCALE, H, 0.3, bounded_scores=False)
    f = (out.double() ** 2).sum()
    f.backward()
    data = leaf.detach()
    inner = (leaf.grad[..., 2 * C:].double() * data[..., 2 * C:].double()).sum().item()
    assert abs(inner - 2.0 * f.item()) <= 1e-5 * 2.0 * f.item()
    out2, lse = TFA.fused_qkv_attention(data, None, None, _seed(), SCALE, H, 0.3,
                                        bounded_scores=False, want_lse=True)
    wrong = TFA.fused_qkv_attention_bwd(data, None, None, lse, 2.0 * out2, SCALE, H, out=out2,
                                        seed=_seed(99), dropout_rate=0.3)[0]
    inner_wrong = (wrong[..., 2 * C:].double() * data[..., 2 * C:].double()).sum().item()
    assert abs(inner_wrong - 2.0 * f.item()) > 1e-3 * 2.0 * f.item()


def test_stream_route_dropout_against_jax_in_distribution(stream_routes):
    """Zero scores and v = 1: a row's output is its kept count over
    N·(1 − rate). The port's mask and the JAX package's unfused attention
    dropout (``naive_attention``) are different draws of the same
    distribution: both means within 4σ of 1, both row variances within 25%
    of rate / ((1 − rate)·N)."""
    rate, n, b = 0.3, 64, 8
    qkv = np.zeros((b, n, 3 * C), np.float32)
    qkv[..., 2 * C:] = 1.0
    TFA.BWD_MAX_N = 8
    ours = TFA.fused_qkv_attention(_t(qkv), None, None, _seed(), SCALE, H, rate).numpy()
    ours = ours.reshape(b, n, H, D)[..., 0]
    q = jnp.zeros((b, H, n, D))
    theirs = np.asarray(naive_attention(q, q, jnp.ones((b, H, n, D)), SCALE, dropout_rate=rate,
                                        dropout_rng=jax.random.PRNGKey(0),
                                        deterministic=False))[..., 0]
    var = rate / ((1.0 - rate) * n)
    sigma_mean = np.sqrt(var / (b * n * H))
    for rows in (ours, theirs):
        assert abs(rows.mean() - 1.0) <= 4 * sigma_mean
        assert abs(rows.var() / var - 1.0) <= 0.25


def test_stream_launchers_reject_non_cuda_tensors(stream_routes):
    """The launch paths never fall back to the plain versions (on the
    streaming route, as K3 and K4 are launched)."""
    qkv, bias, _, g = _inputs(with_qvb=False)
    assert TFA.route(N) == "stream"
    with pytest.raises(ValueError):
        TFA._launch(_t(qkv), _t(bias), None, SCALE, H, False, True)
    with pytest.raises(ValueError):
        TFA._launch_bwd(_t(qkv), _t(bias), None, torch.zeros(B, H, N), _t(g), _t(g), SCALE, H,
                        True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py holds the kernels on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [257, 577])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_stream_kernels_match_plain_on_card(cuda_device, dtype, n):
    qkv, bias, qvb, g = _inputs(n=n)
    qkv_t, g_t = _t(qkv).to(cuda_device, dtype), _t(g).to(cuda_device, dtype)
    bias_t, qvb_t = _t(bias).to(cuda_device), _t(qvb).to(cuda_device)
    fwd, bwd = TFA.fused_qkv_attention.stream_launches, TFA.fused_qkv_attention_bwd.stream_launches
    out, lse = TFA.fused_qkv_attention(qkv_t, bias_t, qvb_t, None, SCALE, H,
                                       bounded_scores=False, want_lse=True)
    got = TFA.fused_qkv_attention_bwd(qkv_t, bias_t, qvb_t, lse, g_t, SCALE, H, out=out)
    assert TFA.fused_qkv_attention.stream_launches == fwd + 1
    assert TFA.fused_qkv_attention_bwd.stream_launches == bwd + 1
    ref_out, _ = TFA.stream_fwd_plain(qkv_t, bias_t, qvb_t, SCALE, H, bounded_scores=False)
    dq, dbias, c = TFA.stream_bwd_dq_plain(qkv_t, bias_t, qvb_t, lse, g_t, SCALE, H, out=out)
    dk, dv = TFA.stream_bwd_dkv_plain(qkv_t, bias_t, qvb_t, lse, c, g_t, SCALE, H)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(got[0].float(), torch.cat([dq, dk, dv], dim=-1).float(),
                               rtol=tol, atol=tol * 10)
    torch.testing.assert_close(got[1], dbias, rtol=tol, atol=tol * 10)
