"""PyTorch port: the cross attention of sequence-parallel attention (K5)
against the JAX package's ``cross_qkv_attention``.

q [B, Nq, C] attends to packed kv [B, Nk, 2C] with Nq != Nk (one shard's
query rows against all gathered keys). On CPU tensors the port runs
``cross_fwd_plain`` and the two halves ``cross_bwd_dq_plain`` /
``cross_bwd_dkv_plain``, the plain versions K3 and K4 share; the JAX side
runs its Pallas kernels in interpret mode (``FA.INTERPRET = True``, as
tests/test_seq_parallel.py:24-28 sets it). Inputs and cotangents are made
with numpy from a seed and handed to both. Forward: rtol 2e-4 / atol 2e-5;
gradients: rtol 1e-3 / atol 1e-4 (tests/test_flash_attention.py:206, :229).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as FA
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA

B, H, D = 2, 2, 64
C = H * D
SCALE = D**-0.5
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
RTOL, ATOL = 1e-3, 1e-4
SHAPES = [(7, 13), (5, 17)]  # (Nq, Nk)


@pytest.fixture(autouse=True)
def interpret_mode():
    prev = (FA.INTERPRET, FA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    FA.INTERPRET = True
    yield
    FA.INTERPRET, FA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


def _inputs(nq, nk, with_bias=True, with_qvb=True, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, nq, C).astype(np.float32)
    kv = rs.randn(B, nk, 2 * C).astype(np.float32)
    bias = (rs.randn(H, nq, nk) * 0.5).astype(np.float32) if with_bias else None
    qvb = None
    if with_qvb:
        qvb = (rs.randn(3, C) * 0.3).astype(np.float32)
        qvb[1] = 0.0  # the reference's structurally zero key bias
    g = rs.randn(B, nq, C).astype(np.float32)
    return q, kv, bias, qvb, g


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _leaf(x):
    return None if x is None else torch.from_numpy(x).requires_grad_()


@pytest.mark.parametrize("bounded", [False, True], ids=["exact", "bounded"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("nq,nk", SHAPES)
def test_cross_forward_matches_jax(nq, nk, with_bias, bounded):
    q, kv, bias, qvb, _ = _inputs(nq, nk, with_bias)
    FA.BOUNDED_SCORES = bounded
    ref = FA.cross_qkv_attention(_j(q), _j(kv), _j(bias), _j(qvb), SCALE, H, 0.0)
    out = TFA.cross_qkv_attention(_t(q), _t(kv), _t(bias), _t(qvb), SCALE, H,
                                  bounded_scores=bounded)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, nq, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_RTOL, atol=FWD_ATOL)
    plain, lse = TFA.cross_fwd_plain(_t(q), _t(kv), _t(bias), _t(qvb), SCALE, H,
                                     bounded_scores=bounded)
    assert torch.equal(out, plain) and tuple(lse.shape) == (B, H, nq)


@pytest.mark.parametrize("bounded", [False, True], ids=["exact", "bounded"])
@pytest.mark.parametrize("nq,nk", SHAPES)
def test_cross_grads_match_jax(nq, nk, bounded):
    """dq, dkv, dbias and dqvb of the autograd Function (the two plain
    halves) against jax.grad through the JAX custom VJP's interpret-mode
    kernels."""
    q, kv, bias, qvb, g = _inputs(nq, nk)
    FA.BOUNDED_SCORES = bounded

    def grads(*x):
        return jax.vjp(lambda *y: FA.cross_qkv_attention(*y, SCALE, H, 0.0), *x)[1](_j(g))

    ref = jax.jit(grads)(_j(q), _j(kv), _j(bias), _j(qvb))
    leaves = [_leaf(x) for x in (q, kv, bias, qvb)]
    out = TFA.cross_qkv_attention(*leaves, SCALE, H, bounded_scores=bounded)
    out.backward(_t(g))
    for name, leaf, r in zip(("dq", "dkv", "dbias", "dqvb"), leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert torch.all(leaves[3].grad[1] == 0)


def test_cross_function_grads_equal_autograd_of_plain():
    """The Function's backward (the two halves from the saved lse) against
    autograd through the plain forward, and without a dbias when the bias
    needs no gradient."""
    q, kv, bias, qvb, g = _inputs(7, 13)
    leaves = [_leaf(x) for x in (q, kv, bias, qvb)]
    TFA.cross_qkv_attention(*leaves, SCALE, H, bounded_scores=False).backward(_t(g))
    plain = [_leaf(x) for x in (q, kv, bias, qvb)]
    TFA.cross_fwd_plain(*plain, SCALE, H, bounded_scores=False)[0].backward(_t(g))
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)
    out, lse = TFA.cross_fwd_plain(_t(q), _t(kv), _t(bias), _t(qvb), SCALE, H,
                                   bounded_scores=False)
    dq, dkv, dbias, dqvb = TFA.cross_qkv_attention_bwd(_t(q), _t(kv), _t(bias), _t(qvb), lse,
                                                       _t(g), SCALE, H, out=out,
                                                       want_dbias=False)
    assert dbias is None and torch.equal(dq, leaves[0].grad) and torch.equal(dkv, leaves[1].grad)
    assert torch.equal(dqvb, TFA.cross_qv_bias_grad(dq, dkv))


@pytest.mark.parametrize("with_qvb", [False, True], ids=["no_qvb", "qvb"])
def test_cross_plain_halves_are_the_packed_plain_versions(with_qvb):
    """At Nq = Nk on one tensor the cross plain versions compute what the
    packed streaming ones do, to the bit: one plain version serves K3/K4 and
    K5."""
    rs = np.random.RandomState(3)
    n = 11
    qkv = torch.from_numpy(rs.randn(B, n, 3 * C).astype(np.float32))
    bias = torch.from_numpy((rs.randn(H, n, n) * 0.5).astype(np.float32))
    qvb = torch.from_numpy((rs.randn(3, C) * 0.3).astype(np.float32)) if with_qvb else None
    g = torch.from_numpy(rs.randn(B, n, C).astype(np.float32))
    q, kv = qkv[..., :C].contiguous(), qkv[..., C:].contiguous()
    out, lse = TFA.cross_fwd_plain(q, kv, bias, qvb, SCALE, H, bounded_scores=False)
    ref_out, ref_lse = TFA.stream_fwd_plain(qkv, bias, qvb, SCALE, H, bounded_scores=False)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    dq, dbias, c = TFA.cross_bwd_dq_plain(q, kv, bias, qvb, lse, g, SCALE, H, out=out)
    ref_dq, ref_dbias, ref_c = TFA.stream_bwd_dq_plain(qkv, bias, qvb, lse, g, SCALE, H, out=out)
    assert torch.equal(dq, ref_dq) and torch.equal(dbias, ref_dbias) and torch.equal(c, ref_c)
    dkv = TFA.cross_bwd_dkv_plain(q, kv, bias, qvb, lse, c, g, SCALE, H)
    dk, dv = TFA.stream_bwd_dkv_plain(qkv, bias, qvb, lse, c, g, SCALE, H)
    assert torch.equal(dkv, torch.cat([dk, dv], dim=-1))


def test_cross_attention_raises_for_dropout():
    q, kv, _, _, _ = _inputs(7, 13)
    with pytest.raises(ValueError, match="attn_drop=0"):
        TFA.cross_qkv_attention(_t(q), _t(kv), None, None, SCALE, H, 0.1)


def test_cross_launchers_reject_non_cuda_tensors():
    """The launch paths never fall back to the plain versions."""
    q, kv, bias, _, g = _inputs(7, 13)
    with pytest.raises(ValueError, match="CUDA"):
        TFA._launch_cross(_t(q), _t(kv), _t(bias), None, SCALE, H, False, True)
    with pytest.raises(ValueError, match="CUDA"):
        TFA._launch_cross_bwd(_t(q), _t(kv), _t(bias), None, torch.zeros(B, H, 7), _t(g), _t(g),
                              SCALE, H, True)


@pytest.mark.parametrize("nq,nk", [(7, 13), (8, 13), (7, 12)])
def test_padded_bias_copies_take_both_counts(nq, nk):
    """[H, Nq, Nk + Nk % 2] and the transpose [H, Nk, Nq + Nq % 2], zero in
    the padding (the copies K2 reads; K5's kernels read the bias as it
    stands)."""
    bias = torch.from_numpy(_inputs(nq, nk)[2])
    bias_p, bias_t = TFA._padded_bias(bias)
    assert tuple(bias_p.shape) == (H, nq, nk + nk % 2)
    assert tuple(bias_t.shape) == (H, nk, nq + nq % 2)
    assert torch.equal(bias_p[..., :nk], bias) and torch.equal(bias_t[..., :nq],
                                                               bias.transpose(1, 2))
    assert torch.all(bias_p[..., nk:] == 0) and torch.all(bias_t[..., nq:] == 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py holds the kernels on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk", [(257, 1025), (63, 577)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cross_kernels_match_plain_on_card(cuda_device, dtype, nq, nk):
    q, kv, bias, qvb, g = _inputs(nq, nk)
    q_t, kv_t, g_t = (_t(x).to(cuda_device, dtype) for x in (q, kv, g))
    bias_t, qvb_t = _t(bias).to(cuda_device), _t(qvb).to(cuda_device)
    fwd, bwd = TFA.cross_qkv_attention.launches, TFA.cross_qkv_attention_bwd.launches
    out, lse = TFA.cross_qkv_attention(q_t, kv_t, bias_t, qvb_t, SCALE, H, bounded_scores=False,
                                       want_lse=True)
    dq, dkv, dbias, _ = TFA.cross_qkv_attention_bwd(q_t, kv_t, bias_t, qvb_t, lse, g_t, SCALE, H,
                                                    out=out)
    assert TFA.cross_qkv_attention.launches == fwd + 1
    assert TFA.cross_qkv_attention_bwd.launches == bwd + 1
    ref_out, _ = TFA.cross_fwd_plain(q_t, kv_t, bias_t, qvb_t, SCALE, H, bounded_scores=False)
    ref_dq, ref_dbias, c = TFA.cross_bwd_dq_plain(q_t, kv_t, bias_t, qvb_t, lse, g_t, SCALE, H,
                                                  out=out)
    ref_dkv = TFA.cross_bwd_dkv_plain(q_t, kv_t, bias_t, qvb_t, lse, c, g_t, SCALE, H)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dq.float(), ref_dq.float(), rtol=tol, atol=tol * 10)
    torch.testing.assert_close(dkv.float(), ref_dkv.float(), rtol=tol, atol=tol * 10)
    torch.testing.assert_close(dbias, ref_dbias, rtol=tol, atol=tol * 10)
