"""PyTorch port: the attention backward (kernel K2) against the JAX package.

The port's attention gradient on CPU tensors runs through its
``torch.autograd.Function`` (forward: K1's plain version with the row lse;
backward: ``fused_qkv_attention_bwd_plain``). The JAX side is ``jax.grad``
of ``fused_qkv_attention``, whose custom VJP runs the Pallas forward and
backward kernels in interpret mode, as tests/test_flash_attention.py does.
Inputs and the output cotangent are made with numpy from a seed and handed
to both. dqkv, dbias and dqvb are compared in f32 at the JAX attention
tests' backward tolerance, rtol 1e-3 / atol 1e-4
(tests/test_flash_attention.py:67).
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
RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def interpret_mode():
    prev = (FA.INTERPRET, FA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    FA.INTERPRET = True
    yield
    FA.INTERPRET, FA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


def _inputs(n, with_bias, with_qvb, seed=0):
    rs = np.random.RandomState(seed)
    qkv = rs.randn(B, n, 3 * C).astype(np.float32)
    bias = (rs.randn(H, n, n) * 0.5).astype(np.float32) if with_bias else None
    qvb = None
    if with_qvb:
        qvb = (rs.randn(3, C) * 0.3).astype(np.float32)
        qvb[1] = 0.0  # the reference's structurally zero key bias
    g = rs.randn(B, n, C).astype(np.float32)
    return qkv, bias, qvb, g


def _jax_grads(qkv, bias, qvb, g, bounded):
    FA.BOUNDED_SCORES = bounded
    seed = jnp.zeros((1,), jnp.int32)

    def f(qkv_, bias_, qvb_):
        out = FA.fused_qkv_attention(qkv_, bias_, qvb_, seed, SCALE, H, 0.0)
        return jnp.sum(out * jnp.asarray(g))

    args = [None if x is None else jnp.asarray(x) for x in (qkv, bias, qvb)]
    argnums = tuple(i for i, a in enumerate(args) if a is not None)
    grads = jax.grad(f, argnums=argnums)(*args)
    out = [None, None, None]
    for i, gr in zip(argnums, grads):
        out[i] = np.asarray(gr)
    return out


def _leaf(x):
    return None if x is None else torch.from_numpy(x).requires_grad_()


@pytest.mark.parametrize("n", [13, 197])
@pytest.mark.parametrize("bounded", [False, True], ids=["exact", "bounded"])
@pytest.mark.parametrize("with_qvb", [False, True], ids=["no_qvb", "qvb"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
def test_attention_grads_match_jax(n, bounded, with_qvb, with_bias):
    qkv, bias, qvb, g = _inputs(n, with_bias, with_qvb)
    ref = _jax_grads(qkv, bias, qvb, g, bounded)

    leaves = [_leaf(x) for x in (qkv, bias, qvb)]
    before = TFA.fused_qkv_attention_bwd.launches
    out = TFA.fused_qkv_attention(leaves[0], leaves[1], leaves[2], None, SCALE, H,
                                  bounded_scores=bounded)
    out.backward(torch.from_numpy(g))
    assert TFA.fused_qkv_attention_bwd.launches == before  # CPU: the plain version
    for name, leaf, r in zip(("dqkv", "dbias", "dqvb"), leaves, ref):
        if leaf is None:
            continue
        assert leaf.grad.dtype == torch.float32 and leaf.grad.shape == r.shape
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=RTOL, atol=ATOL, err_msg=name)
    if with_qvb:
        assert torch.all(leaves[2].grad[1] == 0)  # no key bias → no gradient


@pytest.mark.parametrize("bounded", [False, True], ids=["exact", "bounded"])
def test_plain_backward_from_jax_lse_matches_jax_kernel(bounded):
    """The plain backward fed JAX's own saved lse reproduces the interpret-
    mode ``_bwd_impl`` (its [B, G, N, group] lse converted to [B, H, N])."""
    n = 13
    qkv, bias, qvb, g = _inputs(n, True, True, seed=3)
    FA.BOUNDED_SCORES = bounded
    seed = jnp.zeros((1,), jnp.int32)
    j = [jnp.asarray(x) for x in (qkv, bias, qvb, g)]
    out, lse = FA._fwd_impl(j[0], j[1], j[2], seed, SCALE, H, 0.0, want_lse=True)
    ref = FA._bwd_impl(j[0], j[1], j[2], seed, lse, j[3], SCALE, H, 0.0)
    lse_bhn = np.array(lse).transpose(0, 1, 3, 2).reshape(B, H, n)
    got = TFA.fused_qkv_attention_bwd(
        *(torch.from_numpy(x) for x in (qkv, bias, qvb)), torch.from_numpy(lse_bhn),
        torch.from_numpy(g), SCALE, H, out=torch.from_numpy(np.array(out)))
    for name, a, r in zip(("dqkv", "dbias", "dqvb"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=name)


def test_function_matches_autograd_of_plain_forward():
    """The Function's gradient equals autograd through the plain forward."""
    qkv, bias, qvb, g = _inputs(20, True, True, seed=5)
    a = [_leaf(x) for x in (qkv, bias, qvb)]
    b = [_leaf(x) for x in (qkv, bias, qvb)]
    TFA.fused_qkv_attention(*a, None, SCALE, H, bounded_scores=False).backward(
        torch.from_numpy(g))
    out, _ = TFA.fused_qkv_attention_plain(*b, SCALE, H, bounded_scores=False)
    out.backward(torch.from_numpy(g))
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad, y.grad, rtol=RTOL, atol=ATOL)


def test_bf16_plain_backward_rounds_like_the_kernel():
    """bf16 inputs: dqkv comes back in bf16, dbias and dqvb in f32, and the
    result stays within bf16 rounding of the f32 backward."""
    qkv, bias, qvb, g = _inputs(50, True, True, seed=6)
    t = {k: torch.from_numpy(v) for k, v in dict(qkv=qkv, bias=bias, qvb=qvb, g=g).items()}
    q16, g16 = t["qkv"].to(torch.bfloat16), t["g"].to(torch.bfloat16)
    out, lse = TFA.fused_qkv_attention_plain(q16, t["bias"], t["qvb"], SCALE, H,
                                             bounded_scores=False)
    dqkv, dbias, dqvb = TFA.fused_qkv_attention_bwd(q16, t["bias"], t["qvb"], lse, g16, SCALE, H,
                                                    out=out)
    ref = TFA.fused_qkv_attention_bwd(q16.float(), t["bias"], t["qvb"], lse, g16.float(), SCALE, H,
                                      out=out.float())
    assert dqkv.dtype == torch.bfloat16 and dbias.dtype == dqvb.dtype == torch.float32
    for a, r in zip((dqkv, dbias, dqvb), ref):
        np.testing.assert_allclose(a.float().numpy(), r.numpy(), rtol=3e-2, atol=3e-2)


def test_no_grad_and_eval_calls_stay_forward_only():
    qkv, bias, _, _ = _inputs(13, True, False)
    leaf = torch.from_numpy(qkv).requires_grad_()
    with torch.no_grad():
        out = TFA.fused_qkv_attention(leaf, torch.from_numpy(bias), None, None, SCALE, H)
    assert out.grad_fn is None
    out = TFA.fused_qkv_attention(torch.from_numpy(qkv), torch.from_numpy(bias), None, None,
                                  SCALE, H)
    assert out.grad_fn is None


def test_backward_launch_rejects_non_cuda_tensors():
    """The backward's launch path never falls back to the plain version."""
    qkv, bias, _, g = _inputs(13, True, False)
    lse = torch.zeros(B, H, 13)
    with pytest.raises(ValueError):
        TFA._launch_bwd(torch.from_numpy(qkv), torch.from_numpy(bias), None, lse,
                        torch.from_numpy(g), torch.from_numpy(g), SCALE, H, True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py holds the kernel on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_backward_kernel_matches_plain_on_card(cuda_device, dtype):
    qkv, bias, qvb, g = _inputs(197, True, True)
    qkv_t = torch.from_numpy(qkv).to(cuda_device, dtype)
    g_t = torch.from_numpy(g).to(cuda_device, dtype)
    bias_t, qvb_t = (torch.from_numpy(x).to(cuda_device) for x in (bias, qvb))
    out, lse = TFA.fused_qkv_attention(qkv_t, bias_t, qvb_t, None, SCALE, H,
                                       bounded_scores=False, want_lse=True)
    launches = TFA.fused_qkv_attention_bwd.launches
    got = TFA.fused_qkv_attention_bwd(qkv_t, bias_t, qvb_t, lse, g_t, SCALE, H, out=out)
    ref = TFA.fused_qkv_attention_bwd_plain(qkv_t, bias_t, qvb_t, lse, g_t, SCALE, H)
    assert TFA.fused_qkv_attention_bwd.launches == launches + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip(got, ref):
        torch.testing.assert_close(a.float(), r.float(), rtol=tol, atol=tol * 10)
