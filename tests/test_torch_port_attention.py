"""PyTorch port: the attention forward (kernel K1) against the JAX package.

The port's ``fused_qkv_attention`` on CPU tensors runs its plain PyTorch
version; the JAX side runs the Pallas kernel in interpret mode, as
tests/test_flash_attention.py does. Inputs are made with numpy from a seed
and handed to both. Tolerances: out at the JAX attention tests' forward
tolerance (rtol 2e-4 / atol 2e-5, test_flash_attention.py:52), lse at atol
1e-5 (both f32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as FA
from uncertainty_vit_tpu.ops.attention import naive_attention as jax_naive_attention
from uncertainty_vit_tpu_torch.ops import attention as TA
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA

B, H, D = 2, 2, 64
C = H * D
SCALE = D**-0.5


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
    return qkv, bias, qvb


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("n", [13, 197])
@pytest.mark.parametrize("bounded", [False, True], ids=["exact", "bounded"])
@pytest.mark.parametrize("with_qvb", [False, True], ids=["no_qvb", "qvb"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
def test_fused_qkv_attention_matches_jax(n, bounded, with_qvb, with_bias):
    qkv, bias, qvb = _inputs(n, with_bias, with_qvb)
    FA.BOUNDED_SCORES = bounded
    seed = jnp.zeros((1,), jnp.int32)
    ref_out = FA.fused_qkv_attention(_j(qkv), _j(bias), _j(qvb), seed, SCALE, H, 0.0)
    ref_out2, ref_lse = FA._fwd_impl(_j(qkv), _j(bias), _j(qvb), seed, SCALE, H, 0.0,
                                     want_lse=True)
    # JAX lse is [B, G, N, group] with head = g·group + i → [B, H, N]
    ref_lse = np.asarray(ref_lse).transpose(0, 1, 3, 2).reshape(B, H, n)

    out = TFA.fused_qkv_attention(_t(qkv), _t(bias), _t(qvb), None, SCALE, H,
                                  bounded_scores=bounded)
    out2, lse = TFA.fused_qkv_attention(_t(qkv), _t(bias), _t(qvb), None, SCALE, H,
                                        bounded_scores=bounded, want_lse=True)
    assert out.shape == (B, n, C) and out.dtype == torch.float32
    assert lse.shape == (B, H, n) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref_out2), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=0, atol=1e-5)


def test_module_flag_selects_bounded_mode():
    qkv, bias, _ = _inputs(13, True, False)
    for flag in (False, True):
        TFA.BOUNDED_SCORES = flag
        by_flag = TFA.fused_qkv_attention(_t(qkv), _t(bias), None, None, SCALE, H, want_lse=True)
        explicit = TFA.fused_qkv_attention(_t(qkv), _t(bias), None, None, SCALE, H,
                                           bounded_scores=flag, want_lse=True)
        for a, b in zip(by_flag, explicit):
            assert torch.equal(a, b)


@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
def test_naive_attention_matches_jax(with_bias):
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(B, H, 13, D).astype(np.float32) for _ in range(3))
    bias = (rs.randn(H, 13, 13) * 0.5).astype(np.float32) if with_bias else None
    ref = jax_naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), SCALE, _j(bias))
    out = TA.naive_attention(_t(q), _t(k), _t(v), SCALE, _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_plain_fused_matches_naive_in_bf16():
    """bf16 inputs: the plain kernel version and the unfused path agree to
    bf16 rounding (they round the probabilities at different points)."""
    qkv, bias, _ = _inputs(50, True, False, seed=2)
    qkv_t = _t(qkv).to(torch.bfloat16)
    out = TFA.fused_qkv_attention(qkv_t, _t(bias), None, None, SCALE, H, bounded_scores=False)
    q, k, v = qkv_t.reshape(B, 50, 3, H, D).permute(2, 0, 3, 1, 4)
    ref = TA.naive_attention(q, k, v, SCALE, _t(bias)).transpose(1, 2).reshape(B, 50, C)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), rtol=2e-2, atol=2e-2)


def test_cpu_call_runs_plain_version_without_launching():
    qkv, bias, _ = _inputs(13, True, False)
    before = TFA.fused_qkv_attention.launches
    TFA.fused_qkv_attention(_t(qkv), _t(bias), None, None, SCALE, H)
    assert TFA.fused_qkv_attention.launches == before


def test_dropout_is_not_ported():
    """The attention wrapper's own dropout arguments: a rate above 0 needs a
    seed and drops, rate 0 reads no seed. There is no separate dropout to
    port: tests/test_torch_port_dropout.py holds the dropped values."""
    qkv, _, _ = _inputs(13, False, False)
    with pytest.raises(ValueError):
        TFA.fused_qkv_attention(_t(qkv), None, None, None, SCALE, H, 0.1)
    seed = torch.tensor([7], dtype=torch.int64)
    kept = TFA.fused_qkv_attention(_t(qkv), None, None, None, SCALE, H, 0.0)
    dropped = TFA.fused_qkv_attention(_t(qkv), None, None, seed, SCALE, H, 0.1)
    assert dropped.shape == kept.shape and not torch.equal(dropped, kept)
    assert torch.equal(TFA.fused_qkv_attention(_t(qkv), None, None, seed, SCALE, H, 0.0), kept)


def test_kernel_launch_rejects_non_cuda_tensors():
    """The launch path never falls back to the plain version."""
    qkv, _, _ = _inputs(13, False, False)
    with pytest.raises(ValueError):
        TFA._launch(_t(qkv), None, None, SCALE, H, False, False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py holds the kernel on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("bounded", [False, True], ids=["exact", "bounded"])
def test_kernel_matches_plain_on_card(cuda_device, bounded):
    qkv, bias, qvb = _inputs(197, True, True)
    args = [_t(x).to(cuda_device) for x in (qkv, bias, qvb)]
    args[0] = args[0].to(torch.bfloat16)
    launches = TFA.fused_qkv_attention.launches
    out, lse = TFA.fused_qkv_attention(args[0], args[1], args[2], None, SCALE, H,
                                       bounded_scores=bounded, want_lse=True)
    ref, ref_lse = TFA.fused_qkv_attention_plain(args[0], args[1], args[2], SCALE, H,
                                                 bounded_scores=bounded)
    assert TFA.fused_qkv_attention.launches == launches + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
