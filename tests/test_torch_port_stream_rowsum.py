"""PyTorch port: the backward's row sums c formed from the forward's
output, on the streaming and the fused route, and the bias buffers it builds.

The first backward kernel of K4 / K5 forms c_i = Σ_j p_d,ij (g_i·v_j) as
g_i·o_i from the forward's output o = p_d v (``rowsum_from_out``), where the
JAX kernels and the fused backward sum t = (g vᵀ)·p_d over whole rows
(``_recompute``). In f32 the two are one function: they are held to each
other to 1e-5 of max|c| over bias / none, q/v bias / none, exact / bounded
softmax, dropout 0 / 0.1 (one mask, from one seed, in the forward and the
recompute) and packed (Nq = Nk) and cross (Nq != Nk) shapes. Inputs are made
with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from uncertainty_vit_tpu_torch.ops import flash_attention as TFA

B, H, D = 2, 2, 64
C = H * D
SCALE = D**-0.5
C_RTOL = 1e-5


def _seed(v=0x5EED1234ABCD):
    return torch.tensor([v], dtype=torch.int64)


@pytest.mark.parametrize("nq,nk", [(13, 13), (7, 19)], ids=["packed", "cross"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bounded", [False, True], ids=["exact", "bounded"])
@pytest.mark.parametrize("with_qvb", [False, True], ids=["no_qvb", "qvb"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
def test_rowsum_from_out_equals_the_recomputed_rowsum(with_bias, with_qvb, bounded, rate, nq,
                                                      nk):
    rs = np.random.RandomState(nq * 100 + nk)
    q = torch.from_numpy(rs.randn(B, nq, C).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(B, nk, C).astype(np.float32)) for _ in range(2))
    g = torch.from_numpy(rs.randn(B, nq, C).astype(np.float32))
    bias = torch.from_numpy((rs.randn(H, nq, nk) * 0.5).astype(np.float32)) if with_bias else None
    qvb = None
    if with_qvb:
        qvb = torch.from_numpy((rs.randn(3, C) * 0.3).astype(np.float32))
        qvb[1] = 0.0
    seed = _seed() if rate > 0.0 else None
    out, lse = TFA._attention_plain(q, k, v, bias, qvb, SCALE, H, bounded, seed, rate, 0)
    t = TFA._recompute(q, k, v, bias, qvb, lse, g, SCALE, H, seed, rate, 0)[5]
    want = t.sum(dim=-1)
    got = TFA.rowsum_from_out(out, g, H)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, nq)
    assert (got - want).abs().max().item() <= C_RTOL * want.abs().max().item()
    # the first backward half hands exactly these row sums on (the cross
    # attention takes no dropout)
    if nq == nk:
        qkv = torch.cat([q, k, v], dim=-1)
        c = TFA.stream_bwd_dq_plain(qkv, bias, qvb, lse, g, SCALE, H, out=out, seed=seed,
                                    dropout_rate=rate)[2]
        assert torch.equal(c, got)
    elif rate == 0.0:
        c = TFA.cross_bwd_dq_plain(q, torch.cat([k, v], dim=-1), bias, qvb, lse, g, SCALE, H,
                                   out=out)[2]
        assert torch.equal(c, got)


# the fused route's plain backward given the output against the recomputed
# row sums: f32 to the rounding of c, bf16 to its rounding of the output
FUSED_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [197, 50, 256])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bounded", [False, True], ids=["exact", "bounded"])
@pytest.mark.parametrize("with_qvb", [False, True], ids=["no_qvb", "qvb"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
def test_fused_backward_with_the_output_equals_the_recomputed_rowsum(with_bias, with_qvb,
                                                                     bounded, rate, n, dtype):
    """``fused_qkv_attention_bwd_plain`` given the forward's output (c = g·o,
    as the kernels form it) against the same call without it (c =
    rowsum(t), as the JAX kernel forms it): dqkv, dbias and dqvb within
    FUSED_REL of the recomputed ones' largest entry."""
    rs = np.random.RandomState(n)
    qkv = torch.from_numpy(rs.randn(B, n, 3 * C).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rs.randn(B, n, C).astype(np.float32)).to(dtype)
    bias = torch.from_numpy((rs.randn(H, n, n) * 0.5).astype(np.float32)) if with_bias else None
    qvb = None
    if with_qvb:
        qvb = torch.from_numpy((rs.randn(3, C) * 0.3).astype(np.float32))
        qvb[1] = 0.0
    seed = _seed() if rate > 0.0 else None
    out, lse = TFA.fused_qkv_attention_plain(qkv, bias, qvb, SCALE, H, bounded_scores=bounded,
                                             seed=seed, dropout_rate=rate)
    got = TFA.fused_qkv_attention_bwd_plain(qkv, bias, qvb, lse, g, SCALE, H, out=out, seed=seed,
                                            dropout_rate=rate)
    want = TFA.fused_qkv_attention_bwd_plain(qkv, bias, qvb, lse, g, SCALE, H, seed=seed,
                                             dropout_rate=rate)
    assert got[0].dtype == dtype and got[0].shape == qkv.shape
    for name, a, r in zip(("dqkv", "dbias", "dqvb"), got, want):
        assert (a is None) == (r is None), name
        if a is None:
            continue
        err = (a.float() - r.float()).abs().max().item()
        assert err <= FUSED_REL[dtype] * r.float().abs().max().item(), (name, err)
    # the public entry hands the output on as given
    routed = TFA.fused_qkv_attention_bwd(qkv, bias, qvb, lse, g, SCALE, H, out=out, seed=seed,
                                         dropout_rate=rate)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(routed, got))


@pytest.mark.parametrize("n", [13, 197, TFA.BWD_MAX_N])
def test_fused_backward_needs_the_output(n):
    rs = np.random.RandomState(2)
    qkv = torch.from_numpy(rs.randn(1, n, 3 * C).astype(np.float32))
    g = torch.from_numpy(rs.randn(1, n, C).astype(np.float32))
    assert TFA.route(n) == "fused"
    with pytest.raises(ValueError, match="output"):
        TFA.fused_qkv_attention_bwd(qkv, None, None, torch.zeros(1, H, n), g, SCALE, H)


def test_streaming_backward_needs_the_output():
    rs = np.random.RandomState(1)
    n = TFA.BWD_MAX_N + 1
    qkv = torch.from_numpy(rs.randn(1, n, 3 * C).astype(np.float32))
    g = torch.from_numpy(rs.randn(1, n, C).astype(np.float32))
    lse = torch.zeros(1, H, n)
    with pytest.raises(ValueError, match="output"):
        TFA.fused_qkv_attention_bwd(qkv, None, None, lse, g, SCALE, H)


@pytest.mark.parametrize("want_dbias", [False, True])
@pytest.mark.parametrize("nq,nk", [(7, 13), (8, 8), (1025, 1025)])
def test_bias_buffers_build_no_copy_of_the_bias(nq, nk, want_dbias):
    """The backward reads the bias through shared memory (the key-major
    kernel transposed there): ``_bias_buffers`` builds only the zeroed dbias
    with its pitch (a multiple of 4: 16-byte atomics), no padded and no
    transposed copy."""
    bias = torch.zeros(H, nq, nk)
    got = TFA._bias_buffers(bias, H, nq, nk, want_dbias, bias.device)
    ldb, dbias = got
    assert len(got) == 2 and ldb >= nk and ldb % 4 == 0 and ldb - nk < 4
    if want_dbias:
        assert tuple(dbias.shape) == (H, nq, ldb) and dbias.dtype == torch.float32
        assert torch.count_nonzero(dbias).item() == 0
    else:
        assert dbias is None
    assert TFA._bias_buffers(None, H, nq, nk, True, bias.device) == (ldb, None)
