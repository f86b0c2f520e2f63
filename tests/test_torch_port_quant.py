"""PyTorch port: the int8 trunk (``quant="int8"``) against the JAX package, on
the CPU.

On CPU tensors the port's ``qmm`` / ``wgrad`` take their plain versions (the
CUDA kernels K6 / K7 are held against those on the card, to the bit); the
JAX package's kernels run in the Pallas interpreter (``Q.INTERPRET``, as
tests/test_quant.py:15-17). Round-to-nearest paths compare value for value.
The stochastic rounding compares through injected uniforms against a numpy
emulation (exact on the int32 sums) and, against the JAX package, through
its statistics only: the TPU draws its bits from a hardware generator and
the interpreter hashes, the port counts with Philox.

A model of head width 80 (the beit_huge_patch16_224 preset's) is held here
too: it takes the attention kernels, as the reference's ``kernel_supported``
decides, and on the CPU their plain versions agree with the JAX model.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as JFA
from uncertainty_vit_tpu.core.config import ViTConfig
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.ops import quant as Q
from uncertainty_vit_tpu.train import engine_finetune as JE
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.models import layers as TLay
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import philox as P
from uncertainty_vit_tpu_torch.ops import quant as TQ
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils.checkpoint import flax_to_state_dict, load_flax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

# the int8 model of tests/test_quant.py:164-168: width 128, depth 2, mlp 256
INT8 = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2, num_classes=5,
            use_flash_attention=False, quant="int8", mlp_ratio=2.0)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(Q, "INTERPRET", True)
    monkeypatch.setattr(JFA, "INTERPRET", True)


def _seed(value=7):
    return torch.tensor([value], dtype=torch.int64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jseed(value=0):
    return jnp.asarray([value], jnp.int32)


# ---------------------------------------------------------------------------
# the quantizers and the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(128, 256), (256, 128), (384, 128)])
def test_quantize_cols_matches_jax_to_the_bit(shape):
    rs = np.random.RandomState(0)
    w = (rs.randn(*shape) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # a dead column: the 1e-30 floor
    jq, js = Q.quantize_cols(jnp.asarray(w))
    tq, ts = TQ.quantize_cols(_t(w))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (1, shape[1])
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    # of a torch [out, in] weight seen as [in, out]: the int8 copy keeps the
    # weight's memory order, which is what the kernel reads
    tq2, _ = TQ.quantize_cols(_t(w).t().contiguous().t())
    assert tq2.t().is_contiguous() and torch.equal(tq2, tq)


def test_supported_is_the_reference_rule():
    for m, k, n in ((8, 128, 128), (7, 128, 128), (131072, 768, 2304), (131073, 768, 2304),
                    (31520, 768, 3072), (31520, 3072, 768), (40, 96, 128), (40, 128, 200)):
        assert TQ.supported(m, k, n) == Q.supported(m, k, n), (m, k, n)


@pytest.mark.parametrize("m", [64, 70, 600], ids=["M=64", "M=70", "M=600 ragged"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
def test_int8_dense_forward_matches_jax_kernel(m, with_bias):
    """f32, at the tolerance of tests/test_quant.py:44 (the two frameworks
    order the dequantizing products differently). M=600 is ragged against
    the reference kernel's 512-row tile."""
    rs = np.random.RandomState(1)
    x = rs.randn(m, 128).astype(np.float32)
    w = (rs.randn(128, 256) * 0.05).astype(np.float32)
    b = (rs.randn(256) * 0.1).astype(np.float32) if with_bias else None
    ref = np.asarray(Q.int8_dense(jnp.asarray(x), jnp.asarray(w),
                                  None if b is None else jnp.asarray(b), _jseed()))
    before = TQ.qmm.launches
    out = TQ.int8_dense(_t(x), _t(w.T), None if b is None else _t(b), _seed(0))
    assert TQ.qmm.launches == before  # CPU: the plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, 256)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    exact = x @ w + (0.0 if b is None else b)
    assert np.abs(out.numpy() - exact).max() / np.abs(exact).max() < 0.02


@pytest.mark.parametrize("k", [4096, 6400])
@pytest.mark.parametrize("through", ["qmm_plain", "int8_dense"])
def test_wide_contraction_matches_jax_kernel(k, through):
    """Contractions wider than any trunk's (the reference admits every
    multiple of 128; 6400 is past the 6,272 that K6 once took): the plain
    version and the layer's forward against the JAX kernel in interpret
    mode, f32, nearest rounding, at the tolerance of the test above."""
    rs = np.random.RandomState(k)
    x = rs.randn(16, k).astype(np.float32)
    w = (rs.randn(k, 128) * 0.05).astype(np.float32)
    b = (rs.randn(128) * 0.1).astype(np.float32)
    if through == "qmm_plain":
        jwq, jws = Q.quantize_cols(jnp.asarray(w))
        ref = np.asarray(Q._qmm(jnp.asarray(x), jwq, jws, jnp.asarray(b), _jseed(), False,
                                jnp.float32))
        wq, ws = TQ.quantize_cols(_t(w))
        out = TQ.qmm_plain(_t(x), wq, ws, _t(b), None, False, torch.float32)
    else:
        ref = np.asarray(Q.int8_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), _jseed()))
        out = TQ.int8_dense(_t(x), _t(w.T), _t(b), _seed(0))
    assert out.dtype == torch.float32 and tuple(out.shape) == (16, 128)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_int8_dense_forward_3d_and_bf16():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 32, 128).astype(np.float32)
    w = (rs.randn(128, 128) * 0.05).astype(np.float32)
    ref = np.asarray(Q.int8_dense(jnp.asarray(x), jnp.asarray(w), None, _jseed()))
    out = TQ.int8_dense(_t(x), _t(w.T), None, _seed(0))
    assert tuple(out.shape) == (2, 32, 128)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    # bf16 in, bf16 out: one rounding of the f32 result
    xb = _t(x).to(torch.bfloat16)
    jref = Q.int8_dense(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), None, _jseed())
    outb = TQ.int8_dense(xb, _t(w.T), None, _seed(0))
    assert outb.dtype == torch.bfloat16
    np.testing.assert_allclose(outb.float().numpy(), np.asarray(jref.astype(jnp.float32)),
                               rtol=2.0**-7, atol=1e-3)


# ---------------------------------------------------------------------------
# stochastic rounding: injected uniforms, exact; statistics against the
# reference
# ---------------------------------------------------------------------------

def _np_quant_rows(x, u):
    """``_quantize_rows_tile`` (:116-125) in numpy f32."""
    amax = np.abs(x).max(axis=1, keepdims=True)
    inv = np.float32(127.0) / np.maximum(amax, np.float32(1e-30))
    t = x * inv
    q = np.floor(t + u) if u is not None else np.round(t)
    return np.clip(q, -128, 127).astype(np.int64), amax * np.float32(1.0 / 127.0)


@pytest.mark.parametrize("uniforms", ["numpy", "half", "philox"])
def test_dgrad_and_wgrad_with_injected_uniforms_are_exact(monkeypatch, uniforms):
    """The int32 sums of the plain versions against a numpy emulation on the
    same uniforms: drawn with numpy, planted at 0.5 (floor(v + 0.5), where
    entries on .5 tell the rounding modes apart), or the Philox stream's
    own."""
    rs = np.random.RandomState(3)
    m, k, n = 50, 128, 256
    x = rs.randn(m, k).astype(np.float32)
    g = (rs.randn(m, n) * 0.01).astype(np.float32)
    g[0, 0] = 1.0
    g[1] = np.float32(0.5) * np.abs(g[1]).max()  # x · inv lands on 63.5
    w = (rs.randn(k, n) * 0.05).astype(np.float32)
    seed = _seed(11)
    if uniforms == "philox":
        u = P.quant_uniform(seed, m, n).numpy()
    else:
        u = (rs.rand(m, n).astype(np.float32) if uniforms == "numpy"
             else np.full((m, n), 0.5, np.float32))
        monkeypatch.setattr(P, "quant_uniform",
                            lambda s, rows, cols, **kw: _t(u[:rows, :cols].copy()))

    # dgrad: dx = dequant(quant_rows_sr(g) · quant_cols(wᵀ))
    wtq, wts = TQ.quantize_cols(_t(w.T))
    gq, sg = _np_quant_rows(g, u)
    tq, ts = TQ.quantize_rows(_t(g), seed, True)
    assert np.array_equal(tq.numpy().astype(np.int64), gq)
    assert np.array_equal(ts.numpy(), sg)
    acc = gq @ wtq.numpy().astype(np.int64)
    ref = acc.astype(np.float32) * sg * wts.numpy()
    dx = TQ.qmm(_t(g), wtq, wts, None, seed, True, torch.float32)
    assert np.array_equal(dx.numpy(), ref)

    # wgrad: the raw sums of round(x / sx)ᵀ · floor(g / sg + u)
    sx, sgc = TQ._col_scales(_t(x)), TQ._col_scales(_t(g))
    inv_x, inv_g = sx.reciprocal(), sgc.reciprocal()
    xq = np.clip(np.round(x * inv_x.numpy()), -128, 127).astype(np.int64)
    gqc = np.clip(np.floor(g * inv_g.numpy() + u), -128, 127).astype(np.int64)
    want = xq.T @ gqc
    got = TQ.wgrad_acc_plain(_t(x), _t(g), inv_x, inv_g, seed)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy().astype(np.int64), want)
    dw = TQ.wgrad(_t(x), _t(g), seed)
    assert np.array_equal(dw.numpy(), want.astype(np.float32) * sx.numpy().reshape(-1, 1)
                          * sgc.numpy())


def test_rounding_saturates_at_the_int8_range(monkeypatch):
    """The row maximum lands on 127 and floor(127 + u) reaches 128 for u next
    to 1 (127.99999994 is no f32): the plain version, as the kernel,
    saturates to 127 where a plain cast would wrap to -128."""
    monkeypatch.setattr(P, "quant_uniform",
                        lambda s, rows, cols, **kw: torch.full((rows, cols), 0.99999994))
    xq, scale = TQ.quantize_rows(torch.tensor([[3.0, -3.0, 1.0]]), _seed(), True)
    assert xq.tolist() == [[127, -126, 43]] and float(scale) == 3.0 * np.float32(1.0 / 127.0)
    assert TQ._to_int8(torch.tensor([128.0, -129.0, 127.0, -128.0])).tolist() == [127, -128,
                                                                                  127, -128]


def _sr_inputs():
    rs = np.random.RandomState(3)
    x = rs.randn(32, 128).astype(np.float32)
    # gradients much smaller than their column amax: the heavy rounding regime
    g = (rs.randn(32, 128) * 0.01).astype(np.float32)
    g[0, 0] = 1.0
    return x, g


def test_wgrad_stochastic_rounding_is_unbiased_as_the_reference():
    """The mean of wgrad over 200 seeds converges to the column-quantized-x
    reference within 5% (tests/test_quant.py:96-116), for the port and for
    the JAX kernel on the same inputs."""
    x, g = _sr_inputs()
    sxa = np.maximum(np.abs(x).max(axis=0, keepdims=True), 1e-30) / 127.0
    ref = (np.round(x / sxa) * sxa).T @ g
    ours = np.mean([TQ.wgrad(_t(x), _t(g), _seed(s)).numpy() for s in range(200)], axis=0)
    jwgrad = jax.jit(Q._wgrad)
    theirs = np.mean([np.asarray(jwgrad(jnp.asarray(x), jnp.asarray(g), _jseed(s)))
                      for s in range(200)], axis=0)
    for name, mean in (("port", ours), ("jax", theirs)):
        rel = np.linalg.norm(mean - ref) / np.linalg.norm(ref)
        assert rel < 0.05, (name, rel)


def test_dgrad_stochastic_rounding_is_unbiased_as_the_reference():
    """The same for the dgrad: the mean of qmm(g, sr) over 200 seeds against
    g times the dequantized int8 weight."""
    _, g = _sr_inputs()
    g = np.ascontiguousarray(g.T[:, :32].T)  # [32, 128]
    rs = np.random.RandomState(4)
    w = (rs.randn(128, 128) * 0.05).astype(np.float32)  # reference layout [K, N]
    wtq, wts = TQ.quantize_cols(_t(w.T))
    ref = g @ (wtq.numpy().astype(np.float32) * wts.numpy())
    ours = np.mean([TQ.qmm(_t(g), wtq, wts, None, _seed(s), True, torch.float32).numpy()
                    for s in range(200)], axis=0)
    jwtq, jwts = Q.quantize_cols(jnp.asarray(w.T))
    jqmm = jax.jit(lambda g, s: Q._qmm(g, jwtq, jwts, None, s, True, jnp.float32))
    theirs = np.mean([np.asarray(jqmm(jnp.asarray(g), _jseed(s))) for s in range(200)], axis=0)
    for name, mean in (("port", ours), ("jax", theirs)):
        rel = np.linalg.norm(mean - ref) / np.linalg.norm(ref)
        assert rel < 0.05, (name, rel)


def test_dgrad_and_wgrad_of_one_call_draw_different_bits(monkeypatch):
    """The backward hands dgrad the layer's seed and wgrad seed + 1, and the
    two streams differ."""
    seeds = []
    real = P.quant_uniform

    def spy(seed, rows, cols, **kw):
        seeds.append(int(seed))
        return real(seed, rows, cols, **kw)

    monkeypatch.setattr(P, "quant_uniform", spy)
    x = torch.randn(16, 128, generator=torch.Generator().manual_seed(0)).requires_grad_()
    w = (torch.randn(128, 128, generator=torch.Generator().manual_seed(1)) * 0.05).requires_grad_()
    TQ.int8_dense(x, w, None, _seed(40)).sum().backward()
    assert seeds == [40, 41]
    a, b = real(_seed(40), 16, 128), real(_seed(41), 16, 128)
    assert not torch.equal(a, b)
    assert abs(float(((a - 0.5) * (b - 0.5)).mean()) * 12) < 4 / math.sqrt(a.numel())
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0


# ---------------------------------------------------------------------------
# gradients of the layer
# ---------------------------------------------------------------------------

def test_int8_dense_gradients_approximate_exact_as_the_reference():
    """dx, dw, db against the exact f32 layer: relative error under 0.12, db
    the exact f32 row sum of the upstream gradient (tests/test_quant.py:
    63-93); the port and the JAX package side by side on the same inputs."""
    rs = np.random.RandomState(2)
    x = rs.randn(64, 128).astype(np.float32)
    w = (rs.randn(128, 128) * 0.05).astype(np.float32)  # reference layout [K, N]
    b = (rs.randn(128) * 0.1).astype(np.float32)
    t = rs.randn(64, 128).astype(np.float32)

    def jloss(fn):
        return lambda x, w, b: ((fn(x, w, b) - t) ** 2).mean()

    jq = jax.grad(jloss(lambda x, w, b: Q.int8_dense(x, w, b, _jseed(7))), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jf = jax.grad(jloss(lambda x, w, b: x @ w + b), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))

    def tgrads(fn):
        leaves = [_t(x).requires_grad_(), _t(w.T).requires_grad_(), _t(b).requires_grad_()]
        y = fn(*leaves)
        ((y - _t(t)) ** 2).mean().backward()
        return [leaves[0].grad, leaves[1].grad.t(), leaves[2].grad], y.detach()

    tq, y_q = tgrads(lambda x, w, b: TQ.int8_dense(x, w, b, _seed(7)))
    tf, _ = tgrads(lambda x, w, b: torch.nn.functional.linear(x, w, b))
    for name, q, f, jq_, jf_ in zip(("dx", "dw", "db"), tq, tf, jq, jf):
        np.testing.assert_allclose(f.numpy(), np.asarray(jf_), rtol=1e-4, atol=1e-7, err_msg=name)
        for side, a, e in (("port", q.numpy(), f.numpy()), ("jax", np.asarray(jq_),
                                                            np.asarray(jf_))):
            rel = np.linalg.norm(a - e) / (np.linalg.norm(e) + 1e-9)
            assert rel < 0.12, (side, name, rel)
    g_up = 2.0 * (y_q.numpy() - t) / t.size
    np.testing.assert_allclose(tq[2].numpy(), g_up.sum(axis=0), rtol=1e-4, atol=1e-7)
    assert tq[1].dtype == torch.float32 and tq[0].dtype == torch.float32


def test_int8_dense_takes_no_gradient_for_what_needs_none():
    x = torch.randn(16, 128, generator=torch.Generator().manual_seed(0))
    w = (torch.randn(256, 128, generator=torch.Generator().manual_seed(1)) * 0.05).requires_grad_()
    b = torch.zeros(256, requires_grad=True)
    y = TQ.int8_dense(x, w, b, _seed())
    y.sum().backward()
    assert tuple(w.grad.shape) == (256, 128) and tuple(b.grad.shape) == (256,)
    assert torch.equal(b.grad, torch.full((256,), 16.0))
    with pytest.raises(ValueError):
        TQ.int8_dense(x.requires_grad_(), w, b, torch.tensor([1], dtype=torch.int32)
                      ).sum().backward()


def test_launchers_reject_cpu_tensors_and_bad_shapes():
    """The launch path never falls back to the plain version."""
    x = torch.randn(16, 128)
    wq, ws = TQ.quantize_cols(torch.randn(128, 128))
    with pytest.raises((ValueError, RuntimeError, AssertionError)):
        TQ._launch_qmm(x.reshape(4, 4, 128), wq, ws, None, None, False, torch.float32)
    with pytest.raises(ValueError):
        TQ._launch_qmm(torch.randn(4, 128), wq, ws, None, None, False, torch.float32)  # M < 8
    with pytest.raises(ValueError):
        TQ._launch_qmm(torch.randn(16, 96), wq[:96], ws, None, None, False, torch.float32)
    with pytest.raises(ValueError):
        TQ.wgrad_acc(torch.randn(4, 128), torch.randn(4, 128), torch.ones(128), torch.ones(128),
                     _seed())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _numpy_params(shapes, seed):
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if "kernel" in name:
            return (rs.randn(*leaf.shape) / math.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return (0.2 * rs.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _models(overrides, seed=0, batch=8):
    """(JAX model, its seeded numpy params, the port's model with the same
    weights loaded with strict=True, images, labels)."""
    cfg = ViTConfig(**overrides)
    rs = np.random.RandomState(seed + 100)
    images = rs.randn(batch, cfg.img_size, cfg.img_size, 3).astype(np.float32)
    labels = (np.arange(batch) % cfg.num_classes).astype(np.int32)
    jmodel = JViT(cfg=cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    params = _numpy_params(shapes, seed)
    model = load_flax_params(VisionTransformer(TViTConfig(**overrides), device="cpu"), params)
    return jmodel, params, model, images, labels


def _count_calls(monkeypatch, module, name="int8_dense"):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_int8_model_eval_logits_match_jax(monkeypatch):
    """The int8 JAX model's params load with strict=True (``quant`` adds no
    parameter); the same layers go int8 in both packages (4 per block); the
    eval logits agree within 2e-2 of the largest logit. Not tighter: the two
    LayerNorms differ by an f32 ulp here and there, an activation that sits
    on a rounding boundary then lands on the neighbouring int8 value, and one
    such flip moves an output by amax/127 times a weight; evaluation needs no
    generator."""
    jmodel, params, model, images, _ = _models(INT8)
    jcalls = _count_calls(monkeypatch, Q)
    tcalls = _count_calls(monkeypatch, TLay.quant_ops)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(images), deterministic=True))
    model.eval()
    with torch.no_grad():
        out = model(_t(images))
    assert len(jcalls) == len(tcalls) == 4 * INT8["depth"]
    assert sorted(math.prod(s[:-1]) for s in jcalls) == sorted(math.prod(s[:-1]) for s in tcalls)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    scale = np.abs(ref).max()
    assert np.abs(out.numpy() - ref).max() <= 2e-2 * scale, (np.abs(out.numpy() - ref).max(),
                                                             scale)
    # and the int8 model is another function than the bf16-free exact one,
    # close to it
    exact = load_flax_params(VisionTransformer(TViTConfig(**dict(INT8, quant="none")),
                                               device="cpu"), params).eval()
    with torch.no_grad():
        ex = exact(_t(images))
    assert not torch.equal(ex, out)
    assert (ex - out).abs().max() <= 0.1 * ex.abs().max()


def test_int8_model_train_step_matches_jax_engine_and_trains():
    """One step's loss against the JAX engine's on the same weights (the
    forward rounds to nearest in both; rtol 2e-2 for the reason above), a
    finite grad norm within 15% of the reference's (both backward passes
    round stochastically with their own bits), then ten steps lower the loss
    by 0.1 (tests/test_quant.py:181-185)."""
    jmodel, params, model, images, labels = _models(INT8)
    hp_kw = dict(num_classes=5, mixup_active=False, label_smoothing=0.0)
    lr = JS.constant_schedule(1e-3)
    tx = JO.make_optimizer(params, lr, weight_decay=0.0)
    state = JE.FinetuneState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros([], jnp.int32))
    jstep = JE.make_finetune_train_step(jmodel, tx, JE.FinetuneHParams(
        num_patches=jmodel.cfg.num_patches, **hp_kw), lr)
    _, jmetrics = jstep(state, jnp.asarray(images), jnp.asarray(labels), jax.random.PRNGKey(3))

    opt = TO.make_optimizer(model, weight_decay=0.0)
    tstate = TE.init_finetune_state(model, opt)
    tstep = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**hp_kw),
                                        TS.constant_schedule(1e-3))
    x, y = _t(images), _t(labels).long()
    with pytest.raises(ValueError):
        tstep(tstate, x, y, None)  # the rounding seeds come from the step's generator
    losses, norms = [], []
    gen = torch.Generator().manual_seed(3)
    for _ in range(10):
        m = tstep(tstate, x, y, gen)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses[0], float(jmetrics["loss"]), rtol=2e-2)
    np.testing.assert_allclose(norms[0], float(jmetrics["grad_norm"]), rtol=0.15)
    assert all(math.isfinite(v) for v in losses + norms)
    assert losses[-1] < losses[0] - 0.1, losses
    # the weight gradients have the parameters' layout and reach every one
    for k, p in model.named_parameters():
        assert p.grad is not None and p.grad.shape == p.shape and torch.isfinite(p.grad).all(), k


def test_int8_train_step_is_seeded():
    _, _, model, images, labels = _models(INT8)
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def run(seed):
        model.load_state_dict(init)
        opt = TO.make_optimizer(model, weight_decay=0.0)
        step = TE.make_finetune_train_step(
            model, opt, TE.FinetuneHParams(num_classes=5, mixup_active=False),
            TS.constant_schedule(1e-3))
        m = step(TE.init_finetune_state(model, opt), _t(images), _t(labels).long(),
                 torch.Generator().manual_seed(seed))
        return float(m["grad_norm"]), {k: v.clone() for k, v in model.state_dict().items()}

    (g1, s1), (g2, s2), (g3, _) = run(0), run(0), run(1)
    assert g1 == g2 and all(torch.equal(s1[k], s2[k]) for k in s1)
    assert g1 != g3  # other rounding bits


@pytest.mark.parametrize("case", ["width 96", "M < 8"])
def test_unsupported_shapes_run_the_exact_layer_bit_for_bit(monkeypatch, case):
    """Where ``supported`` says no (a width that is not a multiple of 128,
    fewer than 8 rows), quant="int8" is the quant="none" model."""
    over = dict(INT8, embed_dim=96, num_heads=2) if case == "width 96" else dict(INT8)
    batch = 8 if case == "width 96" else 1  # 1 image: M = 5 tokens
    _, params, model, images, _ = _models(over, batch=batch)
    calls = _count_calls(monkeypatch, TLay.quant_ops)
    exact = load_flax_params(VisionTransformer(TViTConfig(**dict(over, quant="none")),
                                               device="cpu"), params).eval()
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(_t(images)), exact(_t(images)))
    assert calls == []


def test_quant_none_draws_what_it_drew(monkeypatch):
    """With quant="none" a training forward draws no rounding seed."""
    draws = []
    real = P.draw_seed
    monkeypatch.setattr(P, "draw_seed", lambda g, d: draws.append(1) or real(g, d))
    cfg = TViTConfig(**dict(INT8, quant="none", drop_path_rate=0.1))
    model = VisionTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.train()(torch.randn(8, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    assert draws == []
    model8 = VisionTransformer(TViTConfig(**INT8), device="cpu",
                               generator=torch.Generator().manual_seed(0))
    model8.train()(torch.randn(8, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    assert len(draws) == 4 * INT8["depth"]


def test_full_width_int8_preset_builds_on_meta():
    """``get_preset("beit_base_patch16_224", quant="int8")`` is a model the
    port builds (on the meta device: no memory, no compute) and every trunk
    matmul of it is int8 at batch 128 and 160."""
    cfg = get_preset("beit_base_patch16_224", quant="int8", use_shared_rel_pos_bias=True,
                     init_values=0.1)
    model = VisionTransformer(cfg.replace(depth=1), device="meta")
    assert model.blocks[0].attn.quant == "int8" and model.blocks[0].mlp.fc1.quant == "int8"
    for batch in (128, 160):
        m = batch * (cfg.num_patches + 1)
        for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
            assert TQ.supported(m, k, n) and TQ.supported(m, n, k)


# ---------------------------------------------------------------------------
# repaired faults
# ---------------------------------------------------------------------------

HEAD80 = dict(img_size=32, patch_size=16, embed_dim=160, depth=2, num_heads=2, num_classes=10,
              init_values=0.1, use_shared_rel_pos_bias=True)


def test_head_dim_80_model_runs_and_matches_jax():
    """Head width 80 (the beit_huge_patch16_224 preset's) takes the attention
    kernels (on the CPU their plain versions): forward at rtol 2e-4 / atol
    2e-5 and one train step's loss and grad norm at rtol 1e-4 against the
    JAX model on the same weights (at 2 heads of 80 the JAX model's head
    group cannot fill 128 lanes, so it runs its unfused attention)."""
    jmodel, params, model, images, labels = _models(HEAD80, batch=4)
    assert model.blocks[0].attn.head_dim == 80 and model.blocks[0].attn.use_kernel
    assert not JFA.kernel_supported(2, 80, 5)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(images), deterministic=True))
    model.eval()
    with torch.no_grad():
        out = model(_t(images))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-5)

    hp_kw = dict(num_classes=10, mixup_active=False, label_smoothing=0.1)
    lr = JS.constant_schedule(1e-3)
    tx = JO.make_optimizer(params, lr, weight_decay=0.05)
    state = JE.FinetuneState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros([], jnp.int32))
    jstep = JE.make_finetune_train_step(jmodel, tx, JE.FinetuneHParams(**hp_kw), lr)
    new_state, jmetrics = jstep(state, jnp.asarray(images), jnp.asarray(labels),
                                jax.random.PRNGKey(0))
    opt = TO.make_optimizer(model, weight_decay=0.05)
    tstep = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**hp_kw),
                                        TS.constant_schedule(1e-3))
    m = tstep(TE.init_finetune_state(model, opt), _t(images), _t(labels).long(),
              torch.Generator().manual_seed(0))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    after = flax_to_state_dict(jax.device_get(new_state.params))
    moved = sum(int(not torch.equal(v, flax_to_state_dict(params)[k]))
                for k, v in model.state_dict().items())
    assert moved == len(after)
    # the full preset has that head width and builds
    assert get_preset("beit_huge_patch16_224").head_dim == 80


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py holds the kernels on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [False, True], ids=["nearest", "stochastic"])
def test_qmm_kernel_matches_plain_on_card(cuda_device, sr):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(197, 768, generator=g, device=cuda_device).to(torch.bfloat16)
    wq, ws = TQ.quantize_cols(torch.randn(2304, 768, generator=g, device=cuda_device).t() * 0.05)
    bias = torch.randn(2304, generator=g, device=cuda_device)
    seed = _seed(9).to(cuda_device)
    before = TQ.qmm.launches
    out = TQ.qmm(x, wq, ws, bias, seed, sr, torch.bfloat16)
    assert TQ.qmm.launches == before + 1
    assert torch.equal(out, TQ.qmm_plain(x, wq, ws, bias, seed, sr, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [False, True], ids=["nearest", "stochastic"])
def test_qmm_kernel_takes_a_wide_contraction_on_card(cuda_device, sr):
    """K = 6400, past the 6,272 that K6 took before it streamed the
    contraction; 384 output columns leave half a 256-column tile."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(197, 6400, generator=g, device=cuda_device).to(torch.bfloat16)
    wq, ws = TQ.quantize_cols(torch.randn(384, 6400, generator=g, device=cuda_device).t() * 0.05)
    bias = torch.randn(384, generator=g, device=cuda_device)
    seed = _seed(9).to(cuda_device)
    before = TQ.qmm.launches
    out = TQ.qmm(x, wq, ws, bias, seed, sr, torch.bfloat16)
    assert TQ.qmm.launches == before + 1
    assert torch.equal(out, TQ.qmm_plain(x, wq, ws, bias, seed, sr, torch.bfloat16))


@pytest.mark.cuda
def test_wgrad_kernel_matches_plain_on_card(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(197, 768, generator=g, device=cuda_device).to(torch.bfloat16)
    gr = (torch.randn(197, 2304, generator=g, device=cuda_device) * 0.01).to(torch.bfloat16)
    seed = _seed(9).to(cuda_device)
    before = TQ.wgrad.launches
    out = TQ.wgrad(x, gr, seed)
    assert TQ.wgrad.launches == before + 1
    assert torch.equal(out, TQ.wgrad_plain(x, gr, seed))
