"""PyTorch port: the int8 trunk (``quant="int8"``) at the large presets'
shapes and under a seq group, against the JAX package, on the CPU.

- Under a seq group each rank's int8 layer must equal one process's over
  the whole trunk: the gradients' stochastic rounding draws the bits of the
  unsharded row (a row window, ``ops/philox.py``), and wgrad's column scales
  are a max over the group. One module fixture starts two gloo ranks once
  (``parallel.seq.run_ranks``) and runs every sharded case in them: the
  layer's pieces (scales, int32 sums, dgrad rows), ``int8_dense`` and one
  finetune step of a narrow int8 ViT of 17 tokens split 9 | 8. They are held
  against the same computation in one process (the parent): the bits to the
  bit, the int32 sums added up exactly, dgrad's rows equal, the dequantized
  weight gradients to f32 summation order; and the step against the JAX
  engine on one device at the int8 step's tolerances of
  tests/test_torch_port_quant.py (loss rtol 2e-2, grad norm rtol 0.15: the
  JAX kernels draw other bits).
- The int8 layer decision at ViT-L/16 512's and ViT-H/16 224's trunks on
  meta tensors against the JAX package's ``supported``.
- A narrow int8 model at N = 257 (the streaming attention route) and one of
  8 heads of 80 (width 640: int8 is admitted), eval logits and one train
  step against the JAX model with its int8 kernels in interpret mode,
  jitted (tests/test_torch_port_quant.py's tolerances).

The ranks import this module by name to find their function, so it imports
JAX only inside the fixture ``J``.
"""

import math
import types

import numpy as np
import pytest
import torch

from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.models import layers as TL
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.ops import philox as P
from uncertainty_vit_tpu_torch.ops import quant as TQ
from uncertainty_vit_tpu_torch.parallel import seq
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils.checkpoint import flax_to_state_dict, load_flax_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

# F4's model: every trunk matmul int8 (K and N multiples of 128: qkv 128 →
# 384, proj 128 → 128, fc1 128 → 512, fc2 512 → 128) at the global M = 4 ·
# 17 = 68 tokens, split 9 | 8 over two ranks (36 and 32 rows)
F4 = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, num_classes=5,
          mlp_ratio=4.0, use_flash_attention=False, quant="int8",
          use_shared_rel_pos_bias=True, init_values=0.1)
F4_BATCH = 4
HP = dict(num_classes=5, mixup_active=False, label_smoothing=0.1)
LR = 1e-3
# the layer case: x [B, N, K] of N = 17 tokens, the gradient [B, N, OUT]
OP_B, OP_N, OP_K, OP_OUT = 3, 17, 128, 256
OP_SEED = 0x0123456789ABCDEF
# int8 against JAX (tests/test_torch_port_quant.py): eval logits within 2e-2
# of the largest logit (a LayerNorm ulp can flip an int8 value), the step's
# loss at rtol 2e-2 and its grad norm at rtol 0.15 (other rounding bits)
LOGIT_REL, LOSS_RTOL, GRAD_NORM_RTOL = 2e-2, 2e-2, 0.15
# two ranks against one process. The dequantized weight gradient of a rank
# is f32(acc_r)·sx·sg, summed over the ranks in f32, against f32(Σ acc_r)·
# sx·sg: three roundings of 2⁻²⁴ relative each on the largest share, so
# 1e-6 of the layer's largest |dw| bounds it; the step's loss and grad norm
# likewise (the pooled feature and the attention's dk, dv are f32 sums over
# the group, in another order than one process's). Those last-bit
# differences reach every token's gradient, and a stochastic rounding
# decision that sits within them of its threshold lands on the neighbouring
# int8 value: one such flip of g at (m, n) moves column n of dw, K entries,
# by sx·sg·xq[m] (measured: one flip in the step, blocks.1's qkv, 128 of
# 49,152 entries, its norm by 8.9e-5). So beyond SUM_ORDER_REL at most
# FLIP_FRACTION of a gradient's entries, and its norm within FLIP_NORM_REL.
# Before the repair every trunk gradient differed in 98-100% of its entries
# and by 7e-4 to 2e-2 in norm (CHANGES.md).
SUM_ORDER_REL = 1e-6
FLIP_FRACTION, FLIP_NORM_REL = 1e-2, 1e-3


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules, its Pallas kernels in interpret mode."""
    import jax
    import jax.numpy as jnp

    import uncertainty_vit_tpu.ops.flash_attention as FA
    from uncertainty_vit_tpu.core.config import ViTConfig
    from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
    from uncertainty_vit_tpu.ops import quant as Q
    from uncertainty_vit_tpu.train import engine_finetune, optim, schedules

    prev = (FA.INTERPRET, Q.INTERPRET)
    FA.INTERPRET = Q.INTERPRET = True
    yield types.SimpleNamespace(jax=jax, jnp=jnp, FA=FA, Q=Q, ViTConfig=ViTConfig, ViT=JViT,
                                E=engine_finetune, O=optim, S=schedules)
    FA.INTERPRET, Q.INTERPRET = prev


def _numpy_params(jax, shapes, seed):
    """Seeded numpy values for every leaf of a JAX param-shape tree."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if "kernel" in name:
            return (rs.randn(*leaf.shape) / math.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return (0.2 * rs.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(cfg_kw, n_images, seed):
    rs = np.random.RandomState(seed)
    size = cfg_kw["img_size"]
    images = rs.randn(n_images, size, size, 3).astype(np.float32)
    labels = (np.arange(n_images) % cfg_kw["num_classes"]).astype(np.int64)
    return images, labels


def _jax_params(J, cfg_kw, images, seed):
    shapes = J.jax.eval_shape(J.ViT(cfg=J.ViTConfig(**cfg_kw)).init, J.jax.random.PRNGKey(0),
                              J.jnp.asarray(images))["params"]
    return _numpy_params(J.jax, shapes, seed)


def _port_step(cfg_kw, state, images, labels, group=None):
    """One finetune step of the port's model (tokens split over ``group``)
    from ``state``: loss, grad norm, every gradient and parameter after."""
    model = VisionTransformer(TViTConfig(**cfg_kw), device="cpu", seq_group=group)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    opt = TO.make_optimizer(model, weight_decay=0.0)
    step = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**HP),
                                       TS.constant_schedule(LR))
    m = step(TE.init_finetune_state(model, opt), torch.from_numpy(images),
             torch.from_numpy(labels), torch.Generator().manual_seed(6))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()},
            "params": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}


def _op_inputs():
    rs = np.random.RandomState(22)
    x = rs.randn(OP_B, OP_N, OP_K).astype(np.float32)
    g = (rs.randn(OP_B, OP_N, OP_OUT) * 0.01).astype(np.float32)
    w = (rs.randn(OP_OUT, OP_K) * 0.05).astype(np.float32)
    b = (rs.randn(OP_OUT) * 0.1).astype(np.float32)
    return x, g, w, b


def _layer(x, g, w, b, shard=None):
    """The layer's pieces on x [B, rows, K] and g [B, rows, OUT]: the wgrad
    scales, K7's int32 sums, K6's dgrad, wgrad, and int8_dense's gradients."""
    x, g, w, b = (torch.from_numpy(np.ascontiguousarray(a)) for a in (x, g, w, b))
    seed = torch.tensor([OP_SEED], dtype=torch.int64)
    window = group = None
    if shard is not None:
        window, group = (x.shape[1], shard.start, shard.n, 0), shard.group
    x2, g2 = x.reshape(-1, OP_K), g.reshape(-1, OP_OUT)
    sx, sg = TQ.wgrad_scales(x2, g2, group)
    acc = TQ.wgrad_acc_plain(x2, g2, sx.reciprocal(), sg.reciprocal(), seed, window)
    wtq, wts = TQ.quantize_cols(w)
    dx = TQ.qmm(g2, wtq, wts, None, seed, True, torch.float32, window)
    dw = TQ.wgrad(x2, g2, seed, window, group)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    (TQ.int8_dense(xl, wl, b, seed, shard) * g).sum().backward()
    return {"sx": sx.numpy(), "sg": sg.numpy(), "acc": acc.numpy(), "dx": dx.numpy(),
            "dw": dw.numpy(), "layer_dx": xl.grad.numpy(), "layer_dw": wl.grad.numpy()}


def _rank_cases(group, data):
    """Every sharded case, in one rank of two."""
    torch.set_num_threads(1)
    shard = group.shard(OP_N)
    x, g, w, b = data["ops"]
    rows = slice(shard.start, shard.stop)
    out = {"layer": _layer(x[:, rows], g[:, rows], w, b, shard)}
    images, labels = data["batch"]
    out["step"] = _port_step(F4, data["state"], images, labels, group)
    return out


@pytest.fixture(scope="module")
def f4(J):
    """(inputs, JAX params, each rank's results) of one run of two ranks."""
    images, labels = _batch(F4, F4_BATCH, 7)
    params = _jax_params(J, F4, images, 1)
    data = {"ops": _op_inputs(), "batch": (images, labels),
            "state": {k: v.numpy() for k, v in flax_to_state_dict(params).items()}}
    return data, params, seq.run_ranks(_rank_cases, 2, data, timeout=600.0)


# ---------------------------------------------------------------------------
# the row window's bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, 1])
def test_window_bits_are_the_unsharded_rows(rank):
    """ViT-B/16 384's N = 577 split 289 | 288: under the window (rows,
    start, n) a shard's rows draw the bits, and the uniforms, of the
    unsharded rows b·n + start + r, to the bit, whole and by tiles; without
    a window the bits are those of the matrix's own rows."""
    n, b, cols = 577, 3, 40
    shard = seq.SeqGroup(rank, 2).shard(n)
    rows = shard.stop - shard.start
    assert rows == (289, 288)[rank]
    window = (rows, shard.start, n, 0)
    seed = torch.tensor([OP_SEED], dtype=torch.int64)
    whole = P.quant_bits(seed, b * n, cols).reshape(b, n, cols)[:, shard.start:shard.stop]
    got = P.quant_bits(seed, b * rows, cols, window=window)
    assert torch.equal(got, whole.reshape(-1, cols))
    assert torch.equal(P.quant_uniform(seed, b * rows, cols, window=window),
                       (whole.reshape(-1, cols) >> 8).float() * 2.0**-24)
    for row0, col0, r, c in ((0, 0, 7, 5), (rows - 3, 6, 9, 11), (2 * rows - 1, 3, 2, 37)):
        assert torch.equal(P.quant_bits(seed, r, c, row0=row0, col0=col0, window=window),
                           got[row0:row0 + r, col0:col0 + c])
    assert torch.equal(P.quant_bits(seed, b * n, cols, window=(n, 0, n, 0)),
                       P.quant_bits(seed, b * n, cols))
    # the rank's dgrad quantization is the unsharded one's rows
    x = torch.randn(b, n, 128, generator=torch.Generator().manual_seed(rank))
    xq, s = TQ.quantize_rows(x.reshape(-1, 128), seed, True)
    xq_l, s_l = TQ.quantize_rows(x[:, shard.start:shard.stop].reshape(-1, 128), seed, True,
                                 window)
    assert torch.equal(xq_l, xq.reshape(b, n, 128)[:, shard.start:shard.stop].reshape(-1, 128))
    assert torch.equal(s_l, s.reshape(b, n, 1)[:, shard.start:shard.stop].reshape(-1, 1))


@pytest.mark.parametrize("window", [(0, 0, 5), (3, 3, 5), (5, 0, 9), (4, -1, 9)])
def test_window_that_does_not_lay_out_the_rows_raises(window):
    """12 rows: a window of 0 rows, rows past n, rows that do not divide 12,
    a negative start."""
    seed = torch.tensor([1], dtype=torch.int64)
    with pytest.raises(ValueError):
        TQ.qmm_plain(torch.randn(12, 128), *TQ.quantize_cols(torch.randn(128, 128)), None,
                     seed, True, torch.float32, window)
    with pytest.raises(ValueError):
        TQ.wgrad_acc_plain(torch.randn(12, 128), torch.randn(12, 128), torch.ones(128),
                           torch.ones(128), seed, window)


# ---------------------------------------------------------------------------
# F4: two ranks against one process
# ---------------------------------------------------------------------------

def test_f4_layer_pieces_add_up_to_one_process(f4):
    """Each rank's column scales are the whole trunk's (exact: a max); K7's
    int32 sums of the two ranks add up to one process's exactly; K6's
    stochastic dgrad gives the unsharded rows to the bit; the dequantized
    weight gradients sum to one process's to f32 summation order; and so do
    ``int8_dense``'s gradients."""
    data, _, results = f4
    x, g, w, b = data["ops"]
    one = _layer(x, g, w, b)
    layers = [r["layer"] for r in results]
    for r in layers:
        assert np.array_equal(r["sx"], one["sx"]) and np.array_equal(r["sg"], one["sg"])
    total = sum(r["acc"].astype(np.int64) for r in layers)
    assert np.array_equal(total, one["acc"].astype(np.int64))
    for key in ("dx", "layer_dx"):
        got = np.concatenate([r[key].reshape(OP_B, -1, r[key].shape[-1]) for r in layers], axis=1)
        assert np.array_equal(got, one[key].reshape(got.shape)), key
    for key in ("dw", "layer_dw"):
        got = sum(r[key] for r in layers)
        np.testing.assert_allclose(got, one[key], rtol=0,
                                   atol=SUM_ORDER_REL * np.abs(one[key]).max(), err_msg=key)


def test_f4_two_rank_int8_step_equals_one_process(f4):
    """F4: one finetune step of the int8 model over two ranks (stochastic
    rounding active: seeds from the step's generator) against the same step
    in one process: loss and grad norm at rtol ``SUM_ORDER_REL``; every
    gradient within ``SUM_ORDER_REL`` of its tensor's largest entry but for
    at most ``FLIP_FRACTION`` of its entries, and its norm within
    ``FLIP_NORM_REL`` (a rounding decision on its threshold: see the
    constants); the ranks equal to each other. Before the window and the
    group's scales the ranks drew rank-local bits and scales."""
    data, _, results = f4
    images, labels = data["batch"]
    one = _port_step(F4, data["state"], images, labels)
    ranks = [r["step"] for r in results]
    assert ranks[0]["loss"] == ranks[1]["loss"] and ranks[0]["grad_norm"] == ranks[1]["grad_norm"]
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=SUM_ORDER_REL)
    np.testing.assert_allclose(ranks[0]["grad_norm"], one["grad_norm"], rtol=SUM_ORDER_REL)
    for k, v in one["grads"].items():
        for r in ranks:
            d = np.abs(r["grads"][k] - v)
            off = (d > SUM_ORDER_REL * max(np.abs(v).max(), 1e-30)).mean()
            assert off <= FLIP_FRACTION, (k, off)
            assert np.linalg.norm(d) <= FLIP_NORM_REL * np.linalg.norm(v), k
    for k, v in ranks[0]["params"].items():
        assert np.array_equal(v, ranks[1]["params"][k]), k


def test_f4_two_rank_int8_step_matches_jax(J, f4):
    """The two-rank step against the JAX engine's int8 step on one device on
    the same weights (its kernels in interpret mode see the global trunk):
    loss at rtol 2e-2, grad norm at rtol 0.15 (other rounding bits)."""
    data, params, results = f4
    images, labels = data["batch"]
    jmetrics = _jax_step(J, F4, params, images, labels)
    for r in results:
        np.testing.assert_allclose(r["step"]["loss"], float(jmetrics["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["step"]["grad_norm"], float(jmetrics["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL)


def _jax_step(J, cfg_kw, params, images, labels):
    jax, jnp = J.jax, J.jnp
    jmodel = J.ViT(cfg=J.ViTConfig(**cfg_kw))
    lr = J.S.constant_schedule(LR)
    tx = J.O.make_optimizer(params, lr, weight_decay=0.0)
    state = J.E.FinetuneState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros([], jnp.int32))
    step = J.E.make_finetune_train_step(
        jmodel, tx, J.E.FinetuneHParams(num_patches=jmodel.cfg.num_patches, **HP), lr)
    _, metrics = step(state, jnp.asarray(images), jnp.asarray(labels.astype(np.int32)),
                      jax.random.PRNGKey(3))
    return metrics


# ---------------------------------------------------------------------------
# the layer decision at the large presets
# ---------------------------------------------------------------------------

# (preset, batch, seq group size): ViT-L/16 512 (N = 1025) at eval batch 128
# is M = 131,200 > 131,072, bf16; everything else int8
DECISIONS = [("beit_large_patch16_512", 8, 1), ("beit_large_patch16_512", 16, 1),
             ("beit_large_patch16_512", 64, 1), ("beit_large_patch16_512", 128, 1),
             ("beit_large_patch16_512", 128, 2), ("beit_large_patch16_512", 8, 2),
             ("beit_huge_patch16_224", 32, 1), ("beit_huge_patch16_224", 64, 1),
             ("beit_huge_patch16_224", 32, 2)]


@pytest.mark.parametrize("preset,batch,s", DECISIONS)
def test_int8_decision_at_the_large_presets_is_the_references(preset, batch, s):
    """Each trunk layer (qkv, proj, fc1, fc2; K and N from the preset) is
    int8 exactly where the JAX package's ``supported`` says so for the whole
    [B·N, C] trunk, on every rank of a seq group of ``s``."""
    from uncertainty_vit_tpu.ops import quant as JQ

    cfg = get_preset(preset)
    n, c = cfg.num_patches + 1, cfg.embed_dim
    hidden = int(c * cfg.mlp_ratio)
    layers = [(c, 3 * c), (c, c), (c, hidden), (hidden, c)]
    want = {"beit_large_patch16_512": batch < 128, "beit_huge_patch16_224": True}[preset]
    for rank in range(s):
        shard = None if s == 1 else seq.SeqGroup(rank, s).shard(n)
        rows = n if shard is None else shard.stop - shard.start
        for k, features in layers:
            x = torch.empty(batch, rows, k, device="meta")
            assert TL._use_quant("int8", x, features, shard) \
                == JQ.supported(batch * n, k, features) == want, (rank, k, features)


# ---------------------------------------------------------------------------
# narrow int8 models on the large presets' routes
# ---------------------------------------------------------------------------

# N = 257 (the streaming attention route in both packages); 8 heads of 80
# (ViT-H's head width; width 640 is a multiple of 128, so int8 is admitted)
NARROW = {
    "stream": dict(img_size=64, patch_size=4, embed_dim=128, depth=1, num_heads=2,
                   num_classes=5, mlp_ratio=2.0, quant="int8", use_shared_rel_pos_bias=True,
                   init_values=0.1),
    "head80": dict(img_size=32, patch_size=16, embed_dim=640, depth=1, num_heads=8,
                   num_classes=5, mlp_ratio=2.0, quant="int8", use_shared_rel_pos_bias=True,
                   init_values=0.1),
}
NARROW_BATCH = {"stream": 2, "head80": 4}


@pytest.fixture(scope="module")
def narrow(J):
    """Per model: (cfg, JAX params, images, labels)."""
    out = {}
    for name, cfg_kw in NARROW.items():
        images, labels = _batch(cfg_kw, NARROW_BATCH[name], 3)
        out[name] = (cfg_kw, _jax_params(J, cfg_kw, images, 5), images, labels)
    return out


def _count_int8(monkeypatch):
    calls = []
    real = TQ.int8_dense

    def counted(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real(*args, **kw)

    monkeypatch.setattr(TL.quant_ops, "int8_dense", counted)
    return calls


@pytest.mark.parametrize("name", list(NARROW))
def test_narrow_int8_model_eval_logits_match_jax(J, narrow, monkeypatch, name):
    """Eval logits within 2e-2 of the largest logit of the JAX int8 model's
    (jitted, interpret mode); every trunk layer int8; the route the large
    preset takes (streaming at N = 257, the attention kernels at D = 80)."""
    cfg_kw, params, images, _ = narrow[name]
    n = (cfg_kw["img_size"] // cfg_kw["patch_size"]) ** 2 + 1
    model = load_flax_params(VisionTransformer(TViTConfig(**cfg_kw), device="cpu"), params)
    if name == "stream":
        assert n == 257 and TFA.route(n) == "stream"
    else:
        assert all(blk.attn.head_dim == 80 and blk.attn.use_kernel for blk in model.blocks)
    calls = _count_int8(monkeypatch)
    jmodel = J.ViT(cfg=J.ViTConfig(**cfg_kw))
    ref = np.asarray(J.jax.jit(lambda p, x: jmodel.apply({"params": p}, x, deterministic=True))(
        params, J.jnp.asarray(images)))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(images)).numpy()
    assert len(calls) == 4 * cfg_kw["depth"]
    assert np.isfinite(out).all()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= LOGIT_REL * scale, (np.abs(out - ref).max(), scale)


@pytest.mark.parametrize("name", list(NARROW))
def test_narrow_int8_train_step_matches_jax(J, narrow, name):
    """One finetune step's loss (rtol 2e-2) and grad norm (rtol 0.15)
    against the JAX engine's int8 step on the same weights; every gradient
    finite and of its parameter's shape."""
    cfg_kw, params, images, labels = narrow[name]
    jmetrics = _jax_step(J, cfg_kw, params, images, labels)
    state = {k: v.numpy() for k, v in flax_to_state_dict(params).items()}
    got = _port_step(cfg_kw, state, images, labels)
    np.testing.assert_allclose(got["loss"], float(jmetrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], float(jmetrics["grad_norm"]),
                               rtol=GRAD_NORM_RTOL)
    for k, v in got["grads"].items():
        assert v.shape == state[k].shape and np.isfinite(v).all(), k
