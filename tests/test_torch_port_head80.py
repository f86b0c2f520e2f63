"""PyTorch port: head width 80 (ViT-H, ``beit_huge_patch16_224``) on the
attention kernels, against the JAX package.

The JAX package runs its Pallas kernels at head width 80: its
``kernel_supported`` asks only for a head group g dividing H with g·D a
multiple of 128, which g = 8 meets at H = 8 or 16. The port's kernels K1-K5
are built for head widths 64 and 80 (``KERNEL_HEAD_DIMS``), and its
``Attention.use_kernel`` takes them at both. On CPU tensors the kernels'
wrappers run their plain versions; the JAX side runs its Pallas kernels in
interpret mode (``FA.INTERPRET``), forced onto the streaming route as
tests/test_flash_attention.py forces it (``_FORCE_STREAM``, ``_STREAM_CAPS``)
for K3/K4, the port's threshold lowered in the same fixture. Sizes are
narrow (H = 8, D = 80, so C = 640; N <= 37). Inputs and cotangents are made
with numpy from a seed and handed to both. Forward and lse: rtol 2e-4 /
atol 2e-5; gradients: rtol 1e-3 / atol 1e-4 (tests/test_flash_attention.py
:206, :229); a 2-deep model's logits at the forward's tolerance and one
finetune step's loss and gradient norm at rtol 1e-4.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as FA
from uncertainty_vit_tpu.core.config import ViTConfig
from uncertainty_vit_tpu.core.config import get_preset as jax_preset
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.train import engine_finetune as JE
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.models import registry
from uncertainty_vit_tpu_torch.models.layers import Attention
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils.checkpoint import (
    flax_to_state_dict, import_torch_state_dict, load_flax_params,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

B, H, D = 2, 8, 80
C = H * D
SCALE = D**-0.5
N_FUSED, N_STREAM = 37, 13
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
RTOL, ATOL = 1e-3, 1e-4
# (bias, q/v bias, bounded softmax): every combination for the fused
# forward, three (each flag on and off) for the rest, whose interpret-mode
# references take seconds each to compile
CASES = [(b, q, bd) for b in (True, False) for q in (True, False) for bd in (False, True)]
FEW = [(True, True, False), (True, True, True), (False, False, False)]


def _ids(cases):
    return [f"{'bias' if b else 'no_bias'}-{'qvb' if q else 'no_qvb'}-"
            f"{'bounded' if bd else 'exact'}" for b, q, bd in cases]


ROUTE_CASES = [("fused", *c) for c in CASES] + [("stream", *c) for c in FEW]


@pytest.fixture(autouse=True)
def interpret_mode():
    prev = (FA.INTERPRET, FA.BOUNDED_SCORES, FA._FORCE_STREAM, FA._STREAM_CAPS,
            TFA.BOUNDED_SCORES, TFA.BWD_MAX_N)
    FA.INTERPRET = True
    yield
    (FA.INTERPRET, FA.BOUNDED_SCORES, FA._FORCE_STREAM, FA._STREAM_CAPS,
     TFA.BOUNDED_SCORES, TFA.BWD_MAX_N) = prev


def _route(name):
    """Both packages on the route ``name`` at this file's token counts: the
    fused one at N = 37, the streaming one forced at N = 13 (two query tiles
    of 8, the last ragged). Returns N."""
    if name == "stream":
        FA._FORCE_STREAM, FA._STREAM_CAPS = True, (8,)
        TFA.BWD_MAX_N = 8
        return N_STREAM
    return N_FUSED


def _inputs(n, with_bias=True, with_qvb=True, seed=0):
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
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _leaf(x):
    return None if x is None else torch.from_numpy(x).requires_grad_()


@pytest.mark.parametrize("route,with_bias,with_qvb,bounded", ROUTE_CASES,
                         ids=[f"{c[0]}-{i}" for c, i in zip(ROUTE_CASES,
                                                             _ids([c[1:] for c in ROUTE_CASES]))])
def test_forward_and_lse_match_jax_kernels(route, with_bias, with_qvb, bounded):
    """K1's (fused) and K3's (stream) plain versions at head width 80
    against the JAX Pallas forward of the same route, the lse too."""
    n = _route(route)
    qkv, bias, qvb, _ = _inputs(n, with_bias, with_qvb)
    FA.BOUNDED_SCORES = bounded
    assert FA._route(H, D, n) == route and TFA.route(n) == route
    impl = FA._fwd_impl if route == "fused" else FA._stream_fwd_impl
    seed = jnp.zeros((1,), jnp.int32)
    ref, lse = jax.jit(lambda *x: impl(*x, seed, SCALE, H, 0.0, want_lse=True))(
        _j(qkv), _j(bias), _j(qvb))
    out, got_lse = TFA.fused_qkv_attention(_t(qkv), _t(bias), _t(qvb), None, SCALE, H,
                                           bounded_scores=bounded, want_lse=True)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, n, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_RTOL, atol=FWD_ATOL)
    ref_lse = np.asarray(lse).transpose(0, 1, 3, 2).reshape(B, H, n)
    np.testing.assert_allclose(got_lse.numpy(), ref_lse, rtol=FWD_RTOL, atol=FWD_ATOL)


@pytest.mark.parametrize("route", ["fused", "stream"])
@pytest.mark.parametrize("with_bias,with_qvb,bounded", FEW, ids=_ids(FEW))
def test_grads_match_jax_kernels(route, with_bias, with_qvb, bounded):
    """dqkv, dbias and dqvb of the autograd Function (K2's or K4's plain
    versions from the forward's lse and output) against ``jax.grad``
    through the JAX custom VJP's interpret-mode kernels of the same route."""
    n = _route(route)
    qkv, bias, qvb, g = _inputs(n, with_bias, with_qvb, seed=1)
    FA.BOUNDED_SCORES = bounded
    seed = jnp.zeros((1,), jnp.int32)
    args = [_j(x) for x in (qkv, bias, qvb)]
    argnums = tuple(i for i, a in enumerate(args) if a is not None)

    def f(*x):
        return jnp.sum(FA.fused_qkv_attention(*x, seed, SCALE, H, 0.0) * _j(g))

    ref = jax.jit(jax.grad(f, argnums=argnums))(*args)
    leaves = [_leaf(x) for x in (qkv, bias, qvb)]
    TFA.fused_qkv_attention(*leaves, None, SCALE, H, bounded_scores=bounded).backward(_t(g))
    for i, r in zip(argnums, ref):
        name = ("dqkv", "dbias", "dqvb")[i]
        assert leaves[i].grad.shape == r.shape, name
        np.testing.assert_allclose(leaves[i].grad.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    if with_qvb:
        assert torch.all(leaves[2].grad[1] == 0)


@pytest.mark.parametrize("nq,nk,bounded", [(7, 13, False), (13, 37, True)])
def test_cross_matches_jax_kernels(nq, nk, bounded):
    """K5 (Nq query rows against Nk keys) at head width 80: the forward,
    and dq, dkv, dbias, dqvb against ``jax.vjp`` of the JAX
    ``cross_qkv_attention`` in interpret mode."""
    rs = np.random.RandomState(2)
    q = rs.randn(B, nq, C).astype(np.float32)
    kv = rs.randn(B, nk, 2 * C).astype(np.float32)
    bias = (rs.randn(H, nq, nk) * 0.5).astype(np.float32)
    qvb = (rs.randn(3, C) * 0.3).astype(np.float32)
    qvb[1] = 0.0
    g = rs.randn(B, nq, C).astype(np.float32)
    FA.BOUNDED_SCORES = bounded

    def fwd_and_grads(*x):
        out, vjp = jax.vjp(lambda *y: FA.cross_qkv_attention(*y, SCALE, H, 0.0), *x)
        return out, vjp(_j(g))

    ref, ref_grads = jax.jit(fwd_and_grads)(_j(q), _j(kv), _j(bias), _j(qvb))
    leaves = [_leaf(x) for x in (q, kv, bias, qvb)]
    out = TFA.cross_qkv_attention(*leaves, SCALE, H, bounded_scores=bounded)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    out.backward(_t(g))
    for name, leaf, r in zip(("dq", "dkv", "dbias", "dqvb"), leaves, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_plain_backward_halves_from_jax_lse_match_jax_kernels():
    """K2's plain backward and K4's two plain halves, fed the JAX forward's
    own lse and output, reproduce ``_bwd_impl`` and ``_stream_bwd_impl``."""
    seed = jnp.zeros((1,), jnp.int32)
    for route in ("fused", "stream"):
        n = _route(route)
        qkv, bias, qvb, g = _inputs(n, seed=3)
        FA.BOUNDED_SCORES = False
        fwd, bwd = ((FA._fwd_impl, FA._bwd_impl) if route == "fused"
                    else (FA._stream_fwd_impl, FA._stream_bwd_impl))
        j = [_j(x) for x in (qkv, bias, qvb, g)]
        out, lse = fwd(j[0], j[1], j[2], seed, SCALE, H, 0.0, want_lse=True)
        dqkv, dbias, dqvb = bwd(j[0], j[1], j[2], seed, lse, j[3], SCALE, H, 0.0)
        lse_bhn = _t(np.array(lse).transpose(0, 1, 3, 2).reshape(B, H, n))
        t = [_t(x) for x in (qkv, bias, qvb)]
        got = TFA.fused_qkv_attention_bwd(*t, lse_bhn, _t(g), SCALE, H, out=_t(np.array(out)))
        for name, a, r in zip(("dqkv", "dbias", "dqvb"), got, (dqkv, dbias, dqvb)):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{route} {name}")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

# a 2-deep ViT of ViT-H's head width: 8 heads of 80 (width 640), N = 37
NARROW = dict(img_size=96, patch_size=16, embed_dim=640, depth=2, num_heads=8, num_classes=10,
              init_values=0.1, use_shared_rel_pos_bias=True)


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


@pytest.fixture(scope="module")
def narrow_models():
    """(JAX model, its seeded numpy params, the port's model with the same
    weights loaded strictly, images, labels)."""
    cfg = ViTConfig(**NARROW)
    rs = np.random.RandomState(100)
    images = rs.randn(2, cfg.img_size, cfg.img_size, 3).astype(np.float32)
    labels = (np.arange(2) % cfg.num_classes).astype(np.int32)
    jmodel = JViT(cfg=cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    params = _numpy_params(shapes, 0)
    model = load_flax_params(VisionTransformer(TViTConfig(**NARROW), device="cpu"), params)
    return jmodel, params, model, images, labels


def test_narrow_model_eval_logits_match_jax_with_its_kernel(narrow_models):
    jmodel, params, model, images, _ = narrow_models
    n = (NARROW["img_size"] // NARROW["patch_size"]) ** 2 + 1
    assert FA.kernel_supported(H, D, n) and FA._route(H, D, n) == "fused"
    assert all(blk.attn.head_dim == D and blk.attn.use_kernel for blk in model.blocks)
    ref = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, deterministic=True))(
        params, jnp.asarray(images))
    model.eval()
    with torch.no_grad():
        out = model(_t(images))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_RTOL, atol=FWD_ATOL)


def test_narrow_model_train_step_matches_jax_engine(narrow_models):
    """One finetune step (attention through the autograd Function's plain
    versions) against the JAX engine's step through its interpret-mode
    kernels: loss and gradient norm at rtol 1e-4."""
    jmodel, params, _, images, labels = narrow_models
    model = load_flax_params(VisionTransformer(TViTConfig(**NARROW), device="cpu"), params)
    hp_kw = dict(num_classes=NARROW["num_classes"], mixup_active=False, label_smoothing=0.1)
    lr = JS.constant_schedule(1e-3)
    tx = JO.make_optimizer(params, lr, weight_decay=0.05)
    state = JE.FinetuneState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros([], jnp.int32))
    jstep = JE.make_finetune_train_step(jmodel, tx, JE.FinetuneHParams(**hp_kw), lr)
    _, jmetrics = jstep(state, jnp.asarray(images), jnp.asarray(labels), jax.random.PRNGKey(0))
    opt = TO.make_optimizer(model, weight_decay=0.05)
    tstep = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**hp_kw),
                                        TS.constant_schedule(1e-3))
    launches = TFA.fused_qkv_attention_bwd.launches
    m = tstep(TE.init_finetune_state(model, opt), _t(images), _t(labels).long(),
              torch.Generator().manual_seed(0))
    assert TFA.fused_qkv_attention_bwd.launches == launches  # the CPU runs the plain versions
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jmetrics[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", registry.MODEL_NAMES)
def test_every_preset_takes_the_kernels_as_jax_decides(name):
    """For every registry name the port's ``use_kernel`` is the JAX
    ``kernel_supported(H, D, N)``: true for all of them, ViT-H's head width
    80 included."""
    cfg = get_preset(registry.preset_name(name))
    n = cfg.num_patches + 1
    attn = Attention(cfg.embed_dim, cfg.num_heads, device="meta")
    assert attn.head_dim == cfg.embed_dim // cfg.num_heads
    assert attn.use_kernel == FA.kernel_supported(cfg.num_heads, attn.head_dim, n)
    assert attn.use_kernel and attn.head_dim in TFA.KERNEL_HEAD_DIMS


def test_other_head_widths_stay_on_the_plain_attention():
    """Head widths the JAX package admits but no preset or flag reaches
    (``attn_head_dim`` alone: 32, 96, 128) are not built: such a model takes
    the plain attention, and the wrappers refuse them."""
    for head_dim in (32, 96, 128):
        attn = Attention(512, 8, attn_head_dim=head_dim, device="meta")
        assert FA.kernel_supported(8, head_dim, 197) and not attn.use_kernel
    for num_heads, head_dim in ((12, 64), (16, 80)):
        assert Attention(num_heads * head_dim, num_heads, device="meta").use_kernel


@pytest.mark.filterwarnings("ignore:for .*copying from a non-meta parameter")
def test_vit_h_tree_carries_onto_the_port_model():
    """The full-width ViT-H tree (width 1280, 16 heads of 80; 2 blocks, the
    shapes from ``jax.eval_shape``) maps onto the port model's state dict key
    for key and shape, loads strictly, and ``import_torch_state_dict`` takes
    every entry."""
    jcfg = jax_preset("beit_huge_patch16_224", depth=2, use_shared_rel_pos_bias=True,
                      init_values=0.1)
    shapes = jax.eval_shape(JViT(cfg=jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    carried = flax_to_state_dict(zeros)
    cfg = get_preset("beit_huge_patch16_224", depth=2, use_shared_rel_pos_bias=True,
                     init_values=0.1)
    model = VisionTransformer(cfg, device="meta")
    template = model.state_dict()
    assert {k: tuple(v.shape) for k, v in carried.items()} == {
        k: tuple(v.shape) for k, v in template.items()}
    assert model.blocks[0].attn.head_dim == 80 and model.blocks[0].attn.use_kernel
    load_flax_params(model, zeros)  # strict=True
    state, missing, unused = import_torch_state_dict(carried, template)
    assert missing == [] and unused == [] and set(state) == set(template)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py holds the kernels on the card")
    return torch.device("cuda", 0)


def _card_inputs(dev, n, dtype, sections=3):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(B, n, sections * C, generator=g, device=dev).to(dtype)
    bias = torch.randn(H, n, n, generator=g, device=dev) * 0.5
    gout = torch.randn(B, n, C, generator=g, device=dev).to(dtype)
    return x, bias, gout


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 197, 577])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernels_match_plain_on_card(cuda_device, dtype, n):
    """K1/K2 (N <= 256) and K3/K4 (N = 577) at head width 80 against their
    plain versions: chip_smoke.py's bounds (OUT_TOL, BWD_TOL)."""
    qkv, bias, g = _card_inputs(cuda_device, n, dtype)
    out, lse = TFA.fused_qkv_attention(qkv, bias, None, None, SCALE, H, bounded_scores=False,
                                       want_lse=True)
    ref, ref_lse = TFA.fused_qkv_attention_plain(qkv, bias, None, SCALE, H, bounded_scores=False)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    dqkv, dbias, _ = TFA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, SCALE, H, out=out)
    want = TFA.fused_qkv_attention_bwd_plain(qkv, bias, None, lse, g, SCALE, H, out=out)
    bound = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-5, 1e-4)}[dtype]
    for got, w, b in ((dqkv, want[0], bound[0]), (dbias, want[1], bound[1])):
        err = (got.float() - w.float()).abs().max().item()
        assert err <= b * w.float().abs().max().item()
    # a head width the kernels are not built for is refused
    with pytest.raises(ValueError, match="head_dim 64 or 80"):
        TFA.fused_qkv_attention(torch.zeros(B, n, 3 * 8 * 96, device=cuda_device, dtype=dtype),
                                None, None, None, SCALE, 8)


@pytest.mark.cuda
def test_cross_kernel_matches_plain_on_card(cuda_device):
    """K5 at head width 80: 63 query rows against 577 keys."""
    q, _, g = _card_inputs(cuda_device, 63, torch.bfloat16, sections=1)
    kv = _card_inputs(cuda_device, 577, torch.bfloat16, sections=2)[0]
    bias = torch.randn(H, 63, 577, device=cuda_device) * 0.5
    out, lse = TFA.cross_qkv_attention(q, kv, bias, None, SCALE, H, bounded_scores=False,
                                       want_lse=True)
    ref, _ = TFA.cross_fwd_plain(q, kv, bias, None, SCALE, H, bounded_scores=False)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)
    dq, dkv, _, _ = TFA.cross_qkv_attention_bwd(q, kv, bias, None, lse, g, SCALE, H, out=out)
    rdq, _, c = TFA.cross_bwd_dq_plain(q, kv, bias, None, lse, g, SCALE, H, out=out)
    rdkv = TFA.cross_bwd_dkv_plain(q, kv, bias, None, lse, c, g, SCALE, H)
    for got, w in ((dq, rdq), (dkv, rdkv)):
        assert (got.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()
