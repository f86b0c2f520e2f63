"""PyTorch port: the attention kernels K1-K5 at one head width D against the
JAX package; ``width_tests(d, h)`` builds the tests of
``tests/test_torch_port_head_width_<d>.py``, one file a width, so that the
workers of ``--dist loadfile`` take the widths apart.

The JAX package runs its Pallas kernels at every width D for which a head
group g dividing H has g·D a multiple of 128 (``kernel_supported``); the
port's kernels are built for every multiple of 16 from 32 to 128
(``KERNEL_HEAD_DIMS``). On CPU tensors the port's wrappers run their plain
versions; the JAX side runs its Pallas kernels in interpret mode
(``FA.INTERPRET``), forced onto the streaming route as
tests/test_flash_attention.py forces it (``_FORCE_STREAM``, ``_STREAM_CAPS``)
for K3/K4, the port's threshold lowered in the same fixture. Sizes are
narrow (H heads of D, B = 2, N <= 37, H the fewest for which the JAX route
holds). Inputs and cotangents are made with numpy from a seed and handed to
both. Forward and lse: rtol 2e-4 / atol 2e-5; gradients: rtol 1e-3 / atol
1e-4 (tests/test_flash_attention.py :206, :229); with ``model=True`` a
2-deep model of H heads of D: its logits at the forward's tolerance, one
finetune step's loss and gradient norm at rtol 1e-4, and (at D = 128) the
full-width ViT-B/16 224 tree with 6 heads of 128 carried onto the port's
model. The ``cuda``-marked tests hold the kernels against their plain
versions on the card, and the refusal of a width they are not built for,
and skip without one.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as FA
from uncertainty_vit_tpu.core.config import ViTConfig
from uncertainty_vit_tpu.models import registry as jax_registry
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.train import engine_finetune as JE
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
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

B = 2
N_FUSED, N_STREAM = 37, 13
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
RTOL, ATOL = 1e-3, 1e-4
# (bias, q/v bias, bounded softmax): each flag on and off, whose
# interpret-mode references take seconds each to compile
FEW = [(True, True, False), (True, True, True), (False, False, False)]


def _ids(cases):
    return [f"{'bias' if b else 'no_bias'}-{'qvb' if q else 'no_qvb'}-"
            f"{'bounded' if bd else 'exact'}" for b, q, bd in cases]


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _leaf(x):
    return None if x is None else torch.from_numpy(x).requires_grad_()


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


def width_tests(d: int, h: int, model: bool = False, fused_cases=FEW, cross_cases=None) -> dict:
    """The tests and fixtures of head width ``d`` at ``h`` heads, for a test
    module's globals; with ``model`` also the narrow model's (and at d = 128
    the full-width tree's). ``fused_cases``: the (bias, q/v bias, bounded)
    cases of the fused forward; ``cross_cases``: K5's (Nq, Nk, bounded)
    cases as parameters, or None for one test at (7, 13, exact)."""
    route_cases = [("fused", *f) for f in fused_cases] + [("stream", *f) for f in FEW]
    c = h * d
    scale = d**-0.5
    assert d in TFA.KERNEL_HEAD_DIMS and FA._group_candidates(h, d), (d, h)

    @pytest.fixture(autouse=True)
    def interpret_mode():
        prev = (FA.INTERPRET, FA.BOUNDED_SCORES, FA._FORCE_STREAM, FA._STREAM_CAPS,
                TFA.BOUNDED_SCORES, TFA.BWD_MAX_N)
        FA.INTERPRET = True
        yield
        (FA.INTERPRET, FA.BOUNDED_SCORES, FA._FORCE_STREAM, FA._STREAM_CAPS,
         TFA.BOUNDED_SCORES, TFA.BWD_MAX_N) = prev

    def route_n(name):
        """Both packages on the route ``name``: the fused one at N = 37, the
        streaming one forced at N = 13 (two query tiles of 8, the last
        ragged). Returns N."""
        if name == "stream":
            FA._FORCE_STREAM, FA._STREAM_CAPS = True, (8,)
            TFA.BWD_MAX_N = 8
            return N_STREAM
        return N_FUSED

    def inputs(n, with_bias=True, with_qvb=True, seed=0):
        rs = np.random.RandomState(seed)
        qkv = rs.randn(B, n, 3 * c).astype(np.float32)
        bias = (rs.randn(h, n, n) * 0.5).astype(np.float32) if with_bias else None
        qvb = None
        if with_qvb:
            qvb = (rs.randn(3, c) * 0.3).astype(np.float32)
            qvb[1] = 0.0  # the reference's structurally zero key bias
        g = rs.randn(B, n, c).astype(np.float32)
        return qkv, bias, qvb, g

    @pytest.mark.parametrize("route,with_bias,with_qvb,bounded", route_cases,
                             ids=[f"{r[0]}-{i}" for r, i in
                                  zip(route_cases, _ids([r[1:] for r in route_cases]))])
    def test_forward_and_lse_match_jax_kernels(route, with_bias, with_qvb, bounded):
        """K1's (fused) and K3's (stream) plain versions against the JAX
        Pallas forward of the same route, the lse too."""
        n = route_n(route)
        qkv, bias, qvb, _ = inputs(n, with_bias, with_qvb)
        FA.BOUNDED_SCORES = bounded
        assert FA._route(h, d, n) == route and TFA.route(n) == route
        impl = FA._fwd_impl if route == "fused" else FA._stream_fwd_impl
        seed = jnp.zeros((1,), jnp.int32)
        ref, lse = jax.jit(lambda *x: impl(*x, seed, scale, h, 0.0, want_lse=True))(
            _j(qkv), _j(bias), _j(qvb))
        out, got_lse = TFA.fused_qkv_attention(_t(qkv), _t(bias), _t(qvb), None, scale, h,
                                               bounded_scores=bounded, want_lse=True)
        assert out.dtype == torch.float32 and tuple(out.shape) == (B, n, c)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_RTOL, atol=FWD_ATOL)
        ref_lse = np.asarray(lse).transpose(0, 1, 3, 2).reshape(B, h, n)
        np.testing.assert_allclose(got_lse.numpy(), ref_lse, rtol=FWD_RTOL, atol=FWD_ATOL)

    @pytest.mark.parametrize("route", ["fused", "stream"])
    @pytest.mark.parametrize("with_bias,with_qvb,bounded", FEW, ids=_ids(FEW))
    def test_grads_match_jax_kernels(route, with_bias, with_qvb, bounded):
        """dqkv, dbias and dqvb of the autograd Function (K2's or K4's plain
        versions from the forward's lse and output) against ``jax.grad``
        through the JAX custom VJP's interpret-mode kernels of the same
        route."""
        n = route_n(route)
        qkv, bias, qvb, g = inputs(n, with_bias, with_qvb, seed=1)
        FA.BOUNDED_SCORES = bounded
        seed = jnp.zeros((1,), jnp.int32)
        args = [_j(x) for x in (qkv, bias, qvb)]
        argnums = tuple(i for i, a in enumerate(args) if a is not None)

        def f(*x):
            return jnp.sum(FA.fused_qkv_attention(*x, seed, scale, h, 0.0) * _j(g))

        ref = jax.jit(jax.grad(f, argnums=argnums))(*args)
        leaves = [_leaf(x) for x in (qkv, bias, qvb)]
        TFA.fused_qkv_attention(*leaves, None, scale, h, bounded_scores=bounded).backward(_t(g))
        for i, r in zip(argnums, ref):
            name = ("dqkv", "dbias", "dqvb")[i]
            assert leaves[i].grad.shape == r.shape, name
            np.testing.assert_allclose(leaves[i].grad.numpy(), np.asarray(r), rtol=RTOL,
                                       atol=ATOL, err_msg=name)
        if with_qvb:
            assert torch.all(leaves[2].grad[1] == 0)

    def cross_matches_jax_kernels(nq, nk, bounded):
        """K5 (Nq query rows against Nk keys): the forward, and dq, dkv,
        dbias, dqvb against ``jax.vjp`` of the JAX ``cross_qkv_attention``
        in interpret mode."""
        rs = np.random.RandomState(2)
        q = rs.randn(B, nq, c).astype(np.float32)
        kv = rs.randn(B, nk, 2 * c).astype(np.float32)
        bias = (rs.randn(h, nq, nk) * 0.5).astype(np.float32)
        qvb = (rs.randn(3, c) * 0.3).astype(np.float32)
        qvb[1] = 0.0
        g = rs.randn(B, nq, c).astype(np.float32)
        FA.BOUNDED_SCORES = bounded

        def fwd_and_grads(*x):
            out, vjp = jax.vjp(lambda *y: FA.cross_qkv_attention(*y, scale, h, 0.0), *x)
            return out, vjp(_j(g))

        ref, ref_grads = jax.jit(fwd_and_grads)(_j(q), _j(kv), _j(bias), _j(qvb))
        leaves = [_leaf(x) for x in (q, kv, bias, qvb)]
        out = TFA.cross_qkv_attention(*leaves, scale, h, bounded_scores=bounded)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=FWD_RTOL,
                                   atol=FWD_ATOL)
        out.backward(_t(g))
        for name, leaf, r in zip(("dq", "dkv", "dbias", "dqvb"), leaves, ref_grads):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL,
                                       err_msg=name)

    if cross_cases is None:
        def test_cross_matches_jax_kernels():
            cross_matches_jax_kernels(7, 13, False)
    else:
        @pytest.mark.parametrize("nq,nk,bounded", cross_cases)
        def test_cross_matches_jax_kernels(nq, nk, bounded):
            cross_matches_jax_kernels(nq, nk, bounded)
    test_cross_matches_jax_kernels.__doc__ = cross_matches_jax_kernels.__doc__

    @pytest.mark.parametrize("route", ["fused", "stream"])
    def test_plain_backward_from_jax_lse_matches_jax_kernels(route):
        """K2's plain backward and K4's two plain halves, fed the JAX
        forward's own lse and output, reproduce ``_bwd_impl`` and
        ``_stream_bwd_impl``."""
        seed = jnp.zeros((1,), jnp.int32)
        n = route_n(route)
        qkv, bias, qvb, g = inputs(n, seed=3)
        FA.BOUNDED_SCORES = False
        fwd, bwd = ((FA._fwd_impl, FA._bwd_impl) if route == "fused"
                    else (FA._stream_fwd_impl, FA._stream_bwd_impl))
        j = [_j(x) for x in (qkv, bias, qvb, g)]
        out, lse = jax.jit(lambda *x: fwd(*x, seed, scale, h, 0.0, want_lse=True))(*j[:3])
        dqkv, dbias, dqvb = jax.jit(lambda *x: bwd(*x, scale, h, 0.0))(
            j[0], j[1], j[2], seed, lse, j[3])
        lse_bhn = _t(np.array(lse).transpose(0, 1, 3, 2).reshape(B, h, n))
        t = [_t(x) for x in (qkv, bias, qvb)]
        got = TFA.fused_qkv_attention_bwd(*t, lse_bhn, _t(g), scale, h, out=_t(np.array(out)))
        for name, a, r in zip(("dqkv", "dbias", "dqvb"), got, (dqkv, dbias, dqvb)):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{route} {name}")

    # --- on the card ------------------------------------------------------

    @pytest.fixture
    def cuda_device():
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card; chip_smoke.py phase 30 holds the kernels on the card")
        return torch.device("cuda", 0)

    def card_inputs(dev, n, dtype, sections=3):
        gen = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn(B, n, sections * c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        gout = torch.randn(B, n, c, generator=gen, device=dev).to(dtype)
        return x, bias, gout

    @pytest.mark.cuda
    @pytest.mark.parametrize("n", [37, 197, 577])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
    def test_kernels_match_plain_on_card(cuda_device, dtype, n):
        """K1/K2 (N <= 256) and K3/K4 (N = 577) against their plain
        versions: chip_smoke.py's bounds (OUT_TOL, BWD_TOL)."""
        qkv, bias, g = card_inputs(cuda_device, n, dtype)
        out, lse = TFA.fused_qkv_attention(qkv, bias, None, None, scale, h,
                                           bounded_scores=False, want_lse=True)
        ref, ref_lse = TFA.fused_qkv_attention_plain(qkv, bias, None, scale, h,
                                                     bounded_scores=False)
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
        dqkv, dbias, _ = TFA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out)
        want = TFA.fused_qkv_attention_bwd_plain(qkv, bias, None, lse, g, scale, h, out=out)
        bound = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-5, 1e-4)}[dtype]
        for got, w, b in ((dqkv, want[0], bound[0]), (dbias, want[1], bound[1])):
            err = (got.float() - w.float()).abs().max().item()
            assert err <= b * w.float().abs().max().item()
        # a head width the kernels are not built for: the wrappers refuse it,
        # and so does a model that the reference would run on its kernels
        with pytest.raises(ValueError, match="a multiple of 16 from 32 to 128, got 72"):
            TFA.fused_qkv_attention(torch.zeros(B, n, 3 * 8 * 72, device=cuda_device,
                                                dtype=dtype), None, None, None, scale, 8)
        attn = Attention(16 * 72, 16, device=cuda_device)
        with pytest.raises(NotImplementedError, match="not built for head width 72"):
            attn(torch.zeros(B, n, 16 * 72, device=cuda_device))

    @pytest.mark.cuda
    def test_cross_kernel_matches_plain_on_card(cuda_device):
        """K5: 63 query rows against 577 keys."""
        q, _, g = card_inputs(cuda_device, 63, torch.bfloat16, sections=1)
        kv = card_inputs(cuda_device, 577, torch.bfloat16, sections=2)[0]
        bias = torch.randn(h, 63, 577, device=cuda_device) * 0.5
        out, lse = TFA.cross_qkv_attention(q, kv, bias, None, scale, h, bounded_scores=False,
                                           want_lse=True)
        ref, _ = TFA.cross_fwd_plain(q, kv, bias, None, scale, h, bounded_scores=False)
        torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)
        dq, dkv, _, _ = TFA.cross_qkv_attention_bwd(q, kv, bias, None, lse, g, scale, h, out=out)
        rdq, _, rc = TFA.cross_bwd_dq_plain(q, kv, bias, None, lse, g, scale, h, out=out)
        rdkv = TFA.cross_bwd_dkv_plain(q, kv, bias, None, lse, rc, g, scale, h)
        for got, w in ((dq, rdq), (dkv, rdkv)):
            err = (got.float() - w.float()).abs().max().item()
            assert err <= 2e-2 * w.float().abs().max().item()

    tests = {name: obj for name, obj in locals().items()
             if name.startswith("test_") or name in ("interpret_mode", "cuda_device")}
    if model:
        tests.update(_model_tests(d, h))
    return tests


def _model_tests(d: int, h: int) -> dict:
    """A 2-deep ViT of h heads of d (width h·d, N = 37) against the JAX model
    with its kernel and the JAX engine; at d = 128 the full-width tree."""
    narrow = dict(img_size=96, patch_size=16, embed_dim=h * d, depth=2, num_heads=h,
                  num_classes=10, init_values=0.1, use_shared_rel_pos_bias=True)

    @pytest.fixture(scope="module")
    def narrow_models():
        """(JAX model, its seeded numpy params, the port's model with the
        same weights loaded strictly, images, labels)."""
        cfg = ViTConfig(**narrow)
        rs = np.random.RandomState(100)
        images = rs.randn(2, cfg.img_size, cfg.img_size, 3).astype(np.float32)
        labels = (np.arange(2) % cfg.num_classes).astype(np.int32)
        jmodel = JViT(cfg=cfg)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                jnp.asarray(images))["params"]
        params = _numpy_params(shapes, 0)
        model = load_flax_params(VisionTransformer(TViTConfig(**narrow), device="cpu"), params)
        return jmodel, params, model, images, labels

    def test_narrow_model_eval_logits_match_jax_with_its_kernel(narrow_models):
        jmodel, params, model, images, _ = narrow_models
        n = (narrow["img_size"] // narrow["patch_size"]) ** 2 + 1
        assert FA.kernel_supported(h, d, n) and FA._route(h, d, n) == "fused"
        assert all(blk.attn.head_dim == d and blk.attn.use_kernel for blk in model.blocks)
        ref = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, deterministic=True))(
            params, jnp.asarray(images))
        model.eval()
        with torch.no_grad():
            out = model(_t(images))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_RTOL, atol=FWD_ATOL)

    def test_narrow_model_train_step_matches_jax_engine(narrow_models):
        """One finetune step (attention through the autograd Function's
        plain versions) against the JAX engine's step through its
        interpret-mode kernels: loss and gradient norm at rtol 1e-4."""
        jmodel, params, _, images, labels = narrow_models
        model = load_flax_params(VisionTransformer(TViTConfig(**narrow), device="cpu"), params)
        hp_kw = dict(num_classes=narrow["num_classes"], mixup_active=False, label_smoothing=0.1)
        lr = JS.constant_schedule(1e-3)
        tx = JO.make_optimizer(params, lr, weight_decay=0.05)
        state = JE.FinetuneState(params=params, opt_state=tx.init(params),
                                 step=jnp.zeros([], jnp.int32))
        jstep = JE.make_finetune_train_step(jmodel, tx, JE.FinetuneHParams(**hp_kw), lr)
        _, jmetrics = jstep(state, jnp.asarray(images), jnp.asarray(labels),
                            jax.random.PRNGKey(0))
        opt = TO.make_optimizer(model, weight_decay=0.05)
        tstep = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**hp_kw),
                                            TS.constant_schedule(1e-3))
        launches = TFA.fused_qkv_attention_bwd.launches
        m = tstep(TE.init_finetune_state(model, opt), _t(images), _t(labels).long(),
                  torch.Generator().manual_seed(0))
        assert TFA.fused_qkv_attention_bwd.launches == launches  # the CPU runs the plain versions
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jmetrics[k]), rtol=1e-4, err_msg=k)

    tests = {"narrow_models": narrow_models,
             "test_narrow_model_eval_logits_match_jax_with_its_kernel":
                 test_narrow_model_eval_logits_match_jax_with_its_kernel,
             "test_narrow_model_train_step_matches_jax_engine":
                 test_narrow_model_train_step_matches_jax_engine}
    if d != 128:
        return tests

    @pytest.mark.filterwarnings("ignore:for .*copying from a non-meta parameter")
    def test_vit_b_tree_with_heads_of_128_carries_onto_the_port_model():
        """ViT-B/16 224 with 6 heads of 128 through both registries'
        ``create_model(..., num_heads=6)`` (width 768; 2 blocks, the JAX
        shapes from ``jax.eval_shape``): its tree maps onto the port model's
        state dict key for key and shape, loads strictly, and
        ``import_torch_state_dict`` takes every entry."""
        over = dict(num_heads=6, depth=2, use_shared_rel_pos_bias=True, init_values=0.1)
        jmodel, jcfg = jax_registry.create_model("beit_base_patch16_224", **over)
        assert (jcfg.embed_dim, jcfg.num_heads, jcfg.head_dim) == (768, 6, 128)
        assert FA.kernel_supported(6, 128, 197)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 224, 224, 3)))["params"]
        zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
        carried = flax_to_state_dict(zeros)
        model, cfg = registry.create_model("beit_base_patch16_224", device="meta", **over)
        assert (cfg.embed_dim, cfg.num_heads, cfg.head_dim) == (768, 6, 128)
        template = model.state_dict()
        assert {k: tuple(v.shape) for k, v in carried.items()} == {
            k: tuple(v.shape) for k, v in template.items()}
        assert all(blk.attn.head_dim == 128 and blk.attn.use_kernel for blk in model.blocks)
        load_flax_params(model, zeros)  # strict=True
        state, missing, unused = import_torch_state_dict(carried, template)
        assert missing == [] and unused == [] and set(state) == set(template)

    tests["test_vit_b_tree_with_heads_of_128_carries_onto_the_port_model"] = \
        test_vit_b_tree_with_heads_of_128_carries_onto_the_port_model
    return tests
