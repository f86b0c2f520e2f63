"""PyTorch port: the dist (mean+covariance) model's parts against the JAX
package: the five Wasserstein / KL functions and their gradients, the
attention, the block, both models in their call modes (f32 and bf16), the
registry's dist names, the optimizer groups, the checkpoint keys and the
triplet dataset.

The model is the narrow one of tests/test_dist.py (width 16, depth 2, two
heads, 32×32 images at patch 16: N = 5). Weights are numpy draws over the
JAX param tree, carried across by ``load_flax_params``; inputs are numpy
draws. Tolerances: f32 forwards rtol 2e-4 / atol 2e-5, gradients rtol 1e-3
/ atol 1e-4 (the attention tolerances of ROADMAP.md); the losses rtol 1e-5
/ atol 1e-7 and their gradients rtol 1e-4 / atol 1e-6 (f32 sums in another
order); bf16 forwards 3e-2 of the largest value (a bf16 ulp is 2^-8 of a
value, and two streams of two blocks round in between); the dataset bit
for bit.
"""

import contextlib
import math
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uncertainty_vit_tpu.core.config import ViTConfig as JConfig
from uncertainty_vit_tpu.data import datasets as JD
from uncertainty_vit_tpu.data import registry as JR
from uncertainty_vit_tpu.models import dist_vit as JM
from uncertainty_vit_tpu.models import registry as JREG
from uncertainty_vit_tpu.ops import losses as JL
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.utils import checkpoint as JC
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.data import datasets as TD
from uncertainty_vit_tpu_torch.data import registry as TR
from uncertainty_vit_tpu_torch.models import dist_vit as TM
from uncertainty_vit_tpu_torch.models import registry as TREG
from uncertainty_vit_tpu_torch.ops import losses as TL
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.utils import checkpoint as C
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

TINY = dict(img_size=32, patch_size=16, embed_dim=16, depth=2, num_heads=2, num_classes=5,
            init_values=0.1, use_shared_rel_pos_bias=True, use_abs_pos_emb=False,
            use_flash_attention=False)
FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
LOSS = dict(rtol=1e-5, atol=1e-7)
LOSS_GRAD = dict(rtol=1e-4, atol=1e-6)
BF16_REL = 3e-2


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _draw(shapes, seed):
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


def _images(b=3, seed=0):
    return np.random.RandomState(seed + 100).randn(b, 32, 32, 3).astype(np.float32)


def _mask(b=3):
    mask = np.zeros((b, 4), np.float32)
    mask[:, 1] = 1.0
    mask[0, 3] = 1.0
    return mask


def _models(cyclical=False, dtype=torch.float32, seed=0, **overrides):
    """(JAX model, its numpy params, the port's model with those weights)."""
    jcls, tcls = (JM.DistCyclicalViT, TM.DistCyclicalViT) if cyclical else (
        JM.DistVisionTransformer, TM.DistVisionTransformer)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jmodel = jcls(cfg=JConfig(**TINY, **overrides), dtype=jdtype)
    args = (jnp.asarray(_images()),) + ((jnp.asarray(_mask()),) if cyclical else ())
    params = _draw(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)["params"], seed)
    model = tcls(ViTConfig(**TINY, **overrides), dtype, device="cpu")
    C.load_flax_params(model, params)
    return jmodel, params, model


def _close(got, want, what="", **tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=what, **tol)


def _sin_weights(shape):
    return np.asarray(np.sin(np.arange(int(np.prod(shape)), dtype=np.float32)).reshape(shape)
                      + 1.5, np.float32)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

def _loss_inputs(n_args, shape=(6, 8), seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n_args)]


def _positive(a):
    return np.abs(a) + 0.5


LOSS_CASES = {
    # name: (JAX fn, port fn, inputs, keyword arguments)
    "distance": (JL.wasserstein_distance, TL.wasserstein_distance,
                 lambda: [_loss_inputs(1)[0], _positive(_loss_inputs(1, seed=1)[0]),
                          _loss_inputs(1, seed=2)[0], _positive(_loss_inputs(1, seed=3)[0])], {}),
    "pretrain": (JL.wasserstein_pretrain_loss, TL.wasserstein_pretrain_loss,
                 lambda: _loss_inputs(4), dict(lambda_pretraining=0.3)),
    "pretrain_mask": (JL.wasserstein_pretrain_loss, TL.wasserstein_pretrain_loss,
                      lambda: _loss_inputs(4),
                      dict(lambda_pretraining=0.3, mask=np.array([1, 0, 1, 1, 0, 0], np.float32))),
    "finetune": (JL.wasserstein_finetune_loss, TL.wasserstein_finetune_loss,
                 lambda: _loss_inputs(6), dict(lambda_finetuning=0.7, lambda_pvn=0.4)),
    "distance_matmul": (JL.wasserstein_distance_matmul, TL.wasserstein_distance_matmul,
                        lambda: _loss_inputs(4, shape=(2, 3, 5, 8)), {}),
    "kl_matmul": (JL.kl_distance_matmul, TL.kl_distance_matmul,
                  lambda: [_loss_inputs(1, shape=(2, 5, 4))[0],
                           _positive(_loss_inputs(1, shape=(2, 5, 4), seed=1)[0]),
                           _loss_inputs(1, shape=(2, 5, 4), seed=2)[0],
                           _positive(_loss_inputs(1, shape=(2, 5, 4), seed=3)[0])], {}),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_losses_and_their_gradients_match_jax(case):
    """Each function's value and its gradient in every input (of the sum of
    the value times fixed weights) against JAX's; the masked pretrain form
    over rows 0, 2, 3 of 6."""
    jfn, tfn, make, kw = LOSS_CASES[case]
    inputs = make()
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want = jfn(*map(jnp.asarray, inputs), **jkw)
    weights = _sin_weights(np.shape(want))
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a, **jkw) * weights),
                      argnums=tuple(range(len(inputs))))(*map(jnp.asarray, inputs))
    xs = [torch.tensor(v, requires_grad=True) for v in inputs]
    got = tfn(*xs, **tkw)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(np.shape(want))
    _close(got, want, case, **LOSS)
    (got * torch.from_numpy(weights)).sum().backward()
    for i, (x, g) in enumerate(zip(xs, jgrads)):
        _close(x.grad, g, f"{case} d/dinput{i}", **LOSS_GRAD)


def test_maxima_split_their_gradient_over_ties_as_jax():
    """Two rows tie for the maximum distance (and for the maximum loss), in
    the unmasked and the masked pretrain form and in the finetune loss's pos
    term: the gradient through each maximum splits evenly between them, as
    jnp.max's does (torch.max(dim).values would send it all to one)."""
    rs = np.random.RandomState(5)
    a, ca, b, cb = (rs.randn(4, 6).astype(np.float32) for _ in range(4))
    a[2], ca[2], b[2], cb[2] = a[0], ca[0], b[0], cb[0]  # rows 0 and 2 tie
    mask = np.array([1, 1, 1, 0], np.float32)
    for kw, tkw in (({}, {}), ({"mask": jnp.asarray(mask)}, {"mask": torch.from_numpy(mask)})):
        jg = jax.grad(lambda *x: JL.wasserstein_pretrain_loss(*x, 1.0, **kw),
                      argnums=(0, 1, 2, 3))(*map(jnp.asarray, (a, ca, b, cb)))
        xs = [torch.tensor(v, requires_grad=True) for v in (a, ca, b, cb)]
        TL.wasserstein_pretrain_loss(*xs, 1.0, **tkw).backward()
        for x, g in zip(xs, jg):
            _close(x.grad, g, f"pretrain ties {sorted(kw)}", **LOSS_GRAD)
        np.testing.assert_array_equal(xs[0].grad[0].numpy(), xs[0].grad[2].numpy())
    n = [rs.randn(4, 6).astype(np.float32) for _ in range(2)]
    jg = jax.grad(lambda *x: JL.wasserstein_finetune_loss(*x, 1.0, 1.0),
                  argnums=(0, 1))(*map(jnp.asarray, (a, ca, b, cb, *n)))
    xs = [torch.tensor(v, requires_grad=True) for v in (a, ca, b, cb, *n)]
    TL.wasserstein_finetune_loss(*xs, 1.0, 1.0).backward()
    for x, g in zip(xs[:2], jg):
        _close(x.grad, g, "finetune ties", **LOSS_GRAD)


def test_distance_products_run_in_float32_whatever_the_process_set():
    """TF32 on in the process: the distance's two products still run in
    float32 (forward and backward inside models.dvae.f32_scope), and the
    process's setting is left as it was."""
    prev = torch.backends.cuda.matmul.allow_tf32
    seen = []
    scope = TL.f32_scope

    @contextlib.contextmanager
    def watched():
        with scope():
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            yield

    torch.backends.cuda.matmul.allow_tf32 = True
    TL.f32_scope = watched
    try:
        x = [torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(i), requires_grad=True)
             for i in range(4)]
        TL.wasserstein_distance_matmul(*x).sum().backward()
        assert seen == [False] * 4 and torch.backends.cuda.matmul.allow_tf32
    finally:
        TL.f32_scope = scope
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# the attention and the block
# ---------------------------------------------------------------------------

def _block_pair(init_values):
    """The JAX DistBlock and the port's with one set of weights (the block's
    params carried under blocks.0 of a one-block tree)."""
    jblock = JM.DistBlock(dim=16, num_heads=2, init_values=init_values, layer_id=1)
    x = jnp.asarray(np.random.RandomState(7).randn(3, 5, 16).astype(np.float32))
    params = _draw(jax.eval_shape(jblock.init, jax.random.PRNGKey(0), x, x)["params"], 3)
    block = TM.DistBlock(16, 2, init_values=init_values, layer_id=1, device="cpu")
    sd = C.flax_to_state_dict({"blocks_0": params})
    block.load_state_dict({k[len("blocks.0."):]: v for k, v in sd.items()}, strict=True)
    return jblock, params, block


@pytest.mark.parametrize("with_bias", [True, False], ids=["rel_pos_bias", "no_bias"])
def test_attention_matches_jax(with_bias):
    """DistAttention's (mean, cov) and their gradients, with and without a
    rel-pos bias [H, N, N]; the unused cov_qkv weight is a parameter with no
    gradient."""
    jblock, params, block = _block_pair(0.1)
    rs = np.random.RandomState(11)
    x, cx = (rs.randn(3, 5, 16).astype(np.float32) for _ in range(2))
    bias = rs.randn(2, 5, 5).astype(np.float32) if with_bias else None
    jattn = JM.DistAttention(dim=16, num_heads=2, layer_id=1)
    w_m, w_c = _sin_weights((3, 5, 16)), _sin_weights((3, 5, 16))[::-1].copy()

    def jloss(p):
        m, c = jattn.apply({"params": p}, jnp.asarray(x), jnp.asarray(cx),
                           None if bias is None else jnp.asarray(bias))
        return jnp.sum(m * w_m) + jnp.sum(c * w_c), (m, c)

    (_, (jm, jc)), jg = jax.value_and_grad(jloss, has_aux=True)(params["attn"])
    m, c = block.attn(torch.from_numpy(x), torch.from_numpy(cx),
                      None if bias is None else torch.from_numpy(bias), deterministic=True)
    _close(m, jm, "mean", **FWD)
    _close(c, jc, "cov", **FWD)
    assert float(c.detach().amin()) != float(m.detach().amin())
    ((m * torch.from_numpy(w_m)).sum() + (c * torch.from_numpy(w_c)).sum()).backward()
    ref = {k[len("blocks.0.attn."):]: v
           for k, v in C.flax_to_state_dict({"blocks_0": {"attn": _np(jg)}}).items()}
    for k, p in block.attn.named_parameters():
        if k == "cov_qkv.weight":
            assert p.grad is None and float(ref[k].abs().max()) == 0.0
        else:
            _close(p.grad, ref[k], k, **GRAD)


@pytest.mark.parametrize("init_values", [0.1, None], ids=["layer_scale", "no_layer_scale"])
def test_block_matches_jax(init_values):
    """DistBlock's two streams, with and without layer scale (its γ under
    the reference's names gamma_1 / gamma_2, or none), and the gradients."""
    jblock, params, block = _block_pair(init_values)
    rs = np.random.RandomState(12)
    x, cx = (rs.randn(3, 5, 16).astype(np.float32) for _ in range(2))
    w = _sin_weights((3, 5, 16))

    def jloss(p):
        m, c = jblock.apply({"params": p}, jnp.asarray(x), jnp.asarray(cx))
        return jnp.sum(m * w) + jnp.sum(c * c), (m, c)

    (_, (jm, jc)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    m, c = block(torch.from_numpy(x), torch.from_numpy(cx), deterministic=True)
    _close(m, jm, "mean", **FWD)
    _close(c, jc, "cov", **FWD)
    ((m * torch.from_numpy(w)).sum() + (c * c).sum()).backward()
    ref = {k[len("blocks.0."):]: v for k, v in C.flax_to_state_dict({"blocks_0": _np(jg)}).items()}
    names = {k for k, _ in block.named_parameters()}
    assert ("gamma_1" in names) == (init_values is not None)
    for k, p in block.named_parameters():
        if k != "attn.cov_qkv.weight":
            _close(p.grad, ref[k], k, **GRAD)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pooling", ["mean", "cls", "linear_classifier"])
def test_finetune_model_and_gradients_match_jax(pooling):
    """DistVisionTransformer's (mean pooled, cov pooled, logits) with mean
    pooling (fc_norm), cls pooling (norm) and fc_norm without affine
    (linear_classifier); the gradients of every parameter."""
    overrides = {"mean": {}, "cls": {"use_mean_pooling": False},
                 "linear_classifier": {"linear_classifier": True}}[pooling]
    jmodel, params, model = _models(**overrides)
    x = _images()

    def jloss(p):
        m, c, lg = jmodel.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(lg * _sin_weights(lg.shape)) + jnp.sum(m * c), (m, c, lg)

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    got = model(torch.from_numpy(x), deterministic=True)
    for g, w, what in zip(got, want, ("mean", "cov", "logits")):
        _close(g, w, what, **FWD)
    assert got[2].dtype == torch.float32 and tuple(got[2].shape) == (3, 5)
    m, c, lg = got
    ((lg * torch.from_numpy(_sin_weights(tuple(lg.shape)))).sum() + (m * c).sum()).backward()
    ref = C.flax_to_state_dict(_np(jg))
    assert set(ref) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        if k.endswith("cov_qkv.weight"):
            assert p.grad is None
        else:
            _close(p.grad, ref[k], k, **GRAD)


@pytest.mark.parametrize("mode", ["teacher", "student", "unmasked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cyclical_model_modes_match_jax(mode, dtype):
    """DistCyclicalViT's three call modes: the teacher's layer_results
    (every block's mean and cov outputs without cls), the masked student
    through norm → lm_head / cov_lm_head, and the unmasked forward; in f32
    and in bf16 compute (JAX's DistCyclicalViT at bfloat16 on the same
    weights); the f32 student's gradients too."""
    jmodel, params, model = _models(cyclical=True, dtype=dtype, seed=1)
    x, mask = _images(), _mask()
    jmask = None if mode != "student" else jnp.asarray(mask)
    tmask = None if mode != "student" else torch.from_numpy(mask)
    kw = {"layer_results": "end"} if mode == "teacher" else {}
    want = jmodel.apply({"params": params}, jnp.asarray(x), jmask, **kw)
    got = model(torch.from_numpy(x), tmask, deterministic=True, **kw)
    flat_w = [t for ts in want for t in ts] if mode == "teacher" else list(want)
    flat_g = [t for ts in got for t in ts] if mode == "teacher" else list(got)
    assert len(flat_g) == len(flat_w) == (2 * TINY["depth"] if mode == "teacher" else 2)
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        assert tuple(g.shape) == (3, 4, 16) and g.dtype == dtype
        if dtype == torch.float32:
            _close(g, w, f"{mode} {i}", **FWD)
        else:
            err = np.abs(g.float().detach().numpy() - np.asarray(w, np.float32)).max()
            assert err <= BF16_REL * np.abs(np.asarray(w, np.float32)).max(), (mode, i, err)
    if mode == "student" and dtype == torch.float32:
        def jloss(p):
            m, c = jmodel.apply({"params": p}, jnp.asarray(x), jmask)
            return jnp.sum(m * _sin_weights(m.shape)) + jnp.sum(c * c)

        jg = C.flax_to_state_dict(_np(jax.grad(jloss)(params)))
        m, c = got
        ((m * torch.from_numpy(_sin_weights(tuple(m.shape)))).sum() + (c * c).sum()).backward()
        for k, p in model.named_parameters():
            if not k.endswith("cov_qkv.weight"):
                _close(p.grad, jg[k], k, **GRAD)
    if mode == "unmasked":
        masked = model(torch.from_numpy(x), torch.from_numpy(mask), deterministic=True)
        assert not torch.allclose(masked[0], got[0])


def test_parameters_sit_at_the_top_under_the_reference_names():
    """The trunk's modules at the top level (not under a backbone prefix),
    each of the cov stream's under its reference name; the fc_norm of the
    finetune model, norm / lm_head / cov_lm_head and the mask tokens of the
    cyclical one; "fc" layer results raise."""
    model = TM.DistVisionTransformer(ViTConfig(**TINY), device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    assert {k.split(".")[0] for k in model.state_dict()} == {
        "patch_embed", "cov_patch_embed", "cls_token", "cov_cls_token", "rel_pos_bias", "blocks",
        "fc_norm", "head"}
    cyc = TM.DistCyclicalViT(ViTConfig(**TINY), device="cpu")
    assert {k.split(".")[0] for k in cyc.state_dict()} == {
        "patch_embed", "cov_patch_embed", "cls_token", "cov_cls_token", "mask_token",
        "cov_mask_token", "rel_pos_bias", "blocks", "norm", "lm_head", "cov_lm_head"}
    assert {k for k in cyc.state_dict() if k.startswith("blocks.0.attn.")} == {
        f"blocks.0.attn.{k}" for k in ("qkv.weight", "cov_qkv.weight", "q_bias", "v_bias",
                                       "cov_q_bias", "cov_v_bias", "proj.weight", "proj.bias",
                                       "cov_proj.weight", "cov_proj.bias")}
    with pytest.raises(ValueError, match="post-MLP"):
        cyc(torch.zeros(1, 32, 32, 3), None, layer_results="fc")


def test_registry_builds_the_dist_models_as_jax():
    """dist_beit_base_patch16_224: DistVisionTransformer in the finetune
    family, DistCyclicalViT in the cyclical one (head "none"), the configs
    equal to the JAX registry's (1 deep, on the meta device)."""
    for family, jcls, tcls in ((None, JM.DistVisionTransformer, TM.DistVisionTransformer),
                               ("cyclical", JM.DistCyclicalViT, TM.DistCyclicalViT)):
        model, cfg = TREG.create_model("dist_beit_base_patch16_224", family, depth=1,
                                       device="meta")
        jmodel, jcfg = JREG.create_model("dist_beit_base_patch16_224", family, depth=1)
        assert isinstance(model, tcls) and isinstance(jmodel, jcls) and len(model.blocks) == 1
        assert ({f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
                == {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    assert TREG.create_model("dist_beit_base_patch16_224", "cyclical", depth=1,
                             device="meta")[1].head_type == "none"


@pytest.mark.parametrize("cyclical", [False, True], ids=["finetune", "cyclical"])
def test_optimizer_groups_match_jax(cyclical):
    """layer_decay_scales and weight_decay_mask of the dist model against
    JAX's, leaf by leaf through flax_leaves_by_torch_key: cov_cls_token,
    cov_mask_token and cov_patch_embed in the top layer (JAX's
    vit_layer_id matches neither name), cov_cls_token decayed."""
    _, params, model = _models(cyclical=cyclical)
    jmask = C.flax_leaves_by_torch_key(JO.weight_decay_mask(params))
    jscale = C.flax_leaves_by_torch_key(JO.layer_decay_scales(params, 0.65, TINY["depth"]))
    tmask, tscale = TO.weight_decay_mask(model), TO.layer_decay_scales(model, 0.65, TINY["depth"])
    assert set(tmask) == set(jmask) == set(tscale) == set(jscale)
    for k in tmask:
        assert tmask[k] == bool(jmask[k]), k
        assert tscale[k] == pytest.approx(float(jscale[k]), rel=1e-7), k
    assert tscale["cov_cls_token"] == tscale["cov_patch_embed.proj.weight"] == 1.0
    assert tscale["patch_embed.proj.weight"] == pytest.approx(0.65**3)
    assert tmask["cov_cls_token"] and not tmask["cls_token"]
    if cyclical:
        assert tscale["cov_mask_token"] == 1.0 and tscale["mask_token"] == pytest.approx(0.65**3)


@pytest.mark.parametrize("cyclical", [False, True], ids=["finetune", "cyclical"])
def test_pth_round_trip_with_jax_export(cyclical, tmp_path):
    """JAX's export_torch_state_dict of the dist tree loads into the port's
    model strictly (every key, the cov_* ones included), and the port's
    import of that .pth gives what JAX's import_torch_params gives: no key
    missing or unused, the same weights."""
    jmodel, params, model = _models(cyclical=cyclical, seed=2)
    sd = JC.export_torch_state_dict(params)
    assert {k for k in sd if "cov_" in k} >= {"cov_patch_embed.proj.weight", "cov_cls_token",
                                               "blocks.1.attn.cov_qkv.weight",
                                               "blocks.1.attn.cov_q_bias",
                                               "blocks.1.attn.cov_proj.bias"}
    path = str(tmp_path / "dist.pth")
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}},
               path)
    fresh = (TM.DistCyclicalViT if cyclical else TM.DistVisionTransformer)(
        ViTConfig(**TINY), device="cpu")
    state, missing, unused = C.import_torch_state_dict(C.load_torch_state_dict(path),
                                                       fresh.state_dict())
    fresh.load_state_dict(state, strict=True)
    _, jmissing, junused = JC.import_torch_params(JC.load_torch_state_dict(path), params)
    assert missing == [] == jmissing and unused == [] == junused
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# the triplet dataset
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cifar")
    rs = np.random.RandomState(0)
    base = root / "cifar-100-python"
    base.mkdir()
    for split, n in (("train", 240), ("test", 12)):
        with open(base / split, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (n, 3072), dtype=np.uint8),
                         b"fine_labels": rs.permutation(np.arange(n) % 100).tolist()}, f)
    return str(root)


def test_triplet_dataset_equals_jax(cifar_root):
    """TripletDataset over the same base and seed: (img, pos, neg, label)
    bit for bit over a sequence of indices that revisits some (each item's
    negative is the next draw of the seeded stream), each negative of
    another class, pos a copy."""
    base_t = TD.load_cifar(cifar_root, cifar100=True, train=True)
    base_j = JD.load_cifar(cifar_root, cifar100=True, train=True)
    got, want = TD.TripletDataset(base_t, seed=4), JD.TripletDataset(base_j, seed=4)
    assert len(got) == len(want) == 240
    np.testing.assert_array_equal(got.labels, want.labels)
    order = np.random.RandomState(9).randint(0, 40, 60)
    for i in order:
        a, b = got[int(i)], want[int(i)]
        assert len(a) == len(b) == 4 and a[3] == b[3]
        for u, v in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(u, v)
        assert a[1] is not a[0] and np.array_equal(a[1], a[0])
        neg_label = [j for j in range(240) if np.array_equal(base_t[j][0], a[2])]
        assert all(base_t.labels[j] != a[3] for j in neg_label)
    # set_epoch restarts the stream: epoch 0 is the JAX dataset's from its
    # seed, epoch 1 one of its own, the same on every restart
    fresh = JD.TripletDataset(base_j, seed=4)
    draws = {}
    for epoch in (0, 1, 1):
        got.set_epoch(epoch)
        draws.setdefault(epoch, []).append([got[int(i)][2] for i in order[:20]])
    want0 = [fresh[int(i)][2] for i in order[:20]]
    assert all(np.array_equal(u, v) for u, v in zip(draws[0][0], want0))
    assert all(np.array_equal(u, v) for u, v in zip(*draws[1]))
    assert not all(np.array_equal(u, v) for u, v in zip(draws[0][0], draws[1][0]))


@pytest.mark.parametrize("ratio", [0.0, 0.5], ids=["whole", "ssl_split"])
def test_build_dataset_triplet_equals_jax(cifar_root, ratio):
    """build_dataset(triplet=True) wraps after the SSL split, as JAX's
    does: the same items and negatives over the whole train set in order,
    and the loader's 4-column batches (num_workers 0) bit for bit."""
    from uncertainty_vit_tpu.data import pipeline as JP
    from uncertainty_vit_tpu_torch.data import pipeline as TP

    got, nb = TR.build_dataset(True, "CIFAR100", cifar_root, triplet=True, seed=2,
                               semi_supervised_ratio=ratio)
    want, jnb = JR.build_dataset(True, "CIFAR100", cifar_root, triplet=True, seed=2,
                                 semi_supervised_ratio=ratio)
    assert nb == jnb == 100 and isinstance(got, TD.TripletDataset) and len(got) == len(want)
    tl = TP.BatchLoader(got, 8, shuffle=True, seed=2, num_workers=0)
    jl = JP.BatchLoader(want, 8, shuffle=True, seed=2, num_workers=0)
    n = 0
    for tb, jb in zip(tl, jl):
        assert len(tb) == len(jb) == 4 and tb[0].shape == (8, 32, 32, 3)
        for u, v in zip(tb, jb):
            np.testing.assert_array_equal(u, v)
        n += 1
    assert n == len(tl) == len(jl) > 0
