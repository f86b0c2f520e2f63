"""PyTorch port: what the 384 and 512 presets need beyond the 224 path,
against the JAX package.

- The cross-resolution surgery a 384/512 finetune starts from: the port's
  ``interpolate_pos_embed`` and ``interpolate_rel_pos_table`` against the
  JAX package's on the same numpy arrays (atol 1e-6), and
  ``resize_state_dict`` carrying a low-resolution model's state_dict to a
  higher-resolution model, whose logits are held against the JAX model given
  the parameters its own interpolation functions produce (rtol 1e-4 / atol
  1e-5, the model tests' tolerance).
- The rel-pos index at the 24 × 24 and 32 × 32 windows of the 384 and 512
  presets (exact).
- A 24-deep narrow model (the depth of ViT-L; width 128, 2 heads of 64, 16
  patches + cls = 17 tokens): eval logits and one whole finetune train step
  against the JAX engine, both packages on their large-N attention route
  (the JAX one forced as tests/test_flash_attention.py:185-192 forces it,
  the port's threshold lowered to 8 in the same fixture), tolerances as
  tests/test_torch_port_train.py states them; and the 26 layer-decay scales.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as FA
from uncertainty_vit_tpu.core.config import ViTConfig
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.ops import losses as JL
from uncertainty_vit_tpu.ops import mixup as JM
from uncertainty_vit_tpu.ops import relpos as JR
from uncertainty_vit_tpu.train import engine_finetune as JE
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu.utils import checkpoint as JC
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.ops import relpos as TR
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils import checkpoint as TC

# the 24-deep model: ViT-L's depth at a narrow width
DEEP = dict(img_size=16, patch_size=4, embed_dim=128, depth=24, num_heads=2, num_classes=10,
            init_values=0.1, use_shared_rel_pos_bias=True, use_abs_pos_emb=False)


@pytest.fixture
def stream_routes():
    """Both packages on their large-N attention route at N=17."""
    prev = (FA.INTERPRET, FA.BOUNDED_SCORES, FA._FORCE_STREAM, FA._STREAM_CAPS,
            TFA.BOUNDED_SCORES, TFA.BWD_MAX_N)
    FA.INTERPRET, FA._FORCE_STREAM, FA._STREAM_CAPS = True, True, (8,)
    TFA.BWD_MAX_N = 8
    yield
    (FA.INTERPRET, FA.BOUNDED_SCORES, FA._FORCE_STREAM, FA._STREAM_CAPS,
     TFA.BOUNDED_SCORES, TFA.BWD_MAX_N) = prev


def _numpy_params(shapes, seed):
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


def _jax_model(cfg_kw, seed, batch=2):
    cfg = ViTConfig(**cfg_kw)
    rs = np.random.RandomState(seed + 100)
    images = rs.randn(batch, cfg.img_size, cfg.img_size, 3).astype(np.float32)
    labels = rs.randint(0, cfg.num_classes, size=batch).astype(np.int32)
    jmodel = JViT(cfg=cfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    return jmodel, _numpy_params(shapes, seed), images, labels


# ---------------------------------------------------------------------------
# interpolation across resolutions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dst", [24, 32, 14, 7])
def test_interpolate_pos_embed_matches_jax(dst):
    pos = np.random.RandomState(0).randn(1, 1 + 14 * 14, 24).astype(np.float32)
    ref = JC.interpolate_pos_embed(pos, dst * dst)
    out = TC.interpolate_pos_embed(pos, dst * dst)
    assert out.shape == (1, 1 + dst * dst, 24) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out[:, 0], pos[:, 0])  # the cls slot passes through


def test_bicubic_weights_are_row_stochastic_and_match_torch():
    w = TC._torch_bicubic_weights(14, 32)
    np.testing.assert_allclose(w, JC._torch_bicubic_weights(14, 32), rtol=0, atol=0)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-12)
    grid = torch.randn(1, 3, 14, 14, generator=torch.Generator().manual_seed(0))
    ref = torch.nn.functional.interpolate(grid, size=(32, 32), mode="bicubic",
                                          align_corners=False)
    got = np.einsum("yh,chw,xw->cyx", w, grid[0].double().numpy(), w)
    np.testing.assert_allclose(got, ref[0].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("heads", [12, 16])
@pytest.mark.parametrize("dst", [24, 32])
def test_interpolate_rel_pos_table_matches_jax(dst, heads):
    """The 224 presets' 14 × 14 window to the 384 and 512 presets' windows,
    at ViT-B's and ViT-L's head counts."""
    src_n, dst_n = (2 * 14 - 1) ** 2 + 3, (2 * dst - 1) ** 2 + 3
    table = (np.random.RandomState(1).randn(src_n, heads) * 0.2).astype(np.float32)
    ref = JC.interpolate_rel_pos_table(table, dst_n)
    out = TC.interpolate_rel_pos_table(table, dst_n)
    assert out.shape == (dst_n, heads) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out[-3:], table[-3:])  # the cls entries pass through
    assert TC.interpolate_rel_pos_table(table, src_n) is table


@pytest.mark.parametrize("window", [24, 32])
def test_relpos_index_at_the_large_windows_matches_jax(window):
    ref = JR.relative_position_index((window, window))
    out = TR.relative_position_index((window, window))
    n = window * window + 1
    assert out.shape == (n, n)
    np.testing.assert_array_equal(out, ref)
    assert TR.num_relative_distance((window, window)) == JR.num_relative_distance(
        (window, window)) == (2 * window - 1) ** 2 + 3
    assert out.max() == (2 * window - 1) ** 2 + 2 and out.min() == 0


@pytest.mark.parametrize("preset,window,n", [("beit_base_patch16_384", 24, 577),
                                             ("beit_large_patch16_384", 24, 577),
                                             ("beit_large_patch16_512", 32, 1025)])
def test_large_presets_take_the_stream_route(preset, window, n):
    cfg = get_preset(preset)
    assert cfg.grid_size == (window, window) and cfg.num_patches + 1 == n
    assert cfg.embed_dim // cfg.num_heads in TFA.KERNEL_HEAD_DIMS
    assert TFA.route(n) == "stream"


@pytest.mark.parametrize("rel_pos", ["shared", "per_block"])
def test_state_dict_carried_to_a_higher_resolution_matches_jax(rel_pos):
    """An 8 × 8-window model's parameters carried to a 12 × 12-window model:
    the port interpolates its state_dict, the JAX side its param tree with
    its own functions; logits at the model tests' tolerance."""
    kw = dict(patch_size=4, embed_dim=128, depth=2, num_heads=2, num_classes=10, init_values=0.1,
              use_abs_pos_emb=True, use_shared_rel_pos_bias=rel_pos == "shared",
              use_rel_pos_bias=rel_pos == "per_block")
    _, low_params, _, _ = _jax_model(dict(kw, img_size=32), seed=2)
    jhigh, high_template, images, _ = _jax_model(dict(kw, img_size=48), seed=3)
    low = TC.load_flax_params(VisionTransformer(TViTConfig(**dict(kw, img_size=32)), device="cpu"),
                              low_params)
    high = VisionTransformer(TViTConfig(**dict(kw, img_size=48)), device="cpu")

    state = dict(low.state_dict())
    # a reference checkpoint also holds the index buffers: never loaded
    state["rel_pos_bias.relative_position_index"] = torch.zeros(65, 65, dtype=torch.long)
    resized = TC.resize_state_dict(state, high)
    assert not any("relative_position_index" in k for k in resized)
    assert tuple(resized["pos_embed"].shape) == (1, 145, 128)
    high.load_state_dict(resized, strict=True)

    def carry(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        want = high_template
        for p in path:
            want = want[getattr(p, "key", p)]
        if name == "pos_embed":
            return JC.interpolate_pos_embed(leaf, want.shape[1] - 1)
        if name == "relative_position_bias_table":
            return JC.interpolate_rel_pos_table(leaf, want.shape[0])
        return leaf

    high_params = jax.tree_util.tree_map_with_path(carry, low_params)
    ref = jhigh.apply({"params": high_params}, jnp.asarray(images))
    with torch.no_grad():
        out = high.eval()(torch.from_numpy(images))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    # the same widths at the same resolution pass through untouched
    low_state = low.state_dict()
    same = TC.resize_state_dict(low_state, low)
    assert all(same[k] is v for k, v in low_state.items())


# ---------------------------------------------------------------------------
# the 24-deep model
# ---------------------------------------------------------------------------

def test_layer_decay_scales_at_depth_24_match_jax():
    """26 scales: the embeddings at 0.75²⁵, block i at 0.75^(24 − i), the
    head and the shared rel-pos table at 1."""
    _, params, _, _ = _jax_model(DEEP, seed=0)
    model = TC.load_flax_params(VisionTransformer(TViTConfig(**DEEP), device="cpu"), params)
    ref = TC.flax_leaves_by_torch_key(JO.layer_decay_scales(params, 0.75, 24))
    scales = TO.layer_decay_scales(model, 0.75, 24)
    assert set(scales) == set(ref)
    for k in scales:
        assert scales[k] == pytest.approx(float(ref[k]), rel=1e-12), k
    assert len(set(scales.values())) == 26
    assert scales["cls_token"] == scales["patch_embed.proj.weight"] == 0.75 ** 25
    assert scales["blocks.0.attn.qkv.weight"] == 0.75 ** 24
    assert scales["blocks.23.mlp.fc2.weight"] == 0.75
    assert scales["head.weight"] == scales["rel_pos_bias.relative_position_bias_table"] == 1.0
    opt = TO.make_optimizer(model, weight_decay=0.05, layer_decay=0.75, depth=24)
    assert len({g["lr_scale"] for g in opt.optimizer.param_groups}) == 26


def test_deep_model_eval_logits_match_jax(stream_routes):
    jmodel, params, images, _ = _jax_model(DEEP, seed=1)
    model = TC.load_flax_params(VisionTransformer(TViTConfig(**DEEP), device="cpu"), params)
    assert FA._route(2, 64, 17) == "stream" and TFA.route(17) == "stream"
    # jitted: the interpret-mode kernels run eagerly otherwise, op by op
    ref = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(images))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(images))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_deep_model_train_step_matches_jax_engine(stream_routes):
    """One step of the 24-deep model through the large-N attention route
    (mixup off, label smoothing 0.1, drop-path 0, layer decay 0.75, wd
    0.05): loss and grad norm at rtol 1e-5, grads at rtol 1e-4 / atol 1e-6,
    parameters after the AdamW step at rtol 1e-5 / atol 1e-6 where the
    gradient is above 1e-6 and |Δ| <= lr everywhere (Adam's first update is
    lr·g/(|g| + eps), ill-posed in f32 for tiny g)."""
    jmodel, params, images, labels = _jax_model(DEEP, seed=1)
    model = TC.load_flax_params(VisionTransformer(TViTConfig(**DEEP), device="cpu"), params)
    hp_kw = dict(num_classes=DEEP["num_classes"], mixup_active=False, label_smoothing=0.1)
    lr = JS.cosine_schedule(1e-3, 1e-6, 100)
    tx = JO.make_optimizer(params, lr, weight_decay=0.05, layer_decay=0.75, depth=24)
    state = JE.FinetuneState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros([], jnp.int32))
    jstep = JE.make_finetune_train_step(jmodel, tx, JE.FinetuneHParams(**hp_kw), lr)
    new_state, jmetrics = jstep(state, jnp.asarray(images), jnp.asarray(labels),
                                jax.random.PRNGKey(0))
    targets = JM.one_hot_smooth(jnp.asarray(labels), DEEP["num_classes"], 0.1)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(images), None, deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(1),
                                    "droppath": jax.random.PRNGKey(2)})
        return JL.soft_target_cross_entropy(logits, targets)

    jgrads = TC.flax_to_state_dict(jax.jit(jax.grad(loss_fn))(params))

    opt = TO.make_optimizer(model, weight_decay=0.05, layer_decay=0.75, depth=24)
    tstate = TE.init_finetune_state(model, opt)
    tstep = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**hp_kw),
                                        TS.cosine_schedule(1e-3, 1e-6, 100))
    metrics = tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels).long(),
                    torch.Generator().manual_seed(0))
    for k in ("loss", "grad_norm", "class_acc"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    ref = TC.flax_to_state_dict(jax.device_get(new_state.params))
    for k, v in model.state_dict().items():
        well_posed = jgrads[k].abs() > 1e-6
        np.testing.assert_allclose(v[well_posed].numpy(), ref[k][well_posed].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert (v - ref[k]).abs().max().item() <= 1e-3, k


def test_update_freq_above_1_still_raises():
    """Gradient accumulation is the optimizer's (tests/test_torch_port_cli_7c.py):
    a step asking for update_freq 2 of an optimizer built for 1 still raises."""
    model = VisionTransformer(TViTConfig(**dict(DEEP, depth=1)), device="cpu")
    with pytest.raises(ValueError, match="update_freq"):
        TE.make_finetune_train_step(model, TO.make_optimizer(model),
                                    TE.FinetuneHParams(update_freq=2), TS.constant_schedule(1e-3))
    TE.make_finetune_train_step(model, TO.make_optimizer(model, update_freq=2),
                                TE.FinetuneHParams(update_freq=2), TS.constant_schedule(1e-3))
