"""PyTorch port: model layers and the VisionTransformer against the JAX package.

Parameters are drawn with numpy from a seed into the JAX param tree (its
shapes from ``jax.eval_shape``), moved into the port with
``load_flax_params``, and both models run the same NHWC images. The JAX
side takes the Pallas attention kernel in interpret mode; the port's
``fused_qkv_attention`` runs its plain version on CPU tensors. Logits are
compared in f32 at rtol 1e-4 / atol 1e-5, the tolerance of
tests/test_torch_parity.py:30.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as FA
from uncertainty_vit_tpu.core.config import ViTConfig
from uncertainty_vit_tpu.models.layers import Attention as JAttention
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.utils.checkpoint import export_torch_state_dict
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.models.layers import Attention, drop_path
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.utils.checkpoint import load_flax_params

RTOL, ATOL = 1e-4, 1e-5
BASE = dict(img_size=64, patch_size=16, embed_dim=128, depth=2, num_heads=2,
            num_classes=10, init_values=0.1)


@pytest.fixture(autouse=True)
def interpret_mode():
    prev = (FA.INTERPRET, FA.BOUNDED_SCORES)
    FA.INTERPRET = True
    yield
    FA.INTERPRET, FA.BOUNDED_SCORES = prev


def _numpy_params(shapes, seed):
    """Seeded numpy values for every leaf of a JAX param-shape tree, at
    scales that keep activations and logits O(1)."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if "kernel" in name:
            return (rs.randn(*shape) / math.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)
        return (0.2 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_model_and_params(cfg, images, seed=0):
    model = JViT(cfg=cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    return model, _numpy_params(shapes, seed)


def _images(n=2, size=64, seed=1):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


CASES = {
    "shared_relpos": dict(use_shared_rel_pos_bias=True),
    "block_relpos": dict(use_rel_pos_bias=True),
    "cls_head": dict(use_shared_rel_pos_bias=True, use_mean_pooling=False),
    "shared_relpos_bounded": dict(use_shared_rel_pos_bias=True),
    "layer_weights": dict(use_rel_pos_bias=True, learn_layer_weights=True,
                          layernorm_before_combine=True),
    "no_final_norm": dict(use_shared_rel_pos_bias=True, remove_final_norm=True),
    "linear_classifier": dict(use_shared_rel_pos_bias=True, linear_classifier=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_vit_logits_match_jax(case):
    overrides = dict(BASE, **CASES[case])
    images = _images()
    jmodel, params = _jax_model_and_params(ViTConfig(**overrides), images)
    bounded = case.endswith("bounded")
    FA.BOUNDED_SCORES = bounded
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(images)))

    from uncertainty_vit_tpu_torch.ops import flash_attention as TFA

    prev, TFA.BOUNDED_SCORES = TFA.BOUNDED_SCORES, bounded
    try:
        model = load_flax_params(VisionTransformer(TViTConfig(**overrides)), params).eval()
        with torch.no_grad():
            out = model(torch.from_numpy(images))
    finally:
        TFA.BOUNDED_SCORES = prev
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert np.abs(ref).max() > 0.1  # the comparison is not of near-zero logits
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_plain_attention_config_matches_fused_path():
    """use_flash_attention=False (naive_attention) and True (the kernel's
    plain version on CPU) compute the same logits."""
    cfg = TViTConfig(**BASE, use_shared_rel_pos_bias=True)
    images = _images()
    _, params = _jax_model_and_params(ViTConfig(**BASE, use_shared_rel_pos_bias=True), images)
    fused = load_flax_params(VisionTransformer(cfg), params).eval()
    plain_cfg = cfg.replace(use_flash_attention=False)
    plain = load_flax_params(VisionTransformer(plain_cfg), params).eval()
    with torch.no_grad():
        x = torch.from_numpy(images)
        np.testing.assert_allclose(fused(x).numpy(), plain(x).numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["shared_relpos", "block_relpos", "cls_head", "layer_weights"])
def test_load_flax_params_keys_match_export(case):
    overrides = dict(BASE, **CASES[case])
    _, params = _jax_model_and_params(ViTConfig(**overrides), _images())
    exported = export_torch_state_dict(params)
    model = load_flax_params(VisionTransformer(TViTConfig(**overrides)), params)  # strict
    sd = model.state_dict()
    assert set(sd) == set(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    # the rel-pos index buffers are not part of the checkpoint
    assert all("relative_position_index" not in k for k in sd)


def test_load_flax_params_rejects_unknown_params():
    _, params = _jax_model_and_params(ViTConfig(**BASE), _images())
    params = dict(params, sngp_extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError):
        load_flax_params(VisionTransformer(TViTConfig(**BASE)), params)


def test_attention_module_matches_jax():
    """One Attention layer through the fused kernel path on both sides:
    per-block rel-pos table + a shared bias, nonzero q/v biases."""
    dim, heads, n, b = 128, 2, 10, 3
    window = (3, 3)
    rs = np.random.RandomState(3)
    x = rs.randn(b, n, dim).astype(np.float32)
    shared = (rs.randn(heads, n, n) * 0.3).astype(np.float32)
    jmod = JAttention(dim=dim, num_heads=heads, window_size=window, layer_id=2)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(shared))["params"]
    p = _numpy_params(shapes, seed=4)
    ref = np.asarray(jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(shared)))

    mod = Attention(dim, heads, window_size=window, layer_id=2)
    mod.load_state_dict({
        "qkv.weight": torch.from_numpy(p["qkv_kernel"].T.copy()),
        "q_bias": torch.from_numpy(p["q_bias"]),
        "v_bias": torch.from_numpy(p["v_bias"]),
        "relative_position_bias_table": torch.from_numpy(p["relative_position_bias_table"]),
        "proj.weight": torch.from_numpy(p["proj"]["kernel"].T.copy()),
        "proj.bias": torch.from_numpy(p["proj"]["bias"]),
    }, strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x), torch.from_numpy(shared))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_port_init_is_seeded_and_follows_reference_scales():
    cfg = TViTConfig(**BASE, use_shared_rel_pos_bias=True)
    a = VisionTransformer(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    b = VisionTransformer(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    c = VisionTransformer(cfg, generator=torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight"], c["blocks.0.attn.qkv.weight"])

    _, params = _jax_model_and_params(ViTConfig(**BASE, use_shared_rel_pos_bias=True), _images())
    exported = export_torch_state_dict(params)
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: v.shape for k, v in exported.items()}

    bound = 1.0 / math.sqrt(3 * 16 * 16)  # torch conv default, fan_in = in·p·p
    assert a["patch_embed.proj.weight"].abs().max() <= bound
    assert torch.all(a["blocks.1.gamma_2"] == 0.1)
    assert torch.all(a["rel_pos_bias.relative_position_bias_table"] == 0)
    assert torch.all(a["blocks.0.attn.q_bias"] == 0)
    # trunc_normal(0.02); fix_init rescales proj/fc2 of block i by 1/sqrt(2(i+1))
    qkv_std = a["blocks.0.attn.qkv.weight"].std().item()
    fc2_std = a["blocks.1.mlp.fc2.weight"].std().item()
    head_std = a["head.weight"].std().item()
    assert abs(qkv_std - 0.02) < 0.002
    assert abs(fc2_std - 0.02 / 2.0) < 0.001
    assert abs(head_std - 0.02 * cfg.init_scale) < 0.1 * 0.02 * cfg.init_scale


def test_drop_path_is_per_sample_and_inert_in_eval():
    x = torch.ones(256, 5, 4)
    assert drop_path(x, 0.3, training=False) is x
    y = drop_path(x, 0.3, training=True, generator=torch.Generator().manual_seed(0))
    per_sample = y[:, 0, 0]
    assert torch.all((y == per_sample[:, None, None]))
    kept = per_sample[per_sample != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1.0 / 0.7))
    assert 0.15 < (per_sample == 0).float().mean().item() < 0.45
