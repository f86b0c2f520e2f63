"""PyTorch port: head width 80 (ViT-H, ``beit_huge_patch16_224``) on the
attention kernels, against the JAX package, and the head-width rule.

The JAX package runs its Pallas kernels at head width 80: its
``kernel_supported`` asks only for a head group g dividing H with g·D a
multiple of 128, which g = 8 meets at H = 8 or 16. The port's kernels K1-K5
are built for every multiple of 16 from 32 to 128 (``KERNEL_HEAD_DIMS``),
and its ``Attention.use_kernel`` takes them at each. The kernel and model
tests at H = 8, D = 80 (C = 640, N <= 37) are tests/torch_head_widths.py's,
as for the other widths (test_torch_port_head_width_*.py), here with every
(bias, q/v bias, bounded) case of the fused forward and a second K5 case;
the other tests are this width's and the rule's: every preset against JAX
``kernel_supported``, the built widths and the widths JAX admits outside
them (the model refuses those off the CPU), the CUDA dispatch's constants,
and the full-width ViT-H tree's carry.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as FA
from uncertainty_vit_tpu.core.config import get_preset as jax_preset
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.models import registry
from uncertainty_vit_tpu_torch.models.layers import Attention
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.utils.checkpoint import (
    flax_to_state_dict, import_torch_state_dict, load_flax_params,
)
from torch_head_widths import width_tests
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

# (bias, q/v bias, bounded softmax): every combination for the fused forward
CASES = [(b, q, bd) for b in (True, False) for q in (True, False) for bd in (False, True)]

_tests = width_tests(80, 8, model=True, fused_cases=CASES,
                     cross_cases=[(7, 13, False), (13, 37, True)])
_plain_backward = _tests.pop("test_plain_backward_from_jax_lse_matches_jax_kernels")
globals().update(_tests)


def test_plain_backward_halves_from_jax_lse_match_jax_kernels():
    """K2's plain backward and K4's two plain halves, fed the JAX forward's
    own lse and output, reproduce ``_bwd_impl`` and ``_stream_bwd_impl``
    (the fused route, then the streaming one)."""
    for route in ("fused", "stream"):
        _plain_backward(route)


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


# the widths the kernels are built for, then widths the JAX package admits
# outside that rule (not a multiple of 16, or above 128)
WIDTH_CASES = [*TFA.KERNEL_HEAD_DIMS, 72, 88, 104, 256]


@pytest.mark.parametrize("head_dim", WIDTH_CASES)
def test_head_widths_take_the_kernels_by_the_rule(head_dim):
    """At every built width ``use_kernel`` is true for every head count, and
    equal to JAX ``kernel_supported(H, D, N)`` wherever JAX's head-group
    rule holds. At a width outside the rule ``use_kernel`` is false; where
    JAX's head-group rule holds there (JAX takes its kernels) the forward
    off the CPU raises ``NotImplementedError`` (a meta tensor here; the
    card's in ``test_kernels_match_plain_on_card``) and the CPU runs the
    plain attention; where it fails, JAX runs plain attention too."""
    built = head_dim in TFA.KERNEL_HEAD_DIMS
    assert built == (head_dim % 16 == 0 and 32 <= head_dim <= 128)
    refused = 0
    for num_heads in range(1, 25):
        attn = Attention(512, num_heads, attn_head_dim=head_dim, device="meta")
        assert attn.head_dim == head_dim and attn.use_kernel == built
        jax_rule = bool(FA._group_candidates(num_heads, head_dim))
        assert TFA.reference_takes_kernels(num_heads, head_dim) == jax_rule
        assert attn.unbuilt_kernel == (not built and jax_rule)
        if built and jax_rule:
            for n in (197, 577, 1025):
                want = FA.kernel_supported(num_heads, head_dim, n)
                assert attn.use_kernel == want, (num_heads, n)
        if attn.unbuilt_kernel:
            refused += 1
            assert FA.kernel_supported(num_heads, head_dim, 197), num_heads
            with pytest.raises(NotImplementedError, match=f"not built for head width {head_dim}"):
                attn(torch.zeros(2, 5, 512, device="meta"))
            with TFA.plain_only():
                assert not attn.unbuilt_kernel
    if not built:  # JAX runs its kernels there (16 heads give a group of 16 or 8)
        assert refused and FA.kernel_supported(16, head_dim, 197)
        attn = Attention(64, 16, attn_head_dim=head_dim, device="cpu")
        x = torch.randn(2, 5, 64, generator=torch.Generator().manual_seed(head_dim))
        with torch.no_grad():
            got = attn(x)
            with TFA.plain_only():
                want = attn(x)
        assert attn.unbuilt_kernel and torch.equal(got, want)


def test_kernel_head_dims_rule_is_the_cuda_dispatchs():
    """``KERNEL_HEAD_DIMS`` is csrc/attention_common.cuh's rule: the
    constants ``with_head_dim`` walks (kHeadDimMin, kHeadDimMax,
    kHeadDimStep) are the Python ones."""
    src = (Path(TFA.__file__).resolve().parents[1] / "csrc" / "attention_common.cuh").read_text()
    m = re.search(r"constexpr int kHeadDimMin = (\d+), kHeadDimMax = (\d+), "
                  r"kHeadDimStep = (\d+);", src)
    assert m is not None
    lo, hi, step = map(int, m.groups())
    assert (lo, hi, step) == (TFA.HEAD_DIM_MIN, TFA.HEAD_DIM_MAX, TFA.HEAD_DIM_STEP)
    assert TFA.KERNEL_HEAD_DIMS == tuple(range(lo, hi + 1, step)) == (32, 48, 64, 80, 96, 112, 128)


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
