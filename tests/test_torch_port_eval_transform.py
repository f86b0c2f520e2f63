"""PyTorch port: the eval transform (resize the shorter side to
out / crop_pct, centre crop, clip, normalize) against the JAX package's
``eval_transform_batch`` / ``eval_resize_center_crop`` and the finetune
driver's ``_eval_prep``, on seeded uint8 images.

Tolerances: atol 1e-5 before normalizing (both resize in f32 with weights
that agree to an f32 ulp, summed in another order), 5e-5 after (the
division by std ≈ 0.225 scales the difference by up to 4.4).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncertainty_vit_tpu.cli import finetune as JFT
from uncertainty_vit_tpu.ops import augment as JA
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.ops import augment as TA

RESIZED_ATOL = 1e-5
NORMALIZED_ATOL = 5e-5

# (input side, output side, crop_pct, imagenet_default_mean_and_std)
CASES = [
    (32, 224, 0.875, True),   # CIFAR to ViT-B/16 224: upsample 32 → 256, crop 224
    (64, 64, 1.0, True),      # the identity branch of jax.image.resize (256 → 256 skipped)
    (96, 64, 1.0, True),      # downsample: the antialiased (widened) kernel
    (32, 64, 0.875, False),   # the Inception mean / std
    (40, 32, 0.9, True),      # downsample by a ratio that is not an integer
]


def _images(side, seed=0, n=3, width=None):
    rs = np.random.RandomState(seed + side)
    return rs.randint(0, 256, (n, side, width or side, 3)).astype(np.uint8)


@pytest.mark.parametrize("side,out,crop,imagenet", CASES)
def test_eval_transform_matches_jax(side, out, crop, imagenet):
    u8 = _images(side)
    resized = TA.eval_resize_center_crop(TA.to_float(torch.from_numpy(u8)), out, crop)
    want_resized = jax.vmap(lambda im: JA.eval_resize_center_crop(im, out, crop))(
        JA.to_float(jnp.asarray(u8)))
    assert tuple(resized.shape) == (3, out, out, 3) and resized.dtype == torch.float32
    np.testing.assert_allclose(resized.numpy(), np.asarray(want_resized), rtol=0,
                               atol=RESIZED_ATOL)
    got = TA.eval_transform_batch(torch.from_numpy(u8), out, crop, imagenet)
    want = JA.eval_transform_batch(jnp.asarray(u8), out, crop, imagenet)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=NORMALIZED_ATOL)


def test_non_square_images_match_jax():
    """A landscape and a portrait batch: the shorter side sets the scale,
    the other axis is rounded from it, the crop is centred on both."""
    for h, w in ((30, 44), (44, 30)):
        u8 = _images(h, width=w)
        got = TA.eval_resize_center_crop(TA.to_float(torch.from_numpy(u8)), 32, 0.875)
        want = jax.vmap(lambda im: JA.eval_resize_center_crop(im, 32, 0.875))(
            JA.to_float(jnp.asarray(u8)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=RESIZED_ATOL)


def test_one_image_and_the_batch_agree():
    """[H, W, C] and [B, H, W, C] take the same path: each image of a batch
    is the transform of the image alone, to the bit."""
    x = TA.to_float(torch.from_numpy(_images(32)))
    batch = TA.eval_resize_center_crop(x, 48, 0.875)
    for i in range(x.shape[0]):
        assert torch.equal(TA.eval_resize_center_crop(x[i], 48, 0.875), batch[i])


def test_resize_weights_are_jax_s():
    """The host weight matrix against jax.image's compute_weight_mat (the
    bicubic kernel, antialiased) for an upsample, a downsample and an
    equal size: each row sums to 1."""
    from jax._src.image import scale as S

    for n_in, n_out in ((32, 256), (96, 64), (7, 7)):
        got = TA._resize_weights(n_in, n_out)
        want = S.compute_weight_mat(n_in, n_out, n_out / n_in, 0.0, S._fill_keys_cubic_kernel,
                                    True)
        np.testing.assert_allclose(got, np.asarray(want).T, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-6)


def _args(input_size, crop_pct=None, imagenet=True):
    return argparse.Namespace(input_size=input_size, crop_pct=crop_pct,
                              imagenet_default_mean_and_std=imagenet)


@pytest.mark.parametrize("side,input_size,crop_pct,imagenet", [
    (32, 64, None, True),     # resize branch, the driver's default crop 224/256 below 384
    (32, 32, None, True),     # same size: normalize only, no resize
    (32, 32, None, False),
    (48, 32, 0.8, True),
])
def test_eval_prep_matches_the_jax_driver(side, input_size, crop_pct, imagenet):
    """The driver's per-batch preparation: a host uint8 batch onto the
    device, the resize branch when its side differs from --input_size."""
    u8 = _images(side)
    args = _args(input_size, crop_pct, imagenet)
    got = TFT._eval_prep(u8, args, torch.device("cpu"))
    want = JFT._eval_prep(u8, args)
    assert got.device.type == "cpu" and tuple(got.shape) == (3, input_size, input_size, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=NORMALIZED_ATOL)
