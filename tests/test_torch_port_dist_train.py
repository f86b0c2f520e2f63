"""PyTorch port: the dist (mean+covariance) model's train steps against the
JAX package's engines: one stochastic finetune step
(``make_dist_finetune_train_step``), the fused anchor-augment / pos-neg
prep step against the split one, and two stochastic cyclical steps
(``make_cyclical_train_step(stochastic=True)``) with the EMA teacher.

The model is the narrow one of tests/test_dist.py (width 16, depth 2, two
heads, 32×32 images), its weights numpy draws carried across by
``load_flax_params``. The draws of the two frameworks cannot match, so the
steps run at drop-path, dropout and mixup 0 (ROADMAP.md, "Rules of the
round"). Tolerances: the metrics, each parameter after AdamW and the
teacher rtol 1e-3 / atol 1e-4 (the attention's backward tolerance; Adam's
first update moves a weight by about lr, 5e-5 here, so a weight whose tiny
gradient rounds to the other sign lands within 2·lr).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uncertainty_vit_tpu.core.config import ViTConfig as JConfig
from uncertainty_vit_tpu.models import dist_vit as JM
from uncertainty_vit_tpu.train import engine_cyclical as JEC
from uncertainty_vit_tpu.train import engine_finetune_dist as JED
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.models import dist_vit as TM
from uncertainty_vit_tpu_torch.ops.augment import (
    IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD, normalize, to_float,
)
from uncertainty_vit_tpu_torch.train import engine_cyclical as TEC
from uncertainty_vit_tpu_torch.train import engine_finetune_dist as TED
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.train.engine_finetune import init_finetune_state
from uncertainty_vit_tpu_torch.utils import checkpoint as C

TINY = dict(img_size=32, patch_size=16, embed_dim=16, depth=2, num_heads=2, num_classes=5,
            init_values=0.1, use_shared_rel_pos_bias=True, use_abs_pos_emb=False,
            use_flash_attention=False)
STEP = dict(rtol=1e-3, atol=1e-4)
LR = 5e-5


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _draw(shapes, seed):
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if "kernel" in name:
            return (rs.randn(*leaf.shape) / math.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return (0.2 * rs.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _models(cyclical, seed):
    jcls, tcls = ((JM.DistCyclicalViT, TM.DistCyclicalViT) if cyclical
                  else (JM.DistVisionTransformer, TM.DistVisionTransformer))
    jmodel = jcls(cfg=JConfig(**TINY))
    x = jnp.zeros((2, 32, 32, 3))
    args = (x, jnp.zeros((2, 4))) if cyclical else (x,)
    params = _draw(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)["params"], seed)
    model = tcls(ViTConfig(**TINY), device="cpu")
    C.load_flax_params(model, params)
    return jmodel, params, model


def _held(model, jparams, what):
    ref = C.flax_to_state_dict(_np(jparams))
    assert set(ref) == set(model.state_dict())
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=f"{what} {k}", **STEP)


def _triplet(seed=0, b=4):
    rs = np.random.RandomState(seed)
    img = rs.randn(b, 32, 32, 3).astype(np.float32)
    return img, img + 0.05 * rs.randn(*img.shape).astype(np.float32), \
        rs.randn(b, 32, 32, 3).astype(np.float32), (np.arange(b) % 5).astype(np.int64)


def _finetune_pair(seed):
    """(JAX model, params, tx, port model, its optimizer), AdamW with layer
    decay 0.65, weight decay 0.05 and clip 3.0 at a constant lr."""
    jmodel, params, model = _models(False, seed)
    tx = JO.make_optimizer(params, JS.constant_schedule(LR), weight_decay=0.05, clip_grad=3.0,
                           layer_decay=0.65, depth=TINY["depth"])
    opt = TO.make_optimizer(model, weight_decay=0.05, clip_grad=3.0, layer_decay=0.65,
                            depth=TINY["depth"])
    return jmodel, params, tx, model, opt


def test_finetune_step_matches_jax_engine():
    """One step of each engine from the same weights and triplet (mixup off,
    smoothing 0.1, λ_finetuning = λ_pvn = 0.3 so that the Wasserstein term
    moves the weights): loss, ce_loss, wasserstein_loss, class_acc, grad
    norm, lr, then every parameter after AdamW, the cov stream's unused
    qkv weight included (its zero gradient still sees the decay)."""
    jmodel, params, tx, model, opt = _finetune_pair(3)
    img, pos, neg, labels = _triplet()
    jhp = JED.DistFinetuneHParams(num_classes=5, mixup_active=False, lambda_finetuning=0.3,
                                  lambda_pvn=0.3)
    jstate = JED.DistFinetuneState(params=params, opt_state=tx.init(params),
                                   step=jnp.zeros([], jnp.int32))
    jstep = JED.make_dist_finetune_train_step(jmodel, tx, jhp, JS.constant_schedule(LR))
    jstate, jm = jstep(jstate, *map(jnp.asarray, (img, pos, neg, labels)),
                       jax.random.PRNGKey(0))
    hp = TED.DistFinetuneHParams(num_classes=5, mixup_active=False, lambda_finetuning=0.3,
                                 lambda_pvn=0.3)
    state = init_finetune_state(model, opt)
    step = TED.make_dist_finetune_train_step(model, opt, hp, TS.constant_schedule(LR))
    qkv0 = model.blocks[0].attn.cov_qkv.weight.detach().clone()
    m = step(state, *map(torch.from_numpy, (img, pos, neg, labels)),
             torch.Generator().manual_seed(0))
    assert state.step == 1 and set(m) == {"loss", "ce_loss", "wasserstein_loss", "class_acc",
                                          "grad_norm", "lr"}
    for k in ("loss", "ce_loss", "wasserstein_loss", "class_acc", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k, **STEP)
    assert float(m["wasserstein_loss"]) > 0 and m["lr"] == pytest.approx(float(jm["lr"]))
    _held(model, jstate.params, "after the step")
    decayed = qkv0 * (1 - LR * 0.65 ** 2 * 0.05)  # block 0: layer 1 of depth + 2 = 4
    assert torch.equal(model.blocks[0].attn.cov_qkv.weight.detach(), decayed)


def test_fused_prep_step_equals_the_split_step():
    """The step given the raw uint8 triplet with the anchor-augment and
    pos / neg prep hooks equals, to the bit, the step given the same
    triplet transformed beforehand (a deterministic "augmentation", as
    tests/test_dist.py holds the JAX step); the hooks come together or the
    step refuses them."""
    rs = np.random.RandomState(1)
    u8 = [torch.from_numpy(rs.randint(0, 256, (4, 32, 32, 3), dtype=np.uint8)) for _ in range(3)]
    labels = torch.arange(4) % 5

    def prep(x):
        return normalize(to_float(x), IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD)

    hp = TED.DistFinetuneHParams(num_classes=5, mixup_active=False)
    runs = []
    for fused in (True, False):
        _, _, _, model, opt = _finetune_pair(4)
        hooks = dict(aug_fn=lambda g, x, vhw: prep(x), prep_fn=prep) if fused else {}
        step = TED.make_dist_finetune_train_step(model, opt, hp, TS.constant_schedule(1e-3),
                                                 **hooks)
        batch = u8 if fused else [prep(x) for x in u8]
        m = step(init_finetune_state(model, opt), *batch, labels,
                 torch.Generator().manual_seed(0), aug_generator=torch.Generator())
        runs.append((m, model.state_dict()))
    (mf, pf), (ms, ps) = runs
    assert float(mf["loss"]) == float(ms["loss"])
    assert all(torch.equal(pf[k], ps[k]) for k in pf)
    _, _, _, model, opt = _finetune_pair(4)
    with pytest.raises(ValueError, match="together"):
        TED.make_dist_finetune_train_step(model, opt, hp, TS.constant_schedule(1e-3),
                                          aug_fn=lambda g, x, vhw: x)


def test_stochastic_cyclical_steps_match_jax_engine():
    """Two steps of each cyclical engine with stochastic=True from the same
    weights, images and mask: the teacher a second DistCyclicalViT on the
    EMA tensors; target layers (0, 1) with the batch norm and both post
    norms on (the cov targets take the layer norms only); λ_pretraining 0.5.
    The metrics, every parameter and every teacher tensor after each step."""
    jmodel, params, model = _models(True, 6)
    rs = np.random.RandomState(7)
    images = rs.randn(4, 32, 32, 3).astype(np.float32)
    mask = np.zeros((4, 4), np.float32)
    mask[:, 1:3] = 1.0
    mask[0, 0] = 1.0
    kw = dict(target_layers=(0, 1), target_batch_norm=True, post_target_instance_norm=True,
              post_target_layer_norm=True, ema_decay=0.9, ema_decay_init=0.5, ema_start_at=2,
              lambda_pretraining=0.5, stochastic=True)
    tx = JO.make_optimizer(params, JS.constant_schedule(LR), weight_decay=0.05, clip_grad=3.0,
                           depth=TINY["depth"])
    jstate = JEC.CyclicalState(params=params, opt_state=tx.init(params),
                               ema_params=jax.tree_util.tree_map(np.copy, params),
                               step=jnp.zeros([], jnp.int32))
    jstep = JEC.make_cyclical_train_step(jmodel, tx, JEC.CyclicalHParams(**kw),
                                         JS.constant_schedule(LR), donate=False)
    opt = TO.make_optimizer(model, weight_decay=0.05, clip_grad=3.0, depth=TINY["depth"])
    state = TEC.init_cyclical_state(model, opt)
    assert isinstance(state.teacher, TM.DistCyclicalViT)
    step = TEC.make_cyclical_train_step(model, opt, TEC.CyclicalHParams(**kw),
                                        TS.constant_schedule(LR))
    for i in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(mask), jax.random.PRNGKey(0))
        m = step(state, torch.from_numpy(images), torch.from_numpy(mask),
                 torch.Generator().manual_seed(0))
        for k in ("loss", "loss_cyc", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=f"step {i} {k}", **STEP)
        assert float(m["mask_count"]) == float(jm["mask_count"]) == 2.25
        _held(model, jstate.params, f"step {i}")
        ema = C.flax_to_state_dict(_np(jstate.ema_params))
        for k, v in state.model_ema.items():
            np.testing.assert_allclose(v.detach().numpy(), ema[k].numpy(),
                                       err_msg=f"step {i} teacher {k}", **STEP)
    assert float(m["loss"]) > float(m["loss_cyc"])
    with pytest.raises(ValueError, match="gp_layer"):
        TEC.make_cyclical_train_step(model, opt, TEC.CyclicalHParams(stochastic=True,
                                                                     gp_layer=True),
                                     TS.constant_schedule(LR))
