"""PyTorch port: the cyclical (data2vec) model, its checkpoint keys, the
target pipeline and the train step against the JAX package.

``CyclicalViT`` is 3 blocks of width 64 on 64×64 images at patch 16 (a 4×4
grid, N = 17): one head of width 64, so the port takes the attention
kernels' route (K1/K2's plain versions through the autograd Function on CPU
tensors) with the exact softmax, and the JAX package its Pallas kernels in
interpret mode (``FA.INTERPRET``). The weights are numpy draws over the JAX
param tree, carried across by ``load_flax_params`` (with the SNGP
``lm_head``'s collections into its buffers). Tolerances: forwards rtol 2e-4
/ atol 2e-5; the SNGP precision matrix likewise; the train step's loss,
grad norm and the parameters and teacher after each step rtol 1e-3 / atol
1e-4 (the attention tolerances of ROADMAP.md); the targets rtol 1e-5 /
atol 1e-5 (f32 normalizations of the same values).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as JFA
from uncertainty_vit_tpu.core.config import ViTConfig as JConfig
from uncertainty_vit_tpu.models.cyclical import CyclicalViT as JCyclical
from uncertainty_vit_tpu.train import engine_cyclical as JE
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.models.cyclical import CyclicalViT
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.train import engine_cyclical as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils import checkpoint as C

SMALL = dict(img_size=64, patch_size=16, embed_dim=64, depth=3, num_heads=1, init_values=0.1,
             use_shared_rel_pos_bias=True, use_abs_pos_emb=False, head_type="none")
FWD = dict(rtol=2e-4, atol=2e-5)
STEP = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def exact_softmax_interpret():
    prev = (JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = True, False, False
    yield
    JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


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


def _inputs(b=4, seed=0, num_masked=6):
    rs = np.random.RandomState(seed + 100)
    images = rs.randn(b, 64, 64, 3).astype(np.float32)
    mask = np.zeros((b, 16), np.float32)
    for i in range(b):
        mask[i, rs.choice(16, num_masked, replace=False)] = 1.0
    return images, mask


def _models(gp_layer=False, seed=0, **overrides):
    """(JAX model, its variables with numpy params, the port's model with
    those weights)."""
    cfg = JConfig(**SMALL, **overrides)
    jmodel = JCyclical(cfg=cfg, gp_layer=gp_layer)
    images, mask = _inputs()
    # the same variables as jmodel's; the plain attention's init runs no
    # interpreted kernel
    init = JCyclical(cfg=cfg.replace(use_flash_attention=False), gp_layer=gp_layer).init
    variables = _np(init(jax.random.PRNGKey(seed), jnp.asarray(images), jnp.asarray(mask)))
    variables["params"] = _numpy_params(variables["params"], seed)
    model = CyclicalViT(ViTConfig(**SMALL, **overrides), gp_layer=gp_layer, device="cpu")
    C.load_flax_params(model, variables["params"], variables)
    return jmodel, variables, model


def _close(got, want, what="", **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **tol)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_parameters_sit_under_the_reference_names():
    """cls_token, mask_token, patch_embed, rel_pos_bias, blocks, norm,
    lm_head; no pos_embed, fc_norm or head. The backbone's initializers:
    trunc_normal(0.02) bounded at ±0.02 everywhere, the patch embedding's
    weight too, its bias 0."""
    model = CyclicalViT(ViTConfig(**SMALL), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    top = {k.split(".")[0] for k in model.state_dict()}
    assert top == {"cls_token", "mask_token", "patch_embed", "rel_pos_bias", "blocks", "norm",
                   "lm_head"}
    for name in ("cls_token", "mask_token", "patch_embed.proj.weight", "lm_head.weight",
                 "blocks.0.attn.qkv.weight"):
        v = model.state_dict()[name].detach()
        assert float(v.abs().max()) <= 0.02 and float(v.std()) > 0.005, name
    assert float(model.patch_embed.proj.bias.detach().abs().max()) == 0.0
    assert model.mask_token is not None and not model.mask_only_when_training


@pytest.mark.parametrize("layer_results", ["end", "fc"])
def test_teacher_layer_results_match_jax(layer_results):
    """The teacher's call: every layer's activations without cls, unmasked,
    deterministic."""
    jmodel, variables, model = _models()
    images, _ = _inputs()
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, None, layer_results=layer_results,
                                             deterministic=True))(variables["params"],
                                                                  jnp.asarray(images))
    got = model(torch.from_numpy(images), None, deterministic=True, layer_results=layer_results)
    assert len(got) == len(want) == SMALL["depth"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == (4, 16, 64)
        _close(g, w, f"layer {i}", **FWD)


def test_student_with_a_mask_matches_jax():
    """The student's lm_head over all patch tokens with the mask token in
    the masked ones, deterministic (the mask applies whenever it is given),
    and its gradients; the mask changes the output."""
    jmodel, variables, model = _models()
    images, mask = _inputs()

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(images), jnp.asarray(mask),
                           deterministic=True)
        return jnp.sum(out * jnp.sin(jnp.arange(out.size).reshape(out.shape))), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    out = model(torch.from_numpy(images), torch.from_numpy(mask), deterministic=True)
    _close(out, want, "lm_head output", **FWD)
    (out * torch.sin(torch.arange(out.numel()).reshape(out.shape).float())).sum().backward()
    ref = C.flax_to_state_dict(_np(jgrads))
    for k, p in model.named_parameters():
        _close(p.grad, ref[k], k, **STEP)
    unmasked = model(torch.from_numpy(images), None, deterministic=True)
    assert not torch.allclose(unmasked, out)


def test_sngp_lm_head_matches_jax_and_updates_its_precision_matrix():
    """--gp_layer: lm_head is the SNGP head over [B·N, C] (inducing =
    classes = width); one forward with update_sngp_cov moves the precision
    matrix as JAX's mutable 'sngp_state' moves."""
    jmodel, variables, model = _models(gp_layer=True)
    images, mask = _inputs()
    want, new_vars = jmodel.apply(variables, jnp.asarray(images), jnp.asarray(mask),
                                  deterministic=True, update_sngp_cov=True,
                                  mutable=["sngp_state"])
    p0 = model.lm_head.precision_matrix.clone()
    got = model(torch.from_numpy(images), torch.from_numpy(mask), deterministic=True,
                update_sngp_cov=True)
    _close(got, want, "SNGP lm_head", **FWD)
    p_want = np.asarray(new_vars["sngp_state"]["lm_head"]["precision_matrix"])
    _close(model.lm_head.precision_matrix, p_want, "precision matrix", **FWD)
    assert not torch.equal(p0, model.lm_head.precision_matrix)
    assert {k for k in model.state_dict() if k.startswith("lm_head.")} == {
        "lm_head._gp_input_normalize_layer.weight", "lm_head._gp_input_normalize_layer.bias",
        "lm_head._random_feature.weight", "lm_head._random_feature.bias",
        "lm_head._gp_output_layer.weight", "lm_head.precision_matrix"}


# ---------------------------------------------------------------------------
# the targets
# ---------------------------------------------------------------------------

NORM_FLAGS = ("target_layer_norm_last", "target_batch_norm", "target_instance_norm",
              "post_target_instance_norm", "post_target_layer_norm")
TARGET_CASES = {"none": {}, **{f: {f: True} for f in NORM_FLAGS[1:]},
                "layer_norm_last": {"target_layer_norm_last": True},
                "all": {f: True for f in NORM_FLAGS}}


@pytest.mark.parametrize("case", list(TARGET_CASES))
def test_build_targets_matches_jax(case):
    """Each norm of the ladder alone (the layer norm of each layer off but
    in its own case) and all together, over layers 1 and 3 of four."""
    flags = dict({f: False for f in NORM_FLAGS}, **TARGET_CASES[case])
    rs = np.random.RandomState(7)
    layers = [(2 * rs.randn(3, 10, 8) + rs.randn(8)).astype(np.float32) for _ in range(4)]
    want = JE.build_targets([jnp.asarray(v) for v in layers],
                            JE.CyclicalHParams(target_layers=(1, 3), **flags))
    got = TE.build_targets([torch.from_numpy(v) for v in layers],
                           TE.CyclicalHParams(target_layers=(1, 3), **flags))
    assert got.dtype == torch.float32
    _close(got, want, case, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

# (hparams, update_freq, steps): the hinge on, an EMA warm-up, a second step;
# and two mini-steps of one update (the teacher still after the first)
STEP_CASES = {
    "hinge_warmup": (dict(var_w0=0.5, var_margin0=4.0, ema_decay=0.9, ema_decay_init=0.5,
                          ema_start_at=2), 1, 2),
    "update_freq_2": (dict(ema_decay=0.9, ema_decay_init=0.9), 2, 2),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax_engine(case):
    """One and two steps of the JAX engine (prep_fn=None, its step jitted
    once) and of the port's from the same weights, images and mask, at
    drop-path and attention dropout 0 and mask dropout off: the loss,
    loss_cyc, loss_var0, grad norm, mask count and lr, then every parameter
    and every teacher tensor after each step. target layers (0, 2) of 3,
    AdamW with clip 3.0 and weight decay 0.05 at lr 5e-5 (Adam's first
    update moves a weight by about lr, so one whose tiny gradient rounds to
    the other sign lands within 2·lr = 1e-4, the tolerance)."""
    kw, update_freq, n_steps = STEP_CASES[case]
    jmodel, variables, model = _models(seed=1)
    params = variables["params"]
    images, mask = _inputs(seed=1)
    jhp = JE.CyclicalHParams(target_layers=(0, 2), update_freq=update_freq, **kw)
    lr = JS.constant_schedule(5e-5)
    tx = JO.make_optimizer(params, lr, weight_decay=0.05, clip_grad=3.0, depth=SMALL["depth"],
                           accum_steps=update_freq)
    jstate = JE.CyclicalState(params=params, opt_state=tx.init(params),
                              ema_params=jax.tree_util.tree_map(np.copy, params),
                              step=jnp.zeros([], jnp.int32))
    jstep = JE.make_cyclical_train_step(jmodel, tx, jhp, lr, donate=False)

    opt = TO.make_optimizer(model, weight_decay=0.05, clip_grad=3.0, depth=SMALL["depth"],
                            update_freq=update_freq)
    state = TE.init_cyclical_state(model, opt)
    tstep = TE.make_cyclical_train_step(model, opt, TE.CyclicalHParams(
        target_layers=(0, 2), update_freq=update_freq, **kw), TS.constant_schedule(5e-5))
    teacher0 = {k: v.clone() for k, v in state.model_ema.items()}
    for i in range(n_steps):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(mask), jax.random.PRNGKey(0))
        m = tstep(state, torch.from_numpy(images), torch.from_numpy(mask),
                  torch.Generator().manual_seed(0))
        assert state.step == i + 1
        for k in ("loss", "loss_cyc", "loss_var0", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=f"step {i} {k}",
                                       **STEP)
        assert float(m["mask_count"]) == float(jm["mask_count"]) == 6.0
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        ref = C.flax_to_state_dict(_np(jstate.params))
        for k, v in model.state_dict().items():
            _close(v, ref[k], f"step {i} {k}", **STEP)
        ema_ref = C.flax_to_state_dict(_np(jstate.ema_params))
        for k, v in state.model_ema.items():
            _close(v, ema_ref[k], f"step {i} teacher {k}", **STEP)
        if update_freq == 2 and i == 0:
            assert all(torch.equal(v, teacher0[k]) for k, v in state.model_ema.items())
    if case == "hinge_warmup":
        assert float(m["loss_var0"]) > 0
    moved = not all(torch.equal(v, teacher0[k]) for k, v in state.model_ema.items())
    assert moved
    # the teacher holds storage of its own, needs no gradient and is not in
    # the optimizer
    ptrs = {p.data_ptr() for p in model.parameters()}
    assert all(p.data_ptr() not in ptrs and not p.requires_grad
               for p in state.teacher.parameters())
    assert not {id(p) for p in state.teacher.parameters()} & {id(p) for p in opt.params}


def test_dropout_and_mask_dropout_follow_the_step_generator():
    """With drop-path 0.3, attention dropout 0.2 and mask dropout 0.5 the
    step's draws come from its generator alone: the same seed gives the same
    step (metrics and parameters), another seed another; mask dropout
    drops masked positions (a smaller mask count). The per-step generators
    are functions of (seed, step)."""
    overrides = dict(drop_path_rate=0.3, attn_drop_rate=0.2)
    _, _, model = _models(seed=2, **overrides)
    images, mask = _inputs(seed=2)
    hp = TE.CyclicalHParams(target_layers=(1, 2), mask_dropout_prob=0.5)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}

    def one_step(seed):
        model.load_state_dict(snapshot)
        opt = TO.make_optimizer(model, weight_decay=0.05, depth=SMALL["depth"])
        state = TE.init_cyclical_state(model, opt)
        step = TE.make_cyclical_train_step(model, opt, hp, TS.constant_schedule(1e-3))
        m = step(state, torch.from_numpy(images), torch.from_numpy(mask),
                 torch.Generator().manual_seed(seed))
        return m, {k: v.clone() for k, v in model.state_dict().items()}

    (ma, pa), (mb, pb), (mc, pc) = one_step(5), one_step(5), one_step(6)
    assert float(ma["loss"]) == float(mb["loss"]) and all(torch.equal(pa[k], pb[k]) for k in pa)
    assert float(ma["loss"]) != float(mc["loss"])
    assert float(ma["mask_count"]) < 6.0 and float(ma["mask_count"]) != float(mc["mask_count"])
    g1, g2 = TE.step_generators(0, 3, "cpu"), TE.step_generators(0, 3, "cpu")
    for a, b in ((g1.model, g2.model), (g1.augment, g2.augment), (g1.mask, g2.mask)):
        assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    assert not torch.equal(torch.rand(4, generator=TE.mask_generator(0, 3)),
                           torch.rand(4, generator=TE.mask_generator(0, 4)))


def test_optimizer_groups_match_the_jax_builder():
    """The weight-decay mask and the layer ids of the new names against the
    JAX builder's, leaf by leaf: mask_token (3-D) decayed and at layer 0,
    norm and lm_head at the last layer id."""
    _, variables, model = _models(gp_layer=True)
    params = variables["params"]
    jmask = C.flax_leaves_by_torch_key(JO.weight_decay_mask(params))
    jscale = C.flax_leaves_by_torch_key(JO.layer_decay_scales(params, 0.65, SMALL["depth"]))
    tmask = TO.weight_decay_mask(model)
    tscale = TO.layer_decay_scales(model, 0.65, SMALL["depth"])
    assert set(tmask) == set(jmask) == set(tscale)
    for k in tmask:
        assert tmask[k] == bool(jmask[k]), k
        assert tscale[k] == pytest.approx(float(jscale[k]), rel=1e-7), k
    assert tmask["mask_token"] and not tmask["cls_token"]
    assert tscale["mask_token"] == pytest.approx(0.65 ** 4)
    assert tscale["norm.weight"] == tscale["lm_head._gp_output_layer.weight"] == 1.0
