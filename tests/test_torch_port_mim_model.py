"""PyTorch port: the MIM and joint models, their registry entries and their
train steps against the JAX package; the int8 trunk through the pretraining
steps.

``MIMViT`` and ``JointViT`` are 2 blocks of width 64 on 32×32 images at
patch 16 (a 2×2 grid): one head of width 64, so the port takes the attention
kernels' route (K1/K2's plain versions through the autograd Function on CPU
tensors) with the exact softmax, and the JAX package its Pallas kernels in
interpret mode. The tokenizer is a DiscreteVAE (hidden 8, vocab 64, 2
layers) on 8×8 views, so that its 2×2 token grid is the patch grid. The
weights are seeded numpy draws over the JAX param trees, carried across by
``load_flax_params``. Tolerances: forwards rtol 2e-4 / atol 2e-5; gradients,
the train steps' losses, grad norms, parameters and teachers rtol 1e-3 /
atol 1e-4 (the attention tolerances of ROADMAP.md); tokens equal.

The int8 cases (width 128, the plain attention, as tests/test_torch_port_
quant.py builds them): the JAX kernels run in the Pallas interpreter; the
rounding to nearest compares value for value (the teacher's forward, which
quantizes on B·N rows as JAX models/layers.py:51-63 does), the step's loss
within 2e-2 and its grad norm within 15% (the backward rounds
stochastically, with other bits in each package).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as JFA
from uncertainty_vit_tpu.core.config import ViTConfig as JConfig
from uncertainty_vit_tpu.models import registry as JREG
from uncertainty_vit_tpu.models.cyclical import CyclicalViT as JCyclical
from uncertainty_vit_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from uncertainty_vit_tpu.models.mim import JointViT as JJoint
from uncertainty_vit_tpu.models.mim import MIMViT as JMIM
from uncertainty_vit_tpu.ops import quant as Q
from uncertainty_vit_tpu.train import engine_cyclical as JEC
from uncertainty_vit_tpu.train import engine_mim as JE
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.models import layers as TLay
from uncertainty_vit_tpu_torch.models import registry as TREG
from uncertainty_vit_tpu_torch.models.cyclical import CyclicalViT
from uncertainty_vit_tpu_torch.models.dvae import DiscreteVAE
from uncertainty_vit_tpu_torch.models.mim import JointViT, MIMViT
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.train import engine_cyclical as TEC
from uncertainty_vit_tpu_torch.train import engine_mim as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils import checkpoint as C
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=1, init_values=0.1,
             use_shared_rel_pos_bias=True, use_abs_pos_emb=False, head_type="none")
INT8 = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2, mlp_ratio=2.0,
            use_flash_attention=False, quant="int8", head_type="none")
VOCAB = 64
DVAE = dict(image_size=8, num_tokens=VOCAB, codebook_dim=12, num_layers=2, hidden_dim=8)
FWD = dict(rtol=2e-4, atol=2e-5)
STEP = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def exact_softmax_interpret():
    prev = (JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES, Q.INTERPRET)
    JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES, Q.INTERPRET = True, False, False, True
    yield
    JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES, Q.INTERPRET = prev


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


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


def _inputs(b=4, seed=0, num_masked=2, size=32):
    rs = np.random.RandomState(seed + 100)
    images = rs.randn(b, size, size, 3).astype(np.float32)
    vae_images = rs.rand(b, 8, 8, 3).astype(np.float32)
    mask = np.zeros((b, (size // 16) ** 2), np.float32)
    for i in range(b):
        mask[i, rs.choice(mask.shape[1], num_masked, replace=False)] = 1.0
    return images, vae_images, mask


def _models(kind, seed=0, config=SMALL, **overrides):
    """(JAX model, its numpy params, the port's model with those weights)."""
    jcls, tcls = {"mim": (JMIM, MIMViT), "joint": (JJoint, JointViT),
                  "cyclical": (JCyclical, CyclicalViT)}[kind]
    cfg = JConfig(**config, **overrides)
    kw = {} if kind == "cyclical" else {"vocab_size": VOCAB}
    jmodel = jcls(cfg=cfg, **kw)
    images, _, mask = _inputs(size=cfg.img_size)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(images),
                            jnp.asarray(mask))["params"]
    params = _numpy_params(shapes, seed)
    model = tcls(ViTConfig(**config, **overrides), device="cpu", **kw)
    return jmodel, params, C.load_flax_params(model, params)


@pytest.fixture(scope="module")
def tokenizer():
    """(JAX DiscreteVAE, its variables, the port's) on 8×8 views: 2×2
    tokens."""
    jvae = JDiscreteVAE(**DVAE)
    shapes = jax.eval_shape(jvae.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    params = _numpy_params(shapes, 9)
    return jvae, {"params": params}, C.load_flax_params(DiscreteVAE(**DVAE, device="cpu"), params)


def _close(got, want, what="", **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **tol)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def test_mim_logits_and_gradients_match_jax():
    """MIMViT's f32 logits over all patch tokens, the mask token in the
    masked ones, and the gradients of every parameter; the reference's
    names (mask_token, norm, lm_head; no fc_norm or head)."""
    jmodel, params, model = _models("mim")
    images, _, mask = _inputs()

    def jloss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(images), jnp.asarray(mask),
                           deterministic=True)
        return jnp.sum(out * jnp.sin(jnp.arange(out.size).reshape(out.shape))), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    out = model(torch.from_numpy(images), torch.from_numpy(mask), deterministic=True)
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, 4, VOCAB)
    _close(out, want, "logits", **FWD)
    (out * torch.sin(torch.arange(out.numel()).reshape(out.shape).float())).sum().backward()
    ref = C.flax_to_state_dict(_np(jgrads))
    for k, p in model.named_parameters():
        _close(p.grad, ref[k], k, **STEP)
    assert {k.split(".")[0] for k in model.state_dict()} == {
        "cls_token", "mask_token", "patch_embed", "rel_pos_bias", "blocks", "norm", "lm_head"}
    assert not torch.allclose(model(torch.from_numpy(images), None, deterministic=True), out)


def test_joint_outputs_and_layer_results_match_jax():
    """JointViT: (lm_out, beit_out) over the normed patch tokens with a mask,
    and the unmasked per-layer outputs "end" / "fc" without cls and before
    norm; lm_head.0 / lm_head.2 / beit_head under the reference's keys."""
    jmodel, params, model = _models("joint", seed=1)
    images, _, mask = _inputs(seed=1)
    lm, beit = jax.jit(lambda p, x, m: jmodel.apply({"params": p}, x, m))(
        params, jnp.asarray(images), jnp.asarray(mask))
    got_lm, got_beit = model(torch.from_numpy(images), torch.from_numpy(mask),
                             deterministic=True)
    assert tuple(got_lm.shape) == (4, 4, 64) and got_beit.dtype == torch.float32
    _close(got_lm, lm, "lm_out", **FWD)
    _close(got_beit, beit, "beit_out", **FWD)
    for lr_ in ("end", "fc"):
        want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, None, layer_results=lr_))(
            params, jnp.asarray(images))
        got = model(torch.from_numpy(images), None, deterministic=True, layer_results=lr_)
        assert len(got) == len(want) == 2
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{lr_} {i}", **FWD)
    keys = {k for k in model.state_dict() if "head" in k}
    assert keys == {"lm_head.0.weight", "lm_head.0.bias", "lm_head.2.weight", "lm_head.2.bias",
                    "beit_head.weight", "beit_head.bias"}
    with pytest.raises(ValueError, match="layer_results"):
        model(torch.from_numpy(images), None, layer_results="mid")


def test_heads_init_as_the_jax_package():
    """The heads' trunc_normal(0.02) bounded at ±0.02 (JAX models/mim.py:
    50, 88), zero biases; the backbone's as the cyclical model's."""
    model = JointViT(ViTConfig(**dict(SMALL, embed_dim=128, num_heads=2)), device="cpu",
                     vocab_size=256, generator=torch.Generator().manual_seed(0))
    for name in ("lm_head.0.weight", "lm_head.2.weight", "beit_head.weight", "mask_token",
                 "patch_embed.proj.weight"):
        v = model.state_dict()[name]
        assert float(v.abs().max()) <= 0.02 and 0.005 < float(v.std()) < 0.02, name
    assert all(float(model.state_dict()[k].abs().max()) == 0.0
               for k in ("lm_head.0.bias", "lm_head.2.bias", "beit_head.bias"))
    mim = MIMViT(ViTConfig(**SMALL), vocab_size=256, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    assert float(mim.lm_head.weight.detach().abs().max()) <= 0.02


def _fields(cfg):
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name,family,cls", [
    ("beit_base_patch16_224_8k_vocab", None, MIMViT),
    ("beit_large_patch16_224_8k_vocab", "mim", MIMViT),
    ("beit_base_joint_patch16_224", None, JointViT),
    ("beit_base_patch16_224", "joint", JointViT)])
def test_create_model_mim_and_joint_match_jax(name, family, cls):
    """The registry's MIM and joint families: configs equal to the JAX
    registry's (1-deep, on the meta device: no memory), head_type "none",
    the vocabulary passed through."""
    model, cfg = TREG.create_model(name, family, vocab_size=128, depth=1, device="meta")
    jmodel, jcfg = JREG.create_model(name, family, vocab_size=128, depth=1)
    assert isinstance(model, cls) and _fields(cfg) == _fields(jcfg)
    assert cfg.head_type == "none" and jmodel.vocab_size == model.vocab_size == 128
    out = model.lm_head.weight if cls is MIMViT else model.beit_head.weight
    assert tuple(out.shape) == (128, cfg.embed_dim)


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

def _jax_tx(params, lr, update_freq):
    return JO.make_optimizer(params, lr, weight_decay=0.05, clip_grad=3.0, depth=2,
                             accum_steps=update_freq)


def _port_opt(model, update_freq):
    return TO.make_optimizer(model, weight_decay=0.05, clip_grad=3.0, depth=2,
                             update_freq=update_freq)


def _check_params(model, jparams, what):
    ref = C.flax_to_state_dict(_np(jparams))
    for k, v in model.state_dict().items():
        _close(v, ref[k], f"{what} {k}", **STEP)


@pytest.mark.parametrize("update_freq", [1, 2])
def test_mim_train_steps_match_jax_engine(tokenizer, update_freq):
    """One and two steps of the JAX MIM engine (its step jitted once) and of
    the port's from the same weights, views, masks and tokenizer, at
    drop-path 0: the tokens, loss, mlm_acc, grad norm and lr, then every
    parameter after each step; under update_freq 2 the parameters stay
    after the first mini-step. AdamW with clip 3.0 and weight decay 0.05 at
    lr 5e-5 (Adam's first update moves a weight by about lr, so one whose
    tiny gradient rounds to the other sign lands within 2·lr = 1e-4)."""
    jvae, vvars, vae = tokenizer
    jmodel, params, model = _models("mim", seed=2)
    images, vae_images, mask = _inputs(seed=2)
    lr = JS.constant_schedule(5e-5)
    tx = _jax_tx(params, lr, update_freq)
    jstate = JE.MIMState(params=params, opt_state=tx.init(params), step=jnp.zeros([], jnp.int32))
    jstep = JE.make_mim_train_step(jmodel, jvae, vvars, tx, lr, update_freq=update_freq)
    opt = _port_opt(model, update_freq)
    state = TE.MIMState(model=model, optimizer=opt)
    tstep = TE.make_mim_train_step(model, vae, opt, TS.constant_schedule(5e-5))
    jids = np.asarray(jvae.apply(vvars, jnp.asarray(vae_images),
                                 method=jvae.get_codebook_indices))
    np.testing.assert_array_equal(vae.get_codebook_indices(torch.from_numpy(vae_images)).numpy(),
                                  jids)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(vae_images), jnp.asarray(mask),
                           jax.random.PRNGKey(0))
        m = tstep(state, (torch.from_numpy(images), torch.from_numpy(vae_images)),
                  torch.from_numpy(mask), torch.Generator().manual_seed(0))
        assert state.step == i + 1 and set(m) == set(jm) == {"loss", "mlm_acc", "grad_norm", "lr"}
        for k in ("loss", "mlm_acc", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=f"step {i} {k}", **STEP)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        _check_params(model, jstate.params, f"step {i}")
        if update_freq == 2 and i == 0:
            assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert not all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_joint_train_steps_match_jax_engine_across_the_annealing(tokenizer):
    """Three steps of the JAX joint engine and the port's at epochs 0, 50
    and 150 of a 100-epoch annealing (beit_weight 1, 0.5, 0): every metric,
    the student and the teacher after each step; target layers (0, 1), an
    EMA warm-up."""
    jvae, vvars, vae = tokenizer
    jmodel, params, model = _models("joint", seed=3)
    images, vae_images, mask = _inputs(seed=3)
    kw = dict(target_layers=(0, 1), ema_decay=0.9, ema_decay_init=0.5, ema_start_at=2,
              vae_loss_weight_anneal_epochs=100.0)
    lr = JS.constant_schedule(5e-5)
    tx = _jax_tx(params, lr, 1)
    jstate = JEC.CyclicalState(params=params, opt_state=tx.init(params),
                               ema_params=jax.tree_util.tree_map(np.copy, params),
                               step=jnp.zeros([], jnp.int32))
    jstep = JE.make_joint_train_step(jmodel, jvae, vvars, tx, JE.JointHParams(**kw), lr)
    opt = _port_opt(model, 1)
    state = TEC.init_cyclical_state(model, opt)
    tstep = TE.make_joint_train_step(model, vae, opt, TE.JointHParams(**kw),
                                     TS.constant_schedule(5e-5))
    for i, (epoch, w) in enumerate(((0, 1.0), (50, 0.5), (150, 0.0))):
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(vae_images), jnp.asarray(mask),
                           jnp.float32(epoch), jax.random.PRNGKey(0))
        m = tstep(state, (torch.from_numpy(images), torch.from_numpy(vae_images)),
                  torch.from_numpy(mask), epoch, torch.Generator().manual_seed(0))
        assert set(m) == set(jm)
        assert m["beit_weight"] == float(jm["beit_weight"]) == w
        for k in ("loss", "loss_cyc", "loss_beit", "mlm_acc", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=f"step {i} {k}", **STEP)
        _check_params(model, jstate.params, f"step {i}")
        ema_ref = C.flax_to_state_dict(_np(jstate.ema_params))
        for k, v in state.model_ema.items():
            _close(v, ema_ref[k], f"step {i} teacher {k}", **STEP)
    assert float(m["loss"]) == pytest.approx(float(m["loss_cyc"]), rel=1e-6)
    assert TE.beit_weight(29, 30) == float(np.float32(1) - np.float32(29) / np.float32(30))
    with pytest.raises(ValueError, match="update_freq"):
        TE.make_joint_train_step(model, vae, opt, TE.JointHParams(update_freq=2), lr)


@pytest.mark.parametrize("kind", ["mim", "joint"])
def test_dropout_and_drop_path_follow_the_step_generator(tokenizer, kind):
    """With drop-path 0.3 and attention dropout 0.2 a step's draws come
    from its generator alone: the same seed gives the same step, another
    seed another."""
    _, _, vae = tokenizer
    _, _, model = _models(kind, seed=4, drop_path_rate=0.3, attn_drop_rate=0.2)
    images, vae_images, mask = _inputs(seed=4)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}

    def one_step(seed):
        model.load_state_dict(snapshot)
        opt = TO.make_optimizer(model, weight_decay=0.05, depth=2)
        views = (torch.from_numpy(images), torch.from_numpy(vae_images))
        if kind == "mim":
            step = TE.make_mim_train_step(model, vae, opt, TS.constant_schedule(1e-3))
            m = step(TE.MIMState(model, opt), views, torch.from_numpy(mask),
                     torch.Generator().manual_seed(seed))
        else:
            step = TE.make_joint_train_step(model, vae, opt, TE.JointHParams(target_layers=(0, 1)),
                                            TS.constant_schedule(1e-3))
            m = step(TEC.init_cyclical_state(model, opt), views, torch.from_numpy(mask), 0,
                     torch.Generator().manual_seed(seed))
        return float(m["loss"]), {k: v.clone() for k, v in model.state_dict().items()}

    (la, pa), (lb, pb), (lc, _) = one_step(5), one_step(5), one_step(6)
    assert la == lb and all(torch.equal(pa[k], pb[k]) for k in pa)
    assert la != lc
    with pytest.raises(ValueError, match="aug_generator"):
        TE.make_mim_train_step(model, vae, TO.make_optimizer(model), TS.constant_schedule(1e-3),
                               aug_fn=lambda *a: a)(
            TE.MIMState(model, TO.make_optimizer(model)), images, torch.from_numpy(mask),
            torch.Generator())


def test_optimizer_groups_match_the_jax_builder():
    """The weight-decay mask and the layer ids of the joint model's names
    against the JAX builder's, leaf by leaf: mask_token decayed at layer 0;
    lm_head.0 / lm_head.2 / beit_head and norm at the last layer id, their
    kernels decayed and their biases not."""
    _, params, model = _models("joint")
    jmask = C.flax_leaves_by_torch_key(JO.weight_decay_mask(params))
    jscale = C.flax_leaves_by_torch_key(JO.layer_decay_scales(params, 0.65, 2))
    tmask = TO.weight_decay_mask(model)
    tscale = TO.layer_decay_scales(model, 0.65, 2)
    assert set(tmask) == set(jmask) == set(tscale)
    for k in tmask:
        assert tmask[k] == bool(jmask[k]), k
        assert tscale[k] == pytest.approx(float(jscale[k]), rel=1e-7), k
    assert tmask["mask_token"] and tmask["beit_head.weight"] and not tmask["lm_head.0.bias"]
    assert tscale["mask_token"] == pytest.approx(0.65 ** 3)
    assert tscale["lm_head.2.weight"] == tscale["beit_head.bias"] == tscale["norm.weight"] == 1.0


def test_dvae_optimizer_groups_match_the_jax_builder(tokenizer):
    """The dVAE trainer's AdamW (make_optimizer, no layer decay): the
    convolutions' kernels and the codebook decayed, the biases not, as the
    JAX builder's mask has them."""
    jvae, vvars, vae = tokenizer
    jmask = JO.weight_decay_mask(vvars["params"])
    want = {C._dvae_key_for(path, DVAE["num_layers"])[0]: bool(leaf)
            for path, leaf in C._leaves(jmask)}
    tmask = TO.weight_decay_mask(vae)
    assert set(tmask) == set(want)
    assert all(tmask[k] == bool(want[k]) for k in tmask)
    assert tmask["codebook.weight"] and tmask["decoder.0.0.weight"] and not tmask["encoder.4.bias"]
    opt = TO.make_optimizer(DiscreteVAE(**DVAE, device="cpu"), weight_decay=0.1)
    assert {g["lr_scale"] for g in opt.optimizer.param_groups} == {1.0}


# ---------------------------------------------------------------------------
# the int8 trunk through the pretraining steps
# ---------------------------------------------------------------------------

def _count_calls(monkeypatch, module):
    calls = []
    real = module.int8_dense

    def counted(*args, **kw):
        calls.append(math.prod(tuple(args[0].shape)[:-1]))
        return real(*args, **kw)

    monkeypatch.setattr(module, "int8_dense", counted)
    return calls


def test_int8_cyclical_step_and_teacher_match_jax(monkeypatch):
    """--quant int8 through the cyclical step: the teacher's forward (no
    gradient, deterministic) quantizes its 4 trunk matmuls a block on the
    B·N rows, in both packages, and its layer outputs agree within 2e-2 of
    their largest value; one step's loss within 2e-2 and grad norm within
    15% of the JAX engine's."""
    jmodel, params, model = _models("cyclical", seed=5, config=INT8)
    images, _, mask = _inputs(seed=5)
    jcalls, tcalls = _count_calls(monkeypatch, Q), _count_calls(monkeypatch, TLay.quant_ops)
    want = jmodel.apply({"params": params}, jnp.asarray(images), None, layer_results="end",
                        deterministic=True)
    with torch.no_grad():
        got = model(torch.from_numpy(images), None, deterministic=True, layer_results="end")
    assert jcalls == tcalls == [4 * 5] * (4 * INT8["depth"])
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 2e-2 * np.abs(np.asarray(w)).max()
    hp = dict(target_layers=(0, 1))
    lr = JS.constant_schedule(1e-3)
    tx = JO.make_optimizer(params, lr, weight_decay=0.0)
    jstate = JEC.CyclicalState(params=params, opt_state=tx.init(params),
                               ema_params=jax.tree_util.tree_map(np.copy, params),
                               step=jnp.zeros([], jnp.int32))
    _, jm = JEC.make_cyclical_train_step(jmodel, tx, JEC.CyclicalHParams(**hp), lr, donate=False)(
        jstate, jnp.asarray(images), jnp.asarray(mask), jax.random.PRNGKey(3))
    opt = TO.make_optimizer(model, weight_decay=0.0)
    m = TEC.make_cyclical_train_step(model, opt, TEC.CyclicalHParams(**hp),
                                     TS.constant_schedule(1e-3))(
        TEC.init_cyclical_state(model, opt), torch.from_numpy(images), torch.from_numpy(mask),
        torch.Generator().manual_seed(3))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-2)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=0.15)


def test_int8_mim_step_matches_jax(monkeypatch):
    """--quant int8 through the MIM step: the student's forward (with a
    mask, deterministic) quantizes its 4 trunk matmuls a block on the B·N
    rows in both packages, and its logits agree within 2e-3 of their
    largest value; one step's loss within 2e-2 and grad norm within 15% of
    the JAX engine's, the tokens equal; every parameter gets a finite
    gradient."""
    jvae = JDiscreteVAE(**DVAE)
    vshapes = jax.eval_shape(jvae.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    vparams = _numpy_params(vshapes, 9)
    vae = C.load_flax_params(DiscreteVAE(**DVAE, device="cpu"), vparams)
    jmodel, params, model = _models("mim", seed=6, config=INT8)
    images, vae_images, mask = _inputs(seed=6)
    with monkeypatch.context() as mp:
        jcalls, fcalls = _count_calls(mp, Q), _count_calls(mp, TLay.quant_ops)
        want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(images), jnp.asarray(mask),
                                       deterministic=True))
        with torch.no_grad():
            got = model(torch.from_numpy(images), torch.from_numpy(mask), deterministic=True)
    assert jcalls == fcalls == [4 * 5] * (4 * INT8["depth"])
    assert got.shape == want.shape
    # both round to nearest on the same scales: the logits agree to ~4e-7 of
    # their largest value here; the same weights unquantized are ~1.7e-2 off
    assert np.abs(got.numpy() - want).max() <= 2e-3 * np.abs(want).max()
    lr = JS.constant_schedule(1e-3)
    tx = JO.make_optimizer(params, lr, weight_decay=0.0)
    jstate = JE.MIMState(params=params, opt_state=tx.init(params), step=jnp.zeros([], jnp.int32))
    _, jm = JE.make_mim_train_step(jmodel, jvae, {"params": vparams}, tx, lr)(
        jstate, jnp.asarray(images), jnp.asarray(vae_images), jnp.asarray(mask),
        jax.random.PRNGKey(3))
    tcalls = _count_calls(monkeypatch, TLay.quant_ops)
    opt = TO.make_optimizer(model, weight_decay=0.0)
    m = TE.make_mim_train_step(model, vae, opt, TS.constant_schedule(1e-3))(
        TE.MIMState(model, opt), (torch.from_numpy(images), torch.from_numpy(vae_images)),
        torch.from_numpy(mask), torch.Generator().manual_seed(3))
    assert tcalls == [4 * 5] * (4 * INT8["depth"])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-2)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=0.15)
    for k, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k
