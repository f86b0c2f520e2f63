"""PyTorch port: every optimizer name of the JAX ``make_optimizer`` (the
``ChainOptimizer`` of train/optim.py), lookahead, freezing, resuming, and
Hutchinson's Hessian-diagonal estimate, against the JAX package.

The same parameters (a ViT's parameters in miniature: the cls token, the
patch embedding's conv, block 0's norm and fc1, whose [128, 256] weight
Adafactor factors, and the head, so that the layer decay, the weight-decay
mask and every tensor rank are exercised) and the same gradients (seeded
numpy, in the JAX layout and carried into the port's) go through the optax
chain and the port's chain: seven updates (rectified RAdam
starts at the sixth, lookahead syncs at the sixth) with layer decay 0.75, a
cosine weight-decay schedule, global-norm clipping at 1.0, and
``update_freq`` 1 and 2 (fourteen mini-steps; AdaHessian's Hessian
estimates averaged with the gradients). Parameters are held at rtol 1e-5 /
atol 1e-6 where the gradient is above 1e-6 (the rule of
tests/test_torch_port_large_n.py); AdaHessian's update divides by |D|, so
there also where |D| is above 1e-3 of its largest entry. A resumed run
equals the straight one bit for bit.
"""

import copy
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from uncertainty_vit_tpu.core.config import ViTConfig
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.ops import losses as JL
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import losses as TL
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils import checkpoint as TC
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

NAMES = ["adam", "nadam", "radam", "adadelta", "novograd", "rmsprop", "rmsproptf", "sgd",
         "momentum", "lamb", "lars", "adafactor", "adamp", "sgdp", "adahessian",
         "lookahead_adamp", "fusedlamb"]
UPDATES = 7
KW = dict(weight_decay=0.05, clip_grad=1.0, layer_decay=0.75, depth=1)
CFG = dict(img_size=16, patch_size=8, embed_dim=128, depth=1, num_heads=2, mlp_ratio=2.0,
           num_classes=10, init_values=0.1, use_shared_rel_pos_bias=True,
           use_flash_attention=False)


SHAPES = {"cls_token": (1, 1, 128),
          "patch_embed": {"proj": {"kernel": (8, 8, 3, 128), "bias": (128,)}},
          "blocks_0": {"norm1": {"scale": (128,), "bias": (128,)},
                       "mlp": {"fc1": {"kernel": (128, 256), "bias": (256,)}}},
          "head": {"kernel": (128, 10), "bias": (10,)}}


class _Tensors(torch.nn.Module):
    """Parameters under the torch names of ``SHAPES``' JAX paths."""

    def __init__(self, state):
        super().__init__()
        for name, value in state.items():
            *path, leaf = name.split(".")
            module = self
            for part in path:
                if not hasattr(module, part):
                    module.add_module(part, torch.nn.Module())
                module = getattr(module, part)
            module.register_parameter(leaf, torch.nn.Parameter(value.clone()))


@pytest.fixture(scope="module")
def setup():
    """(the one-block model and its images for the Hutchinson test, the JAX
    parameters of ``SHAPES``) and the seeded gradient and Hessian streams,
    in the JAX layout."""
    images = np.random.RandomState(0).randn(2, 16, 16, 3).astype(np.float32)
    rs = np.random.RandomState(1)

    def tree(scale, r):
        return jax.tree_util.tree_map(lambda s: (scale * r.randn(*s)).astype(np.float32), SHAPES,
                                      is_leaf=lambda x: isinstance(x, tuple))

    params = tree(0.05, rs)
    grads = [tree(0.05, np.random.RandomState(2 + i)) for i in range(2 * UPDATES)]
    hessians = [tree(1.0, np.random.RandomState(100 + i)) for i in range(2 * UPDATES)]
    return images, params, grads, hessians


def _port(params, opt_name, update_freq, **kw):
    model = _Tensors(TC.flax_to_state_dict(params))
    opt = TO.make_optimizer(model, opt_name=opt_name, update_freq=update_freq,
                            momentum=0.9, **{**KW, **kw})
    return model, opt


def _schedules():
    total = UPDATES
    return ((JS.cosine_schedule(1e-2, 1e-4, total, 2), JS.cosine_schedule(0.05, 0.2, total, 0)),
            (TS.cosine_schedule(1e-2, 1e-4, total, 2), TS.cosine_schedule(0.05, 0.2, total, 0)))


def _run_port(model, opt, grads, hessians, start, stop, t_lr, t_wd):
    named = dict(model.named_parameters())
    for i in range(start, stop):
        g = TC.flax_to_state_dict(grads[i])
        for k, p in named.items():
            p.grad = g[k].clone()
        hessian = None
        if getattr(opt, "uses_hessian", False):
            h = TC.flax_to_state_dict(hessians[i])
            hessian = [h[k] for k in (n for n, _ in opt._named)]
        update = i // opt.update_freq
        opt.step(t_lr(update), t_wd(update), hessian=hessian)


def _run_jax(tx, params, grads, hessians, n, hessian):
    """n updates of the optax chain, jitted once (one program, not one
    compilation per primitive of an eager run)."""

    @jax.jit
    def one(params, state, g, h):
        updates, state = tx.update(g, state, params, **({"hessian_diag": h} if hessian else {}))
        return optax.apply_updates(params, updates), state

    state = tx.init(params)
    for i in range(n):
        params, state = one(params, state, grads[i], hessians[i])
    return params


def _hold(model, ref_params, grads, hessians=None):
    ref = TC.flax_to_state_dict(jax.device_get(ref_params))
    g = TC.flax_to_state_dict(grads[0])
    h = None if hessians is None else TC.flax_to_state_dict(hessians[0])
    for k, v in model.state_dict().items():
        ok = g[k].abs() > 1e-6
        if h is not None:
            ok &= h[k].abs() > 1e-3 * h[k].abs().max()
        np.testing.assert_allclose(v[ok].numpy(), ref[k][ok].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("update_freq", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_chain_matches_optax(setup, name, update_freq):
    _, params, grads, hessians = setup
    (j_lr, j_wd), (t_lr, t_wd) = _schedules()
    n = UPDATES * update_freq
    tx = JO.make_optimizer(params, j_lr, wd_schedule=j_wd, opt_name=name, momentum=0.9,
                           accum_steps=update_freq, **KW)
    hessian = TO.needs_hessian(name)
    ref = _run_jax(tx, params, grads, hessians, n, hessian)
    model, opt = _port(params, name, update_freq)
    # adam is the same chain as adamw: the AdamW of the earlier slices
    assert isinstance(opt, TO.LayerDecayAdamW if name == "adam" else TO.ChainOptimizer)
    assert getattr(opt, "uses_hessian", False) == hessian
    _run_port(model, opt, grads, hessians, 0, n, t_lr, t_wd)
    _hold(model, ref, grads, hessians if hessian else None)


def test_adafactor_factors_the_wide_leaf(setup):
    """A tensor whose two largest axes both have ≥ 128 entries keeps a row
    and a column statistic (fc1's weight: the port's [256, 128], JAX's
    [128, 256]), every other one an elementwise one (the conv's two largest
    axes are 128 and 8)."""
    _, params, _, _ = setup
    _, opt = _port(params, "adafactor", 1)
    t = opt._core
    names = [n for n, _ in opt._named]
    i = names.index("blocks.0.mlp.fc1.weight")
    assert t.v[i] is None and t.v_row[i].shape == (128,) and t.v_col[i].shape == (256,)
    for j, p in enumerate(opt.params):
        factored = p.ndim >= 2 and sorted(p.shape)[-2] >= 128
        assert (t.v[j] is None) == factored == (t.v_row[j] is not None), names[j]
    assert sum(v is None for v in t.v) == 1


def test_freezing_matches_jax(setup):
    """``freeze_all_except`` over a chain (lamb): the frozen parameters as
    they were, the head as optax moves it."""
    _, params, grads, hessians = setup
    (j_lr, j_wd), (t_lr, t_wd) = _schedules()
    tx = JO.freeze_all_except(
        JO.make_optimizer(params, j_lr, wd_schedule=j_wd, opt_name="lamb", **KW), params,
        ["head"])
    ref = _run_jax(tx, params, grads, hessians, 3, False)
    model, opt = _port(params, "lamb", 1)
    before = copy.deepcopy(model.state_dict())
    TO.freeze_all_except(opt, ["head"])
    _run_port(model, opt, grads, hessians, 0, 3, t_lr, t_wd)
    for k, v in model.state_dict().items():
        if "head" in k:
            assert not torch.equal(v, before[k])
        else:
            assert torch.equal(v, before[k]), k
    _hold(model, ref, grads)
    with pytest.raises(RuntimeError, match="before a step"):
        TO.freeze_all_except(opt, ["head"])


def test_a_parameter_without_a_gradient_takes_zeros(setup):
    """A parameter the loss does not read (grad None, as the dist model's
    cov_qkv) steps on a zero gradient, as its JAX gradient is zeros: its
    weight decay and the chain's statistics still apply (sgdp, whose decay
    sits inside its transform)."""
    _, params, grads, hessians = setup
    (j_lr, j_wd), (t_lr, t_wd) = _schedules()
    cut = "blocks.0.mlp.fc1.weight"
    zeroed = [jax.tree_util.tree_map(np.array, g) for g in grads[:3]]
    for g in zeroed:
        g["blocks_0"]["mlp"]["fc1"]["kernel"][...] = 0.0
    tx = JO.make_optimizer(params, j_lr, wd_schedule=j_wd, opt_name="sgdp", momentum=0.9, **KW)
    ref = _run_jax(tx, params, zeroed, hessians, 3, False)
    model, opt = _port(params, "sgdp", 1)
    named = dict(model.named_parameters())
    for i in range(3):
        g = TC.flax_to_state_dict(grads[i])
        for k, p in named.items():
            p.grad = None if k == cut else g[k].clone()
        opt.step(t_lr(i), t_wd(i))
    want = TC.flax_to_state_dict(jax.device_get(ref))
    np.testing.assert_allclose(named[cut].detach().numpy(), want[cut].numpy(), rtol=1e-5,
                               atol=1e-7)
    assert not torch.equal(named[cut].detach(), TC.flax_to_state_dict(params)[cut])


@pytest.mark.parametrize("name,update_freq", [("lookahead_sgd", 1), ("adafactor", 1),
                                              ("adahessian", 2)])
def test_resumed_run_equals_the_straight_one(setup, name, update_freq):
    """Through ``state_dict`` / ``load_state_dict`` (a checkpoint's round
    trip) part-way, across the lookahead's sync and, at update_freq 2,
    inside an accumulation window: the same parameters bit for bit."""
    _, params, grads, hessians = setup
    _, (t_lr, t_wd) = _schedules()
    n, cut = UPDATES * update_freq, 5 if update_freq == 1 else 7
    straight, opt = _port(params, name, update_freq)
    _run_port(straight, opt, grads, hessians, 0, n, t_lr, t_wd)
    first, opt1 = _port(params, name, update_freq)
    _run_port(first, opt1, grads, hessians, 0, cut, t_lr, t_wd)
    saved = copy.deepcopy({"model": first.state_dict(), "optimizer": opt1.state_dict()})
    resumed, opt2 = _port(params, name, update_freq)
    resumed.load_state_dict(saved["model"])
    opt2.load_state_dict(saved["optimizer"])
    assert opt2.count == opt1.count and opt2.mini_step == opt1.mini_step
    _run_port(resumed, opt2, grads, hessians, cut, n, t_lr, t_wd)
    for (k, v), w in zip(straight.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(v, w), k
    other, opt3 = _port(params, "sgd" if name != "sgd" else "adam", update_freq)
    with pytest.raises(ValueError, match="--opt"):
        opt3.load_state_dict(saved["optimizer"])


def test_names_and_errors():
    """``fused*`` is the plain name, ``lookahead_`` wraps; adamw / adam are
    the AdamW of the earlier slices; an unknown name raises ValueError, as
    the JAX make_optimizer does; adahessian refuses a step without its
    estimate."""
    model = _Tensors(TC.flax_to_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s, np.float32), SHAPES, is_leaf=lambda x: isinstance(x, tuple))))
    assert TO.parse_opt_name("fusedlamb") == ("lamb", False)
    assert TO.parse_opt_name("lookahead_fusedadam") == ("adam", True)
    assert TO.parse_opt_name(None) == ("adamw", False)
    assert isinstance(TO.make_optimizer(model, opt_name="adam"), TO.LayerDecayAdamW)
    assert isinstance(TO.make_optimizer(model, opt_name="lookahead_adamw"), TO.ChainOptimizer)
    for bad in ("nonesuch", "lookahead_nonesuch", "sgdw"):
        with pytest.raises(ValueError, match="not supported"):
            TO.make_optimizer(model, opt_name=bad)
        with pytest.raises(ValueError):
            JO.make_optimizer({"w": jnp.zeros((2, 2))}, lambda s: 1e-3, opt_name=bad)
    for name in ("adahessian", "fusedadahessian", "lookahead_adahessian"):
        assert TO.needs_hessian(name) == JO.needs_hessian(name) is True
    assert not TO.needs_hessian("adamw") and not TO.needs_hessian(None)
    opt = TO.make_optimizer(model, opt_name="adahessian")
    with pytest.raises(ValueError, match="hessian"):
        opt.step(1e-3, 0.05)


@pytest.mark.parametrize("channel", [True, False], ids=["channel", "layer"])
def test_adamp_projection_matches_jax_where_it_fires(channel):
    """The projection on one tensor (the same layout on both sides) where
    the gradient is orthogonal to the weight: per channel, or only over the
    whole tensor; the update's radial part removed, the decay ratio
    returned."""
    rs = np.random.RandomState(4)
    p = rs.randn(6, 40).astype(np.float32)
    g = rs.randn(6, 40).astype(np.float32)
    if channel:  # every row of g orthogonal to p's
        g -= (g * p).sum(1, keepdims=True) / (p * p).sum(1, keepdims=True) * p
    else:  # orthogonal as a whole, not row by row
        g -= (g * p).sum() / (p * p).sum() * p
    perturb = rs.randn(6, 40).astype(np.float32)
    ref, ref_ratio = JO._adamp_projection(jnp.asarray(p), jnp.asarray(g), jnp.asarray(perturb),
                                          0.1, 0.01, 1e-8)
    out, ratio = TO.adamp_projection(torch.from_numpy(p), torch.from_numpy(g),
                                     torch.from_numpy(perturb), 0.1, 0.01, 1e-8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert float(ratio) == pytest.approx(float(ref_ratio)) == 0.01
    assert not np.allclose(out.numpy(), perturb)


def test_hutchinson_estimate_matches_jax(setup, monkeypatch):
    """z ⊙ Hz of the one-block model's cross-entropy, the same Rademacher z
    on both sides (``jax.random.rademacher`` and the port's
    ``draw_rademacher`` fed one seeded numpy z): the port's double backward
    against JAX's forward-over-reverse, at the backward tolerance."""
    images = setup[0]
    jmodel = JViT(cfg=ViTConfig(**CFG))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda s: (0.05 * rs.randn(*s.shape)).astype(np.float32), shapes)
    labels = np.array([3, 7])
    targets = np.eye(10, dtype=np.float32)[labels]
    rs = np.random.RandomState(5)
    z_tree = jax.tree_util.tree_map(
        lambda p: rs.choice([-1.0, 1.0], size=p.shape).astype(np.float32), params)
    leaves = iter(jax.tree_util.tree_leaves(z_tree))
    monkeypatch.setattr(jax.random, "rademacher", lambda k, shape, dtype: jnp.asarray(next(leaves)))

    def jloss(p):
        return JL.soft_target_cross_entropy(jmodel.apply({"params": p}, jnp.asarray(images)),
                                            jnp.asarray(targets))

    ref = TC.flax_to_state_dict(jax.device_get(jax.jit(
        lambda p: JO.hutchinson_hessian_diag(jax.grad(jloss), p, jax.random.PRNGKey(0)))(params)))
    model = TC.load_flax_params(VisionTransformer(TViTConfig(**CFG), device="cpu"),
                                jax.device_get(params))
    z = TC.flax_to_state_dict(z_tree)
    names = [n for n, _ in model.named_parameters()]
    monkeypatch.setattr(TO, "draw_rademacher", lambda ps, gen: [z[n] for n in names])
    x, t = torch.from_numpy(images), torch.from_numpy(targets)
    d = TO.hutchinson_hessian_diag(lambda: TL.soft_target_cross_entropy(model.eval()(x), t),
                                   list(model.parameters()), torch.Generator())
    for n, v in zip(names, d):
        np.testing.assert_allclose(v.numpy(), ref[n].numpy(), rtol=1e-3, atol=1e-4, err_msg=n)
    assert any(v.abs().max() > 1e-3 for v in d)
    # the estimator's own draws: ±1, from the generator, one tensor a parameter
    zs = TO.draw_rademacher(list(model.parameters()), torch.Generator().manual_seed(0))
    assert all(set(torch.unique(v).tolist()) <= {-1.0, 1.0} for v in zs)
    assert math.isclose(sum(v.sum().item() for v in zs) / sum(v.numel() for v in zs), 0.0,
                        abs_tol=0.02)
