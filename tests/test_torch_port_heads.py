"""PyTorch port: the uncertainty heads (``models/heads.py``), the model with
each head type, and the SNGP / heteroscedastic train steps against the JAX
package.

Weights cross by ``utils.checkpoint.load_flax_params`` with the JAX
model's other collections ('spectral_stats', 'sngp_frozen', 'sngp_state')
into the port's buffers. The heteroscedastic head is fed the JAX draws:
``jax_het_noise`` repeats the key splits of the JAX head (heads.py:230-246)
and the port's op takes the ε arrays. Without an 'mc' rng the JAX head
draws from PRNGKey(42) (its fallback, which the port does not copy: there a
forward without a generator raises), and the train step's JAX head is held
to that key by patching its ``has_rng``. All in f32; tolerances per test.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uncertainty_vit_tpu.core.config import ViTConfig as JConfig
from uncertainty_vit_tpu.models import heads as JH
from uncertainty_vit_tpu.models import registry as JREG
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.ops import mixup as JM
from uncertainty_vit_tpu.train import engine_finetune as JE
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.models import heads as TH
from uncertainty_vit_tpu_torch.models import registry as TREG
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils import checkpoint as C
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

# the model of these tests: 2 blocks of width 64 at 32x32, the plain attention
SMALL = dict(img_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=1, num_classes=10,
             init_values=0.1, use_shared_rel_pos_bias=True, use_flash_attention=False)
HEADS = {
    "sngp_fc_norm": dict(head_type="sngp", sngp_fc_norm=True),
    "sngp": dict(head_type="sngp"),
    "het": dict(head_type="het", het_num_factors=5, het_test_mc_samples=40,
                het_train_mc_samples=30),
    "none": dict(head_type="none"),
}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def jax_het_noise(key, b, num_classes, num_factors, num_samples, mc_chunk=100):
    """The (ε_K, ε_R) the JAX head draws from ``key`` (heads.py:226-246),
    stacked over the chunks as the port's op takes them."""
    chunk = min(mc_chunk, num_samples)
    chunks = max(num_samples // chunk, 1)
    ks, rs_ = [], []
    for chunk_rng in jax.random.split(key, chunks):
        rk, rr = jax.random.split(chunk_rng)
        ks.append(np.asarray(jax.random.normal(rk, (b, chunk, num_classes), jnp.float32)))
        rs_.append(np.asarray(jax.random.normal(rr, (b, chunk, num_factors), jnp.float32)))
    return torch.from_numpy(np.stack(ks)), torch.from_numpy(np.stack(rs_))


def _close(got, want, rtol, atol=0.0, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the heads alone
# ---------------------------------------------------------------------------

def _unit(rs, n):
    v = rs.randn(n).astype(np.float32)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("scale", [1.0, 0.01], ids=["sigma_above_bound", "sigma_below_bound"])
def test_spectral_norm_dense_matches_jax(scale):
    """Forward with the stored (u, v) and forward with one power iteration:
    outputs and the updated vectors at rtol 1e-5. At scale 1 σ ≈ 12 is above
    the bound 0.95 (the weight is rescaled), at 0.01 below (it is not)."""
    rs = np.random.RandomState(0)
    x = rs.randn(6, 48).astype(np.float32)
    kernel = (rs.randn(48, 32) * scale).astype(np.float32)
    bias = (0.1 * rs.randn(32)).astype(np.float32)
    u, v = _unit(rs, 32), _unit(rs, 48)
    for _ in range(3):  # stored vectors of a trained layer: σ near its top
        v = kernel @ u / np.linalg.norm(kernel @ u)
        u = kernel.T @ v / np.linalg.norm(kernel.T @ v)
    jm = JH.SpectralNormDense(features=32)
    variables = {"params": {"kernel": kernel, "bias": bias}, "spectral_stats": {"u": u, "v": v}}
    t = TH.SpectralNormDense(48, 32, device="cpu")
    t.load_state_dict({"weight_orig": torch.tensor(kernel.T), "bias": torch.tensor(bias),
                       "weight_u": torch.tensor(u), "weight_v": torch.tensor(v)})
    sigma = float(u @ kernel.T @ v)
    assert (sigma > 0.95) == (scale == 1.0)
    _close(t(torch.from_numpy(x)), jm.apply(variables, jnp.asarray(x)), 1e-5, 1e-7, "eval")
    assert torch.equal(t.weight_u, torch.tensor(u))  # no update without update=
    want, mutated = jm.apply(variables, jnp.asarray(x), update=True, mutable=["spectral_stats"])
    _close(t(torch.from_numpy(x), update=True), want, 1e-5, 1e-7, "update")
    _close(t.weight_u, mutated["spectral_stats"]["u"], 1e-5, 1e-7, "u")
    _close(t.weight_v, mutated["spectral_stats"]["v"], 1e-5, 1e-7, "v")


def _sngp_pair(momentum, seed=1, hidden=48, inducing=24, classes=5):
    rs = np.random.RandomState(seed)
    x = rs.randn(7, hidden).astype(np.float32)
    jm = JH.SNGPHead(hidden_size=hidden, num_inducing=inducing, num_classes=classes,
                     momentum=momentum)
    variables = _np(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    # a norm and a precision matrix away from their init
    variables["params"]["input_norm"]["scale"] += 0.1 * rs.randn(hidden).astype(np.float32)
    variables["params"]["input_norm"]["bias"] += 0.1 * rs.randn(hidden).astype(np.float32)
    a = rs.randn(inducing, inducing).astype(np.float32)
    variables["sngp_state"]["precision_matrix"] = (0.1 * a @ a.T / inducing
                                                   + np.eye(inducing, dtype=np.float32))
    t = TH.SNGPHead(hidden, inducing, classes, momentum=momentum, device="cpu")
    sd = C.flax_to_state_dict({"head": variables["params"]})
    for col in ("sngp_frozen", "sngp_state"):
        sd.update(C.flax_to_state_dict({"head": variables[col]}))
    t.load_state_dict({k[len("head."):]: v for k, v in sd.items()}, strict=True)
    return jm, variables, t, x


@pytest.mark.parametrize("momentum", [0.999, 0.0], ids=["momentum", "exact"])
def test_sngp_head_matches_jax(momentum):
    """The output at rtol 1e-5; the precision matrix after update_cov
    (momentum 0.999, or the exact sum at 0) at rtol 1e-5; the GP covariance
    through the inverse at rtol 1e-4."""
    jm, variables, t, x = _sngp_pair(momentum)
    _close(t(torch.from_numpy(x)), jm.apply(variables, jnp.asarray(x)), 1e-5, 1e-6, "out")
    (want, want_cov), mutated = jm.apply(variables, jnp.asarray(x), update_cov=True,
                                         return_gp_cov=True, mutable=["sngp_state"])
    out, cov = t(torch.from_numpy(x), update_cov=True, return_gp_cov=True)
    _close(out, want, 1e-5, 1e-6, "out")
    _close(t.precision_matrix, mutated["sngp_state"]["precision_matrix"], 1e-5, 1e-7, "P")
    _close(cov, want_cov, 1e-4, 1e-4 * float(np.abs(want_cov).max()), "gp_cov")
    assert cov.shape == (7, 7)


@pytest.mark.parametrize("training", [False, True], ids=["test_samples", "train_samples"])
def test_het_head_with_jax_draws_matches_jax(training):
    """Fed the JAX head's draws (PRNGKey(42), its key without an 'mc' rng),
    the port's op gives the JAX log-probabilities at rtol 1e-5; 250 test
    samples run in 3 chunks of 100 (the remainder dropped, as JAX does), 60
    train samples in one."""
    rs = np.random.RandomState(2)
    x = rs.randn(5, 48).astype(np.float32)
    kw = dict(num_classes=7, num_factors=4, train_mc_samples=60, test_mc_samples=250)
    jm = JH.MCSoftmaxDenseFA(**kw)
    variables = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    t = TH.MCSoftmaxDenseFA(48, device="cpu", **kw)
    sd = C.flax_to_state_dict({"head": variables["params"]})
    t.load_state_dict({k[len("head."):]: v for k, v in sd.items()}, strict=True)
    want = jm.apply(variables, jnp.asarray(x), training=training)
    noise = jax_het_noise(jax.random.PRNGKey(42), 5, 7, 4, 60 if training else 250)
    assert noise[0].shape == ((1, 5, 60, 7) if training else (2, 5, 100, 7))
    got = t(torch.from_numpy(x), training=training, noise=noise)
    _close(got, want, 1e-5, 1e-6)
    assert torch.all(got <= 0)
    with pytest.raises(ValueError, match="generator"):
        t(torch.from_numpy(x))
    with pytest.raises(ValueError, match="noise shapes"):
        t(torch.from_numpy(x), training=not training, noise=noise)


def test_het_draws_are_seeded_and_standard_normal():
    """The port's own draws: one seed repeats them, another seed differs,
    and over 20 seeds their mean is 0 and variance 1 (to 4 standard errors
    of 2·10^5 draws); the forward from a generator equals the forward given
    the same generator's draws."""
    t = TH.MCSoftmaxDenseFA(16, 6, num_factors=3, test_mc_samples=200, device="cpu")
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(0))
    a = TH.draw_het_noise(torch.Generator().manual_seed(3), 4, 6, 3, 200)
    b = TH.draw_het_noise(torch.Generator().manual_seed(3), 4, 6, 3, 200)
    c = TH.draw_het_noise(torch.Generator().manual_seed(4), 4, 6, 3, 200)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], c[0])
    draws = torch.cat([torch.cat([e.flatten() for e in TH.draw_het_noise(
        torch.Generator().manual_seed(s), 4, 6, 3, 200)]) for s in range(20)])
    se = 1.0 / math.sqrt(draws.numel())
    assert abs(draws.mean().item()) < 4 * se
    assert abs(draws.var().item() - 1.0) < 4 * math.sqrt(2) * se
    with torch.no_grad():
        got = t(x, generator=torch.Generator().manual_seed(3))
        torch.testing.assert_close(got, t(x, noise=a), rtol=0, atol=0)


def _grads_of(module_out, jax_fn, params, torch_module, x, weights):
    """jax.grad of sum(out · weights) against torch's, as {torch key: grad}."""
    jgrads = jax.grad(lambda p: jnp.sum(jax_fn(p) * weights))(params)
    (module_out * torch.from_numpy(weights)).sum().backward()
    return C.flax_to_state_dict({"head": _np(jgrads)}), {
        "head." + k: p.grad for k, p in torch_module.named_parameters()}


@pytest.mark.parametrize("head", ["sngp", "het"])
def test_head_gradients_match_jax(head):
    """Gradients of sum(out · w) with respect to every parameter of the
    head and of its input, against jax.grad, at rtol 1e-4."""
    rs = np.random.RandomState(3)
    if head == "sngp":
        jm, variables, t, x = _sngp_pair(0.999, seed=3)
        rest = {k: v for k, v in variables.items() if k != "params"}

        def jax_fn(p, xx):
            return jm.apply({"params": p, **rest}, xx)

        def torch_fn(xx):
            return t(xx)
    else:
        x = rs.randn(5, 48).astype(np.float32)
        kw = dict(num_classes=7, num_factors=4, test_mc_samples=150)
        jm = JH.MCSoftmaxDenseFA(**kw)
        variables = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        t = TH.MCSoftmaxDenseFA(48, device="cpu", **kw)
        sd = C.flax_to_state_dict({"head": variables["params"]})
        t.load_state_dict({k[len("head."):]: v for k, v in sd.items()})
        noise = jax_het_noise(jax.random.PRNGKey(42), 5, 7, 4, 150)

        def jax_fn(p, xx):
            return jm.apply({"params": p}, xx)

        def torch_fn(xx):
            return t(xx, noise=noise)
    weights = rs.randn(x.shape[0], 7 if head == "het" else 5).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    want, got = _grads_of(torch_fn(xt), lambda p: jax_fn(p, jnp.asarray(x)),
                          variables["params"], t, x, weights)
    assert set(want) == set(got)
    for k in want:
        _close(got[k], want[k], 1e-4, 1e-4 * float(want[k].abs().max()), k)
    want_x = jax.grad(lambda xx: jnp.sum(jax_fn(variables["params"], xx) * weights))(
        jnp.asarray(x))
    _close(xt.grad, want_x, 1e-4, 1e-4 * float(np.abs(want_x).max()), "input")


# ---------------------------------------------------------------------------
# the model with each head
# ---------------------------------------------------------------------------

def _numpy_variables(shapes, seed):
    """Seeded numpy values for a JAX model's params (normal, kernels scaled
    by 1/√fan_in, LayerNorm scales near 1) and its other collections: unit
    vectors for u / v, N(0, 0.05) and U(0, 2π) for the random features, a
    positive definite precision matrix."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        names = [str(getattr(p, "key", p)) for p in path]
        name, shape = names[-1], leaf.shape
        if name in ("u", "v"):
            return _unit(rs, shape[0])
        if name == "rf_kernel":
            return (0.05 * rs.randn(*shape)).astype(np.float32)
        if name == "rf_bias":
            return rs.uniform(0, 2 * math.pi, shape).astype(np.float32)
        if name == "precision_matrix":
            a = rs.randn(*shape).astype(np.float32)
            return (0.05 * a @ a.T / shape[0] + np.eye(shape[0])).astype(np.float32)
        if "kernel" in name:
            return (rs.randn(*shape) / math.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)
        return (0.2 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _model_pair(head, seed=0, batch=4, **extra):
    kw = dict(SMALL, **HEADS[head], **extra)
    rs = np.random.RandomState(seed + 100)
    images = rs.randn(batch, 32, 32, 3).astype(np.float32)
    labels = rs.randint(0, 10, size=batch).astype(np.int32)
    jmodel = JViT(cfg=JConfig(**kw))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(images))
    variables = _numpy_variables(dict(shapes), seed)
    model = C.load_flax_params(VisionTransformer(ViTConfig(**kw), device="cpu"),
                               variables["params"], variables)
    return jmodel, variables, model, images, labels


@pytest.mark.parametrize("head", list(HEADS))
def test_model_logits_and_features_match_jax(head):
    """Eval logits and return_features' (logits, pooled feature) at rtol
    1e-5 and atol 1e-5 of the largest value (two f32 blocks and a LayerNorm
    in two frameworks; the heteroscedastic head fed the JAX draws); the GP
    covariance at rtol 1e-4; every JAX leaf has a
    buffer or parameter of its own in the port's state_dict."""
    jmodel, variables, model, images, _ = _model_pair(head)
    n_leaves = sum(len(jax.tree_util.tree_leaves(t)) for t in variables.values())
    assert len(model.state_dict()) == n_leaves
    model.eval()
    noise = None
    if head == "het":
        noise = jax_het_noise(jax.random.PRNGKey(42), 4, 10, 5, 40)
    x = torch.from_numpy(images)
    want = jmodel.apply(variables, jnp.asarray(images))
    want_out, want_feat = jmodel.apply(variables, jnp.asarray(images), return_features=True)
    with torch.no_grad():
        got = model(x, het_noise=noise)
        got_out, got_feat = model(x, het_noise=noise, return_features=True)
    assert got.dtype == torch.float32
    for what, g, w in (("logits", got, want), ("logits with features", got_out, want_out),
                       ("features", got_feat, want_feat)):
        _close(g, w, 1e-5, 1e-5 * float(np.abs(w).max()), what)
    if head == "none":
        assert got.shape == (4, 64)
    if head.startswith("sngp"):
        (_, want_cov) = jmodel.apply(variables, jnp.asarray(images), return_gp_cov=True)
        with torch.no_grad():
            _, cov = model(x, return_gp_cov=True)
        _close(cov, want_cov, 1e-4, 1e-4 * float(np.abs(want_cov).max()), "gp_cov")


def test_unknown_head_type_raises():
    with pytest.raises(ValueError, match="unknown head_type"):
        VisionTransformer(ViTConfig(**dict(SMALL, head_type="gp")), device="cpu")


def test_spectral_update_only_where_the_forward_draws():
    """update_sngp_cov moves (u, v) in a forward that draws (train mode) and
    not in eval mode, as JAX's ``update_sngp_cov and not deterministic``;
    the precision matrix moves in both, as JAX's head update does."""
    _, _, model, images, _ = _model_pair("sngp_fc_norm")
    x = torch.from_numpy(images)
    u0, p0 = model.fc_norm.weight_u.clone(), model.head.precision_matrix.clone()
    model.eval()
    with torch.no_grad():
        model(x, update_sngp_cov=True)
    assert torch.equal(model.fc_norm.weight_u, u0)
    assert not torch.equal(model.head.precision_matrix, p0)
    model.train()
    with torch.no_grad():
        model(x, generator=torch.Generator(), update_sngp_cov=True)
    assert not torch.equal(model.fc_norm.weight_u, u0)


def test_sngp_reset_cov_matches_jax():
    jmodel, variables, model, _, _ = _model_pair("sngp")
    want = JREG.sngp_reset_cov(variables["sngp_state"], 1e-3)
    assert TREG.sngp_reset_cov(model, 1e-3) is model
    _close(model.head.precision_matrix, want["head"]["precision_matrix"], 0, 0)
    assert torch.equal(model.head.precision_matrix, 1e-3 * torch.eye(64))


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

def _train_step_pair(head, patch=None):
    """One step of the JAX engine and of the port's on the same weights and
    batch (mixup off, label smoothing 0.1, layer decay 0.65, wd 0.05):
    (JAX new state, JAX metrics, port model, port metrics, JAX grads by
    torch key)."""
    jmodel, variables, model, images, labels = _model_pair(head, seed=1)
    params = variables["params"]
    hp_kw = dict(num_classes=10, mixup_active=False, label_smoothing=0.1, head_type=HEADS[
        head]["head_type"])
    lr = JS.cosine_schedule(1e-3, 1e-6, 100)
    tx = JO.make_optimizer(params, lr, weight_decay=0.05, layer_decay=0.65, depth=2)
    state = JE.FinetuneState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros([], jnp.int32),
                             sngp_state=variables.get("sngp_state"),
                             spectral_stats=variables.get("spectral_stats"),
                             sngp_frozen=variables.get("sngp_frozen"))
    jstep = JE.make_finetune_train_step(jmodel, tx, JE.FinetuneHParams(**hp_kw), lr)
    new_state, jmetrics = jstep(state, jnp.asarray(images), jnp.asarray(labels),
                                jax.random.PRNGKey(0))
    targets = JM.one_hot_smooth(jnp.asarray(labels), 10, 0.1)
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        out = jmodel.apply({"params": p, **rest}, jnp.asarray(images), None,
                           deterministic=False, update_sngp_cov=head.startswith("sngp"),
                           rngs={"dropout": jax.random.PRNGKey(1),
                                 "droppath": jax.random.PRNGKey(2)},
                           mutable=["sngp_state", "spectral_stats"])[0]
        return -jnp.mean(jnp.sum(targets * jax.nn.log_softmax(out), -1))

    jgrads = C.flax_to_state_dict(_np(jax.grad(loss_fn)(params)))
    opt = TO.make_optimizer(model, weight_decay=0.05, layer_decay=0.65, depth=2)
    tstate = TE.init_finetune_state(model, opt, use_model_ema=True)
    tstep = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**hp_kw),
                                        TS.cosine_schedule(1e-3, 1e-6, 100))
    metrics = tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels).long(),
                    torch.Generator().manual_seed(0), mc_generator=torch.Generator())
    return new_state, jmetrics, tstate, metrics, jgrads


def _check_step(new_state, jmetrics, tstate, metrics, jgrads):
    model = tstate.model
    for k in ("loss", "grad_norm", "class_acc"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    for k, p in model.named_parameters():
        _close(p.grad, jgrads[k], 1e-4, 1e-6, k)
    ref = C.flax_to_state_dict(_np(new_state.params))
    params = dict(model.named_parameters())
    for k, v in ref.items():
        well_posed = jgrads[k].abs() > 1e-6
        _close(params[k][well_posed], v[well_posed], 1e-5, 1e-6, k)
        assert (params[k] - v).abs().max().item() <= 1e-3, k
    # the EMA covers the parameters only
    assert set(tstate.model_ema) == set(params)


def test_sngp_train_step_matches_jax_engine():
    """One step of the SNGP model with the spectral fc_norm against the JAX
    engine: loss and grad norm at rtol 1e-5, grads at rtol 1e-4, the
    parameters after AdamW at rtol 1e-5 (where |g| > 1e-6, as
    tests/test_torch_port_train.py holds them), and the precision matrix
    and (u, v) the forward updated at rtol 1e-5."""
    new_state, jmetrics, tstate, metrics, jgrads = _train_step_pair("sngp_fc_norm")
    _check_step(new_state, jmetrics, tstate, metrics, jgrads)
    model = tstate.model
    _close(model.head.precision_matrix, new_state.sngp_state["head"]["precision_matrix"],
           1e-5, 1e-7, "precision matrix")
    _close(model.fc_norm.weight_u, new_state.spectral_stats["fc_norm_sn"]["u"], 1e-5, 1e-6, "u")
    _close(model.fc_norm.weight_v, new_state.spectral_stats["fc_norm_sn"]["v"], 1e-5, 1e-6, "v")
    # the frozen random features did not move
    _close(model.head._random_feature.weight, np.asarray(
        new_state.sngp_frozen["head"]["rf_kernel"]).T, 0, 0, "rf")


def test_het_train_step_with_jax_draws_matches_jax_engine(monkeypatch):
    """One step of the heteroscedastic model: the JAX head held to
    PRNGKey(42) (``has_rng`` patched), the port's head fed those draws
    (``draw_het_noise`` patched); both at the test sample count, as the
    JAX step passes training=False to this head. Tolerances as the SNGP
    step's."""
    monkeypatch.setattr(JH.MCSoftmaxDenseFA, "has_rng", lambda self, name: False)
    noise = jax_het_noise(jax.random.PRNGKey(42), 4, 10, 5, 40)
    drawn = []

    def fed(generator, *shape_args, **kw):
        drawn.append(shape_args)
        return noise

    monkeypatch.setattr(TH, "draw_het_noise", fed)
    new_state, jmetrics, tstate, metrics, jgrads = _train_step_pair("het")
    assert drawn == [(4, 10, 5, 40)]  # the test sample count
    _check_step(new_state, jmetrics, tstate, metrics, jgrads)


def test_het_train_step_needs_its_generator():
    _, _, model, images, labels = _model_pair("het")
    opt = TO.make_optimizer(model)
    step = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(
        num_classes=10, mixup_active=False, head_type="het"), TS.constant_schedule(1e-3))
    state = TE.init_finetune_state(model, opt)
    with pytest.raises(ValueError, match="generator"):
        step(state, torch.from_numpy(images), torch.from_numpy(labels).long(), torch.Generator())
    assert TE.step_generators(0, 3, "cpu").mc is None  # made for the het head only
    gens = TE.step_generators(0, 3, "cpu", het=True)
    m1 = step(state, torch.from_numpy(images), torch.from_numpy(labels).long(), gens.model,
              mc_generator=gens.mc)
    assert math.isfinite(float(m1["loss"]))


# ---------------------------------------------------------------------------
# the port's own checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head", ["sngp_fc_norm", "het"])
def test_checkpoint_round_trip_keeps_every_parameter_and_buffer(tmp_path, head):
    """checkpoint-N.pth of a model after two steps, restored into a model of
    another seed: every parameter and buffer back bit for bit (the
    precision matrix, the random features, u and v, both input-norm
    vectors), each under a key of its own."""
    cfg = ViTConfig(**dict(SMALL, **HEADS[head]))
    model = VisionTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = TO.make_optimizer(model)
    hp = TE.FinetuneHParams(num_classes=10, head_type=cfg.head_type)
    step = TE.make_finetune_train_step(model, opt, hp, TS.constant_schedule(1e-3))
    state = TE.init_finetune_state(model, opt, use_model_ema=True)
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([0, 1, 2, 3])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(2):
        g = TE.step_generators(0, i, "cpu", het=head == "het")
        step(state, x, y, g.model, g.mix, mc_generator=g.mc)
    moved = {k for k, v in model.state_dict().items() if not torch.equal(v, before[k])}
    if head == "sngp_fc_norm":
        for k in ("head.precision_matrix", "fc_norm.weight_u", "fc_norm.weight_v",
                  "head._gp_input_normalize_layer.weight",
                  "head._gp_input_normalize_layer.bias"):
            assert k in moved, k
        for k in ("head._random_feature.weight", "head._random_feature.bias"):
            assert k not in moved, k
    path = C.save_checkpoint(str(tmp_path), 0, state, 0)
    other = VisionTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    other_opt = TO.make_optimizer(other)
    restored = C.restore_checkpoint(path, TE.init_finetune_state(other, other_opt))
    want, got = model.state_dict(), other.state_dict()
    assert list(want) == list(got)
    assert all(torch.equal(want[k], got[k]) for k in want)
    assert restored.step == 2 and set(restored.model_ema) == set(dict(model.named_parameters()))
    blob = torch.load(path, weights_only=False)
    assert len(set(blob["model"])) == len(want)
