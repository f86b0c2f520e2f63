"""PyTorch port: the MC-dropout and ensemble evaluation paths against the JAX
package, on the CPU, at a small size (3 blocks, width 128, 5 tokens).

Weights are drawn with numpy from a seed into the JAX param tree and moved
into the port with ``load_flax_params``; both models see the same images.
With dropout off the two packages agree to f32 rounding. With dropout on
their masks cannot agree (the reference draws flax's, the port its own
counter-based ones), so the comparison is one of distributions: means over
K = 256 samples within 5 standard errors. The JAX attention kernel runs in
interpret mode at rate 0, and its dropout is flax ``nn.Dropout``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as FA
from uncertainty_vit_tpu.core.config import ViTConfig
from uncertainty_vit_tpu.evals import classification as JE
from uncertainty_vit_tpu.evals import ensembles as JEN
from uncertainty_vit_tpu.evals import mc_dropout as JMC
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.evals import classification as TE
from uncertainty_vit_tpu_torch.evals import collect as TC
from uncertainty_vit_tpu_torch.evals import ensembles as TEN
from uncertainty_vit_tpu_torch.evals import mc_dropout as TMC
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.utils.checkpoint import flax_to_state_dict, load_flax_params

DEPTH = 3
BASE = dict(img_size=32, patch_size=16, embed_dim=128, depth=DEPTH, num_heads=2, num_classes=10,
            init_values=0.1, use_shared_rel_pos_bias=True)


@pytest.fixture(autouse=True)
def interpret_mode():
    prev = FA.INTERPRET
    FA.INTERPRET = True
    yield
    FA.INTERPRET = prev


def _params(cfg, seed=0):
    model = JViT(cfg=cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, cfg.img_size, cfg.img_size, 3)))["params"]
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if "kernel" in name:
            return (rs.randn(*leaf.shape) / math.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return (0.2 * rs.randn(*leaf.shape)).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(seed=0, **overrides):
    """(JAX model, numpy params, the port's model with the same weights)."""
    jmodel, params = _params(ViTConfig(**{**BASE, **overrides}), seed)
    model = load_flax_params(VisionTransformer(TViTConfig(**{**BASE, **overrides}), device="cpu"),
                             params)
    return jmodel, params, model


def _images(n=4, seed=1):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("split", [0, 1, DEPTH])
def test_split_trunk_forward_with_dropout_off_matches_jax(split):
    """[K, B, C] logits of the split-trunk forward, tiled at block ``split``
    (after the last block when split = depth), against the JAX model's; f32
    at the forward tolerance rtol 2e-4 / atol 2e-5."""
    jmodel, params, model = _pair()
    x = _images()
    ref = jmodel.apply({"params": params}, jnp.asarray(x), mc_samples=3, mc_split=split)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x), mc_samples=3, mc_split=split)
    assert out.shape == (3, 4, 10) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out[0].numpy(), out[2].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("split", [1, 2])
def test_split_trunk_equals_the_folded_forward_from_the_same_seed(split):
    """With no dropout below the split (dropout_from_block == split) the
    split-trunk forward is exact MC-dropout: the port's masks are functions
    of position, so from one generator seed it equals the folded forward to
    f32 rounding (the shared blocks' matmuls run at batch B instead of K·B)."""
    _, _, model = _pair(drop_rate=0.3, attn_drop_rate=0.2, dropout_from_block=split)
    x = torch.from_numpy(_images())
    folded = TMC.make_mc_dropout_forward(model, 4)(x, _gen(3))
    shared = TMC.make_mc_dropout_forward(model, 4, split_at=split)(x, _gen(3))
    assert folded.shape == shared.shape == (4, 4, 10)
    np.testing.assert_allclose(shared.numpy(), folded.numpy(), rtol=1e-5, atol=1e-6)
    assert not torch.equal(folded[0], folded[1])
    other = TMC.make_mc_dropout_forward(model, 4, split_at=split)(x, _gen(4))
    assert not np.allclose(other.numpy(), shared.numpy(), rtol=1e-3, atol=1e-4)


def test_mc_dropout_mean_agrees_with_jax_within_5_standard_errors():
    """Distribution check: the per-logit mean over K = 256 samples of the
    port against the JAX package's mean over its own 256, on the same
    weights and images, within 5 standard errors of the difference."""
    k = 256
    jmodel, params, model = _pair(drop_rate=0.1)
    x = _images()
    ref = np.asarray(JMC.make_mc_dropout_forward(jmodel, k)(
        {"params": params}, jnp.asarray(x), jax.random.PRNGKey(5)), np.float64)
    out = TMC.make_mc_dropout_forward(model, k)(torch.from_numpy(x), _gen(5)).double().numpy()
    assert ref.shape == out.shape == (k, 4, 10)
    se = np.sqrt(ref.var(axis=0, ddof=1) / k + out.var(axis=0, ddof=1) / k)
    assert np.all(se > 0)
    z = np.abs(ref.mean(axis=0) - out.mean(axis=0)) / se
    assert z.max() <= 5.0, z.max()
    # the spread of the samples is the same too (within 25%)
    ratio = out.std(axis=0) / ref.std(axis=0)
    assert np.all((ratio > 0.75) & (ratio < 1.25)), (ratio.min(), ratio.max())


@pytest.mark.parametrize("form", ["fold", "loop", "split"])
def test_mc_dropout_forward_formulations(form):
    _, _, model = _pair(drop_rate=0.2)
    x = torch.from_numpy(_images())
    kwargs = {"fold": {}, "loop": {"fold_into_batch": False}, "split": {"split_at": 2}}[form]
    fwd = TMC.make_mc_dropout_forward(model, 5, **kwargs)
    a, b, c = fwd(x, _gen(1)), fwd(x, _gen(1)), fwd(x, _gen(2))
    assert a.shape == (5, 4, 10) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert all(not torch.equal(a[0], a[i]) for i in range(1, 5))
    assert not model.training and not a.requires_grad
    mean = TMC.make_mc_dropout_mean_forward(model, 5, split_at=kwargs.get("split_at", 0))
    if form != "loop":
        np.testing.assert_allclose(mean(x, _gen(1)).numpy(), a.mean(0).numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_mc_dropout_forward_refuses_drop_path_and_bad_k():
    _, _, model = _pair(drop_rate=0.1, drop_path_rate=0.1)
    with pytest.raises(ValueError):
        TMC.make_mc_dropout_forward(model, 4)
    _, _, ok = _pair(drop_rate=0.1)
    with pytest.raises(ValueError):
        TMC.make_mc_dropout_forward(ok, 0)


def test_mc_split_refuses_learned_layer_weights():
    cfg = TViTConfig(**{**BASE, "use_shared_rel_pos_bias": False, "use_rel_pos_bias": True,
                        "learn_layer_weights": True})
    model = VisionTransformer(cfg, device="cpu", generator=_gen(0)).eval()
    with pytest.raises(AssertionError):
        model(torch.from_numpy(_images()), mc_samples=2, mc_split=1)


def test_mc_dropout_eval_enters_no_autograd_function():
    """Under inference_mode no backward is set up: the attention takes the
    forward-only path (no Function, so no K2 launch can follow)."""
    _, _, model = _pair(drop_rate=0.1, attn_drop_rate=0.1)
    entered = []
    real = TFA._FusedQKVAttention.apply
    TFA._FusedQKVAttention.apply = lambda *a: entered.append(1) or real(*a)
    try:
        before = TFA.fused_qkv_attention_bwd.launches
        out = TMC.make_mc_dropout_forward(model, 2)(torch.from_numpy(_images()), _gen(0))
    finally:
        TFA._FusedQKVAttention.apply = real
    assert entered == [] and out.is_inference()
    assert TFA.fused_qkv_attention_bwd.launches == before


@pytest.mark.parametrize("fn", ["predictive_entropy", "mutual_information"])
def test_uncertainty_measures_match_jax(fn):
    rs = np.random.RandomState(0)
    logits = rs.randn(6, 32, 10).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0, 0] = np.eye(10, dtype=np.float32)[3]  # exact zeros meet the eps clamp
    arg = probs.mean(0) if fn == "predictive_entropy" else probs
    ref = getattr(JMC, fn)(jnp.asarray(arg))
    out = getattr(TMC, fn)(torch.from_numpy(arg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    if fn == "mutual_information":
        assert float(out.min()) >= -1e-6


def _batches(n_batches=3, bs=4, seed=2):
    rs = np.random.RandomState(seed)
    return [(rs.randn(bs, 32, 32, 3).astype(np.float32), rs.randint(0, 10, bs).astype(np.int32))
            for _ in range(n_batches)]


def _torch_batches(batches):
    return [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in batches]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("split", [0, 2])
def test_evaluate_mc_dropout_at_rate_0_gives_the_metrics_of_evaluate(k, split):
    """With every rate 0 the K samples are the deterministic logits, so the
    MC-dropout metrics are those of evaluate() in both packages (rtol 1e-4).
    Labels come from the batch; K = 1 works."""
    jmodel, params, model = _pair()
    batches = _batches()
    jb = [(jnp.asarray(x), y) for x, y in batches]
    ref_det = JE.evaluate(jmodel, {"params": params}, jb)
    ref_mc = JE.evaluate_mc_dropout(jmodel, {"params": params}, jb, num_samples=k, split_at=split)
    det = TE.evaluate(model, _torch_batches(batches))
    mc = TE.evaluate_mc_dropout(model, _torch_batches(batches), num_samples=k, split_at=split)
    assert set(mc) == set(ref_mc)
    for name in ref_mc:
        np.testing.assert_allclose(mc[name], ref_mc[name], rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(mc[name], det[name], rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(mc[name], ref_det[name], rtol=1e-4, atol=1e-5, err_msg=name)


def test_evaluate_mc_dropout_draws_fresh_masks_per_batch_and_follows_its_seed(monkeypatch):
    _, _, model = _pair(drop_rate=0.3)
    x, y = _batches(1)[0]
    twice = _torch_batches([(x, y), (x, y)])
    seen = []
    make = TE.make_mc_dropout_mean_forward

    def recording_make(*args, **kwargs):
        fwd = make(*args, **kwargs)
        return lambda images, generator: seen.append(fwd(images, generator)) or seen[-1]

    monkeypatch.setattr(TE, "make_mc_dropout_mean_forward", recording_make)
    a = TE.evaluate_mc_dropout(model, twice, num_samples=2, seed=1)
    assert len(seen) == 2 and not torch.equal(seen[0], seen[1])  # same images, fresh masks
    first = seen[0]
    assert a == TE.evaluate_mc_dropout(model, twice, num_samples=2, seed=1)
    assert torch.equal(seen[2], first)
    assert all(math.isfinite(v) for v in a.values())
    TE.evaluate_mc_dropout(model, twice, num_samples=2, seed=2)
    assert not torch.equal(seen[4], first)


def test_evaluate_ensemble_matches_jax():
    """Member and ensemble metrics of two members against the JAX function
    on the same weights (rtol 1e-4)."""
    jmodel, p0, model = _pair(seed=0)
    _, p1 = _params(ViTConfig(**BASE), seed=7)
    batches = _batches()
    ref = JE.evaluate_ensemble(jmodel, {"params": JEN.stack_params([p0, p1])},
                               [(jnp.asarray(x), y) for x, y in batches])
    stacked = TEN.stack_params([flax_to_state_dict(p0), flax_to_state_dict(p1)])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = TE.evaluate_ensemble(model, stacked, _torch_batches(batches))
    assert len(out["members"]) == 2 and set(out) == set(ref)
    for got, want in zip(out["members"] + [out["ensemble"]], ref["members"] + [ref["ensemble"]]):
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-5, err_msg=name)
    assert out["members"][0] != out["members"][1]
    # the members ran through the model without being copied into it
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_ensemble_forward_and_stack_params():
    _, p0, model = _pair(seed=0)
    _, p1 = _params(ViTConfig(**BASE), seed=7)
    s0, s1 = flax_to_state_dict(p0), flax_to_state_dict(p1)
    stacked = TEN.stack_params([s0, s1])
    assert all(v.shape == (2,) + s0[k].shape for k, v in stacked.items())
    x = torch.from_numpy(_images())
    logits = TEN.make_ensemble_forward(model)(stacked, x)
    assert logits.shape == (2, 4, 10)
    with torch.no_grad():
        np.testing.assert_allclose(logits[0].numpy(), model.eval()(x).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TEN.ensemble_mean_logits(logits).numpy(),
                               logits.numpy().mean(0), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        TEN.stack_params([s0, {k: v for k, v in list(s1.items())[1:]}])


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_pipelined_pairs_yields_in_order_and_empties_its_window(depth):
    """Batch i is read back only after batches up to i + depth have been
    dispatched, in order, and nothing stays behind."""
    events = []

    def pairs():
        for i in range(5):
            events.append(("dispatch", i))
            yield torch.full((2, 3), float(i), dtype=torch.float64), np.array([i, i])

    out = []
    for logits, labels in TC.pipelined_pairs(pairs(), depth=depth):
        events.append(("read", int(labels[0])))
        out.append((logits, labels))
    assert [int(l[0]) for _, l in out] == list(range(5))
    assert all(lg.dtype == np.float32 and lg.shape == (2, 3) and lg[0, 0] == i
               for i, (lg, _) in enumerate(out))
    for i in range(5):
        assert events.index(("read", i)) > events.index(("dispatch", min(i + depth, 4)))
        if i + depth + 1 <= 4:
            assert events.index(("read", i)) < events.index(("dispatch", i + depth + 1))
    assert list(TC.pipelined_pairs(iter(()), depth=depth)) == []


def test_per_call_generator_is_a_reproducible_stream_of_fresh_generators():
    a, b, c = TC.per_call_generator(0, "cpu"), TC.per_call_generator(0, "cpu"), \
        TC.per_call_generator(1, "cpu")
    sa = [g.initial_seed() for g in (a(), a(), a())]
    assert sa == [g.initial_seed() for g in (b(), b(), b())]
    assert len(set(sa)) == 3
    assert sa[0] != c().initial_seed()
    assert a().device.type == "cpu"


def test_collect_logits_runs_on_the_pipelined_window():
    order = []

    def forward(x):
        order.append(int(x[0, 0]))
        return x * 2

    batches = [(torch.full((2, 3), float(i)), torch.tensor([i, i])) for i in range(4)]
    logits, labels = TC.collect_logits(forward, batches)
    assert order == [0, 1, 2, 3]
    np.testing.assert_array_equal(labels, [0, 0, 1, 1, 2, 2, 3, 3])
    np.testing.assert_array_equal(logits[:, 0], [0, 0, 2, 2, 4, 4, 6, 6])


def test_het_eval_branch_is_not_ported_yet():
    _, _, model = _pair()
    with pytest.raises(NotImplementedError):
        TE.make_eval_forward(model, het=True)
    with pytest.raises(NotImplementedError):
        TE.evaluate(model, [], het=True)
