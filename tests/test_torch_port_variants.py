"""PyTorch port: the attention variants (sinkformer, Gumbel-softmax, the dual
stochastic attention) against the JAX package, and the switch that keeps
the kernels out of the AdaHessian pass.

The Gumbel draws are injected on both sides: the port's one draw site,
``ops.attention.draw_gumbel``, and ``jax.random.gumbel`` on the JAX side
(a test-side monkeypatch; the JAX package is not edited) hand out the same
numpy noise in call order. Weights cross by ``load_flax_params``.
Tolerances: forward rtol 2e-4 / atol 2e-5, gradients rtol 1e-3 / atol 1e-4
(tests/test_flash_attention.py:52,67), ``sinkhorn_probs`` rtol 1e-5.

The JAX package's engines and evaluation pass no "gumbel" rng, so its
gumbel and dual_sto models run only where a caller passes one (ROADMAP.md
§3); the port draws that noise from an explicit generator on every
forward, in training and evaluation, and a seeded driver run reproduces.
"""

import argparse
import io
import math
import os
import pickle
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from uncertainty_vit_tpu.cli import builders as JB
from uncertainty_vit_tpu.core.config import ViTConfig
from uncertainty_vit_tpu.models.layers import Block as JBlock
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.ops import attention as JA
from uncertainty_vit_tpu.utils.checkpoint import export_torch_state_dict
from uncertainty_vit_tpu_torch.cli import builders as TB
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.models.layers import Attention, Block
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import attention as TA
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.ops import quant as TQ
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.utils import checkpoint as TC
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

FWD = dict(rtol=2e-4, atol=2e-5)
BWD = dict(rtol=1e-3, atol=1e-4)
VARIANTS = ["sinkformer", "gumbel", "dual_sto"]
BASE = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2, num_classes=10,
            init_values=0.1, use_shared_rel_pos_bias=True, use_flash_attention=False)


class Noise:
    """The same Gumbel noise for both packages: call i of a run gets
    RandomState(seed + i).gumbel at the shape asked for, in f32."""

    def __init__(self, seed=0):
        self.seed, self.calls = seed, 0

    def draw(self, shape):
        rs = np.random.RandomState(self.seed + self.calls)
        self.calls += 1
        return rs.gumbel(size=tuple(shape)).astype(np.float32)


@pytest.fixture
def noise(monkeypatch):
    """Installs one noise stream in both packages; ``reset()`` restarts it."""
    state = {"jax": Noise(), "torch": Noise()}

    def jax_gumbel(key, shape=(), dtype=jnp.float32, *a, **k):
        return jnp.asarray(state["jax"].draw(shape), dtype)

    def torch_gumbel(shape, generator, device):
        return torch.from_numpy(state["torch"].draw(shape)).to(device)

    monkeypatch.setattr(jax.random, "gumbel", jax_gumbel)
    monkeypatch.setattr(TA, "draw_gumbel", torch_gumbel)

    def reset():
        state["jax"], state["torch"] = Noise(), Noise()

    reset.state = state
    return reset


def _numpy_params(shapes, seed):
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if "kernel" in name:
            return (rs.randn(*leaf.shape) / math.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        if name == "centroid":
            return rs.uniform(-0.5, 0.5, leaf.shape).astype(np.float32)
        return (0.2 * rs.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _grads_by_torch_key(tree):
    return {k: v.numpy() for k, v in TC.flax_to_state_dict(jax.device_get(tree)).items()}


# ---------------------------------------------------------------------------
# the probability functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_gumbel_softmax_probs_matches_jax(hard):
    """F.gumbel_softmax on the same scores and noise: the probabilities, and
    the gradient through the soft (or straight-through) path."""
    rs = np.random.RandomState(0)
    scores = rs.randn(2, 3, 7, 7).astype(np.float32)
    g = rs.gumbel(size=scores.shape).astype(np.float32)
    cot = rs.randn(*scores.shape).astype(np.float32)
    tau = 1.7

    def jfn(s):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "gumbel", lambda *a, **k: jnp.asarray(g))
            return JA.gumbel_softmax_probs(s, jax.random.PRNGKey(0), tau=tau, hard=hard)

    ref, vjp = jax.vjp(jfn, jnp.asarray(scores))
    (ref_grad,) = vjp(jnp.asarray(cot))
    s = torch.from_numpy(scores).requires_grad_(True)
    out = TA.gumbel_softmax_probs(s, tau=tau, hard=hard, noise=torch.from_numpy(g))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(ref_grad), **BWD)
    if hard:  # one-hot, up to the f32 rounding of y_hard + y_soft − y_soft
        o = out.detach().numpy()
        np.testing.assert_allclose(o, np.eye(7, dtype=np.float32)[o.argmax(-1)], atol=1e-6)


@pytest.mark.parametrize("iters,eps", [(3, 1.0), (4, 0.5)])
def test_sinkhorn_probs_matches_jax(iters, eps):
    """The Sinkhorn plan × N at rtol 1e-5 (odd and even iteration counts),
    its gradient at the backward tolerance; float64 scores stay float64."""
    rs = np.random.RandomState(1)
    scores = (2.0 * rs.randn(2, 2, 9, 9)).astype(np.float32)
    cot = rs.randn(*scores.shape).astype(np.float32)
    ref, ref_grad = jax.jit(lambda s, c: (lambda o, f: (o, f(c)[0]))(
        *jax.vjp(lambda t: JA.sinkhorn_probs(t, eps=eps, max_iter=iters), s)))(
        jnp.asarray(scores), jnp.asarray(cot))
    s = torch.from_numpy(scores).requires_grad_(True)
    out = TA.sinkhorn_probs(s, eps=eps, max_iter=iters)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(ref_grad), **BWD)
    assert TA.sinkhorn_probs(s.detach().double(), eps=eps, max_iter=iters).dtype == torch.float64


@pytest.mark.parametrize("variant", ["gumbel", "sinkformer"])
def test_naive_attention_variants_match_jax(variant, noise):
    """``naive_attention(variant=...)`` with a bias, against the JAX
    function on the same q / k / v and noise."""
    rs = np.random.RandomState(2)
    q, k, v = (rs.randn(2, 2, 9, 16).astype(np.float32) for _ in range(3))
    bias = (0.3 * rs.randn(2, 9, 9)).astype(np.float32)
    ref = JA.naive_attention(*(jnp.asarray(t) for t in (q, k, v)), 0.25, jnp.asarray(bias),
                             variant=variant, gumbel_rng=jax.random.PRNGKey(0))
    out = TA.naive_attention(*(torch.from_numpy(t) for t in (q, k, v)), 0.25,
                             torch.from_numpy(bias), variant=variant,
                             gumbel_generator=torch.Generator())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD)
    with pytest.raises(ValueError, match="variant"):
        TA.naive_attention(*(torch.from_numpy(t) for t in (q, k, v)), 0.25, variant="nope")


def test_draw_gumbel_needs_a_generator_and_is_standard_gumbel():
    with pytest.raises(ValueError, match="gumbel_generator"):
        TA.draw_gumbel((3,), None, "cpu")
    g = TA.draw_gumbel((200_000,), torch.Generator().manual_seed(0), "cpu")
    # mean γ ≈ 0.5772, variance π²/6
    assert abs(g.mean().item() - 0.5772) < 0.01 and abs(g.var().item() - math.pi ** 2 / 6) < 0.03
    again = TA.draw_gumbel((200_000,), torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(g, again) and torch.isfinite(g).all()


# ---------------------------------------------------------------------------
# the block and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_block_matches_jax(variant, noise):
    """One block of each variant with the layer scale: output and the
    gradients of the input and of every parameter (the dual_sto block's
    query / key / value / proj / centroid included)."""
    dim, heads, n = 64, 2, 10
    rs = np.random.RandomState(3)
    x = rs.randn(2, n, dim).astype(np.float32)
    cot = rs.randn(2, n, dim).astype(np.float32)
    jblock = JBlock(dim=dim, num_heads=heads, init_values=0.1, variant=variant, use_flash=False,
                    window_size=(3, 3) if variant != "dual_sto" else None)
    shapes = jax.eval_shape(lambda: jblock.init({"params": jax.random.PRNGKey(0),
                                                 "gumbel": jax.random.PRNGKey(1)},
                                                jnp.asarray(x)))["params"]
    params = _numpy_params(shapes, 4)

    def jfn(p, xx):
        return jblock.apply({"params": p}, xx, rngs={"gumbel": jax.random.PRNGKey(2)})[0]

    noise()
    ref, ref_gp, ref_gx = jax.jit(lambda p, xx: (lambda o, f: (o,) + f(jnp.asarray(cot)))(
        *jax.vjp(jfn, p, xx)))(params, jnp.asarray(x))
    block = Block(dim, heads, init_values=0.1, variant=variant, use_flash=False,
                  window_size=(3, 3) if variant != "dual_sto" else None, device="cpu")
    state = {k[len("blocks.0."):]: v for k, v in
             TC.flax_to_state_dict({"blocks_0": jax.device_get(params)}).items()}
    block.load_state_dict(state, strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    noise.state["torch"] = Noise()
    out, _ = block(xt, deterministic=True, gumbel_generator=torch.Generator())
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_gx), **BWD)
    want = {k[len("blocks.0."):]: v for k, v in
            _grads_by_torch_key({"blocks_0": ref_gp}).items()}
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], err_msg=name, **BWD)
    if variant == "dual_sto":
        assert tuple(block.attn.centroid.shape) == (32, 2)


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_logits_and_grads_match_jax(variant, noise):
    """A 2-deep model of each variant: eval logits and the gradients of a
    loss of them for every parameter, against the JAX model given the same
    parameters and noise; then the same in train mode with drop-path 0."""
    cfg = ViTConfig(**BASE, attn_variant=variant)
    rs = np.random.RandomState(5)
    images = rs.randn(2, 32, 32, 3).astype(np.float32)
    w = rs.randn(2, 10).astype(np.float32)
    jmodel = JViT(cfg=cfg)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                                                 "gumbel": jax.random.PRNGKey(1)},
                                                jnp.asarray(images)))["params"]
    params = _numpy_params(shapes, 6)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(images),
                              rngs={"gumbel": jax.random.PRNGKey(2)})
        return jnp.sum(logits * w), logits

    noise()
    # jitted: traced once, in the call order the noise stream assumes
    (_, ref), ref_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = TC.load_flax_params(VisionTransformer(TViTConfig(**BASE, attn_variant=variant),
                                                  device="cpu"), jax.device_get(params))
    noise.state["torch"] = Noise()
    logits = model.eval()(torch.from_numpy(images), gumbel_generator=torch.Generator())
    (logits * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref), **FWD)
    want = _grads_by_torch_key(ref_grads)
    for name, p in model.named_parameters():
        # the dual_sto blocks do not read the shared rel-pos table: no
        # gradient here, zeros there
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), want[name], err_msg=name, **BWD)


def test_dual_sto_weights_carry_by_name():
    """The dual_sto model's leaves cross both ways under JAX's export names
    (attn.{query,key,value,proj}.*, attn.centroid): ``load_flax_params``
    strictly, and the .pth import of JAX's ``export_torch_state_dict`` with
    nothing missing or unused."""
    cfg = ViTConfig(**BASE, attn_variant="dual_sto")
    jmodel = JViT(cfg=cfg)
    x = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0),
                                                 "gumbel": jax.random.PRNGKey(1)}, x))["params"]
    params = jax.device_get(_numpy_params(shapes, 7))
    model = TC.load_flax_params(VisionTransformer(TViTConfig(**BASE, attn_variant="dual_sto"),
                                                  device="cpu"), params)
    exported = export_torch_state_dict(params)
    assert {"blocks.0.attn.centroid", "blocks.1.attn.query.weight", "blocks.0.attn.key.bias",
            "blocks.1.attn.value.weight", "blocks.0.attn.proj.weight"} <= set(exported)
    fresh = VisionTransformer(TViTConfig(**BASE, attn_variant="dual_sto"), device="cpu")
    state, missing, unused = TC.import_torch_state_dict(exported, fresh.state_dict())
    assert missing == [] and unused == []
    fresh.load_state_dict(state, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    np.testing.assert_array_equal(model.blocks[1].attn.centroid.detach().numpy(),
                                  TC.flax_leaves_by_torch_key(params)["blocks.1.attn.centroid"])


# ---------------------------------------------------------------------------
# the kernel decision, the switch, the seeds
# ---------------------------------------------------------------------------

def test_use_kernel_is_decided_per_call():
    """As the JAX ``use_kernel`` (models/layers.py:332-338): the flag, the
    softmax variant, head width 64 and no ``plain_only()``, read at each
    call."""
    attn = Attention(128, 2, device="cpu")
    assert attn.use_kernel
    with TFA.plain_only():
        assert not attn.use_kernel
        with TFA.plain_only():
            assert TFA.in_plain_only()
        assert TFA.in_plain_only()
    assert attn.use_kernel and not TFA.in_plain_only()
    assert not Attention(128, 2, variant="gumbel", device="cpu").use_kernel
    assert not Attention(128, 2, use_flash=False, device="cpu").use_kernel
    with pytest.raises(ValueError, match="variant"):
        Attention(128, 2, variant="nope", device="cpu")


def test_plain_only_refuses_the_kernel_functions():
    """Inside the switch the kernel Functions (no double backward) refuse a
    call with grad, and a use_flash / int8 model runs its plain path, to the
    same logits."""
    qkv = torch.randn(1, 5, 3 * 128, requires_grad=True)
    with TFA.plain_only(), pytest.raises(RuntimeError, match="double backward"):
        TFA.fused_qkv_attention(qkv, None, None, None, 0.125, 2)
    with TFA.plain_only(), pytest.raises(RuntimeError, match="double backward"):
        TQ.int8_dense(torch.randn(4, 128), torch.randn(128, 128), None,
                      torch.zeros(1, dtype=torch.int64))
    cfg = get_preset("beit_test_patch16_32", embed_dim=128, num_classes=5, quant="int8",
                     use_flash_attention=True)
    model = VisionTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    plain = VisionTransformer(cfg.replace(quant="none", use_flash_attention=False),
                              device="cpu")
    plain.load_state_dict(model.state_dict(), strict=True)
    x = torch.randn(2, 32, 32, 3)
    calls = {"attention": 0, "int8": 0}
    orig_attention, orig_int8 = TFA._FusedQKVAttention.apply, TQ._Int8Dense.apply

    def counted(what, fn):
        def call(*a):
            calls[what] += 1
            return fn(*a)
        return staticmethod(call)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFA._FusedQKVAttention, "apply", counted("attention", orig_attention))
        mp.setattr(TQ._Int8Dense, "apply", counted("int8", orig_int8))
        model.eval()(x).sum().backward()
        n_step = dict(calls)
        with TFA.plain_only():
            out = model(x)
            out.sum().backward()
    assert n_step["attention"] == 2 and n_step["int8"] > 0 and calls == n_step
    np.testing.assert_allclose(out.detach().numpy(), plain.eval()(x).detach().numpy(), **FWD)


def test_softmax_runs_draw_what_they_drew():
    """The Gumbel and Hessian seeds extend ``step_seeds``: the first four, and
    so every generator an existing run makes, are the four-seed stream's."""
    for seed, step in [(0, 0), (3, 7), (2**40, 123456)]:
        four = [int(s) & (2**63 - 1) for s in
                np.random.SeedSequence([seed, step]).generate_state(4, np.uint64)]
        assert TE.step_seeds(seed, step)[:4] == four
        gens = TE.step_generators(seed, step, "cpu", het=True)
        assert gens.gumbel is None and gens.hessian is None
        for g, s in zip((gens.model, gens.augment, gens.mix, gens.mc), four):
            assert g.initial_seed() == s
        full = TE.step_generators(seed, step, "cpu", gumbel=True, hessian=True)
        assert full.mc is None
        assert [full.gumbel.initial_seed(), full.hessian.initial_seed()] == \
            TE.step_seeds(seed, step)[4:]


@pytest.mark.parametrize("flags,variant", [
    ([], "softmax"), (["--sinkformer"], "sinkformer"), (["--gumbel_softmax"], "gumbel"),
    (["--h_sto_trans"], "dual_sto"), (["--sinkformer", "--gumbel_softmax"], "sinkformer"),
    (["--gumbel_softmax", "--h_sto_trans"], "gumbel"),
], ids=["none", "sinkformer", "gumbel", "h_sto_trans", "sinkformer_first", "gumbel_first"])
def test_variant_flags_map_as_the_jax_builders(flags, variant):
    """``model_config_from_args`` decides the variant as JAX's (:223-229)."""
    tp, jp = argparse.ArgumentParser(), argparse.ArgumentParser()
    TB.add_model_args(tp)
    JB.add_model_args(jp)
    targs, jargs = tp.parse_args(flags), jp.parse_args(flags)
    tcfg, jcfg = TB.model_config_from_args(targs, 10), JB.model_config_from_args(jargs, 10)
    assert tcfg.attn_variant == jcfg.attn_variant == variant


@pytest.mark.parametrize("flags,refused", [
    (["--gumbel_softmax", "--laplace"], True), (["--h_sto_trans", "--visualize_embedding"], True),
    (["--sinkformer", "--gumbel_softmax", "--laplace"], False), (["--sinkformer", "--laplace"], False),
], ids=["gumbel_laplace", "dual_sto_embedding", "sinkformer_first_laplace", "sinkformer_laplace"])
def test_driver_refuses_what_a_gumbel_model_does_not_run(flags, refused):
    """--laplace and --visualize_embedding raise NotImplementedError for the
    variant the model is built with (``attn_variant``), not for the raw
    flags: under --sinkformer, which wins, no Gumbel noise is drawn."""
    args = TFT.get_args_parser().parse_args(flags)
    assert (TB.attn_variant(args) in ("gumbel", "dual_sto")) == refused
    sentinel = RuntimeError("past the refusal")

    def stop(*a, **k):
        raise sentinel

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFT, "resolve_device", stop)
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        with pytest.raises(NotImplementedError if refused else RuntimeError) as info:
            TFT.main(args, device="cpu")
    assert (info.value is sentinel) != refused


# ---------------------------------------------------------------------------
# through the driver
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("variants_cli")
    base = root / "cifar-100-python"
    base.mkdir()
    rs = np.random.RandomState(0)
    for name, n in (("train", 32), ("test", 16)):
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (n, 3072), dtype=np.uint8),
                         b"fine_labels": (np.arange(n) % 100).tolist()}, f)
    return root


def _run(root, out, *extra):
    argv = ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
            "--data_path", str(root), "--batch_size", "8", "--num_workers", "0",
            "--dtype", "float32", "--output_dir", str(out), "--steps_per_epoch", "1",
            "--epochs", "1", "--seed", "5", *extra]
    with redirect_stdout(io.StringIO()), pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        return TFT.main(TFT.get_args_parser().parse_args(argv), device="cpu")


@pytest.mark.parametrize("flag", ["--sinkformer", "--gumbel_softmax", "--h_sto_trans"])
def test_variant_driver_trains_evaluates_and_reproduces(root, tmp_path, flag):
    """A seeded variant run through the port's driver trains (drop-path and
    attention dropout on) and evaluates, and the same flags give the same
    weights and the same metrics again: the Gumbel noise comes from the
    step's and the evaluation's seeded generators, never the global one."""
    extra = [flag, "--drop_path", "0.1", "--attn_drop_rate", "0.1"]
    a = _run(root, tmp_path / "a", *extra)
    torch.manual_seed(123)  # the global generator plays no part
    b = _run(root, tmp_path / "b", *extra)
    assert a.step == b.step == 1
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k
    pth = str(tmp_path / "w.pth")
    torch.save({"model": a.model.state_dict()}, pth)
    ev = [_run(root, tmp_path / f"e{i}", flag, "--eval", "--finetune", pth)["eval"]
          for i in range(2)]
    assert ev[0] == ev[1] and math.isfinite(ev[0]["nll"])
    with open(os.path.join(tmp_path / "a", "log.txt")) as f:
        assert math.isfinite(float(__import__("json").loads(f.readline())["train_loss"]))
