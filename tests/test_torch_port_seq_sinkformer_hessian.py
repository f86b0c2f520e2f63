"""PyTorch port: the sinkformer attention and the AdaHessian pass under a
seq group, against the JAX package in one process.

Two gloo ranks start once for the module (``parallel.seq.run_ranks``) and
run every case while the parent computes the JAX references (jitted):

- the Sinkhorn probabilities: each rank's rows of seeded scores through
  ``ops.attention.sinkhorn_probs(..., group=)`` (the column steps'
  logsumexp over both ranks' rows, ``seq.logsumexp_over``), and their
  gradient, against JAX ``ops/attention.py`` ``sinkhorn_probs`` on the
  whole sequence;
- a 2-deep narrow sinkformer model split 3 | 2 tokens over the ranks:
  its logits and its parameters' gradients against the JAX model's;
- one AdaHessian finetune step of a 2-deep width-128 model on the two
  ranks (the same z injected on both sides), in the pattern of
  tests/test_torch_port_adahessian.py::test_finetune_step_matches_jax_engine:
  the loss and gradient norm, and D = z ⊙ Hz summed over the group, against
  the JAX engine's; and the same step with the k/v gather's backward as it
  was before (an all-reduce in place inside the backward, which a second
  backward cannot see through), whose D must miss that hold.

The ranks import this module by name, so the JAX package is imported inside
fixtures and tests only.
"""

import math
import threading

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import attention as TA
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
from uncertainty_vit_tpu_torch.parallel import seq
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils import checkpoint as C

# the Sinkhorn cases: (B, H, N, eps, iterations)
SINKHORN = ((2, 2, 7, 1.0, 3), (1, 3, 5, 0.5, 4))
PROBS = dict(rtol=2e-4, atol=2e-5)
GRADS = dict(rtol=1e-3, atol=1e-4)
# the AdaHessian step (tests/test_torch_port_adahessian.py): 16x16 images of
# 8x8 patches, N = 5 tokens split 3 | 2
SMALL = dict(img_size=16, patch_size=8, embed_dim=128, depth=2, num_heads=2, init_values=0.1,
             use_shared_rel_pos_bias=True, use_abs_pos_emb=False)
STEP = dict(rtol=1e-3, atol=1e-4)
OPT = dict(weight_decay=0.05, clip_grad=3.0, layer_decay=0.75, depth=2, opt_name="adahessian")
HP = dict(num_classes=10, mixup_active=False, label_smoothing=0.1)
LR = 1e-4
# the sinkformer model: 2 blocks of width 64 in one head
SINK_MODEL = dict(img_size=16, patch_size=8, embed_dim=64, depth=2, num_heads=1, init_values=0.1,
                  use_shared_rel_pos_bias=True, use_abs_pos_emb=False, num_classes=10,
                  attn_variant="sinkformer", sinkformer_eps=0.7, sinkformer_iters=3)


def _scores(b, h, n):
    rs = np.random.RandomState(b * 100 + h * 10 + n)
    return (2.0 * rs.randn(b, h, n, n)).astype(np.float32), rs.randn(b, h, n, n).astype(
        np.float32)


def _old_gather_backward(ctx, grad):
    """The k/v gather's backward before the seq collectives were made twice
    differentiable: an all-reduce in place on a clone."""
    total = grad.contiguous().clone()
    torch.distributed.all_reduce(total, group=ctx.group.group)
    start, stop = ctx.group.rows(ctx.n)
    return total[:, start:stop], None, None


def _sinkhorn_rank(group):
    out = []
    for b, h, n, eps, iters in SINKHORN:
        scores, w = _scores(b, h, n)
        start, stop = group.rows(n)
        s = torch.from_numpy(scores[:, :, start:stop]).requires_grad_(True)
        probs = TA.sinkhorn_probs(s, eps, iters, group=group, n_rows=n)
        (probs * torch.from_numpy(w[:, :, start:stop])).sum().backward()
        out.append((probs.detach().numpy(), s.grad.numpy()))
    return out


def _sink_model_rank(group, state, images, labels):
    model = VisionTransformer(ViTConfig(**SINK_MODEL), device="cpu", seq_group=group)
    model.load_state_dict(state)
    logits = model(torch.from_numpy(images), deterministic=True)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    grads = [p.grad.clone() for p in model.parameters()]
    meshlib.grad_reducer(model, list(model.parameters())).sum_tokens(grads)
    return logits.detach().numpy(), {n: g.numpy() for (n, _), g in
                                     zip(model.named_parameters(), grads)}


def _hessian_rank(group, state, z, images, labels, old_gather):
    """One AdaHessian step on the seq group: (loss, grad norm, the summed D
    by name, the summed gradient by name)."""
    model = VisionTransformer(ViTConfig(**SMALL, num_classes=10), device="cpu", seq_group=group)
    model.load_state_dict(state)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    TO.draw_rademacher = lambda ps, gen: [torch.from_numpy(z[n]) for n in names]
    seen = {}
    estimate = TO.hutchinson_hessian_diag

    def kept(*a, **k):
        seen["d"] = estimate(*a, **k)  # summed in place by the optimizer's step
        return seen["d"]

    TO.hutchinson_hessian_diag = kept
    if old_gather:
        seq._GatherTokens.backward = staticmethod(_old_gather_backward)
    opt = TO.make_optimizer(model, **OPT)
    state_ = TE.init_finetune_state(model, opt)
    step = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**HP),
                                       TS.constant_schedule(LR), use_hessian=True)
    gens = TE.step_generators(0, 0, "cpu", hessian=True)
    m = step(state_, torch.from_numpy(images), torch.from_numpy(labels), gens.model,
             hessian_generator=gens.hessian)
    return (float(m["loss"]), float(m["grad_norm"]),
            {n: d.numpy() for n, d in zip(names, seen["d"])},
            {n: model.get_parameter(n).grad.numpy() for n in names})


def _rank(group, inputs):
    torch.set_num_threads(1)
    TFA.BOUNDED_SCORES = False
    out = {"sinkhorn": _sinkhorn_rank(group),
           "sink_model": _sink_model_rank(group, *inputs["sink_model"])}
    out["hessian"] = _hessian_rank(group, *inputs["hessian"], old_gather=False)
    out["hessian_old_gather"] = _hessian_rank(group, *inputs["hessian"], old_gather=True)
    return out


class _Ranks(threading.Thread):
    def __init__(self, inputs):
        super().__init__(daemon=True)
        self.inputs, self.result, self.error = inputs, None, None

    def run(self):
        try:
            self.result = seq.run_ranks(_rank, 2, self.inputs, timeout=600.0)
        except BaseException as e:  # raised in the fixture
            self.error = e


def _jax_setup():
    import jax
    import jax.numpy as jnp

    import uncertainty_vit_tpu.ops.flash_attention as JFA
    from uncertainty_vit_tpu.core.config import ViTConfig as JConfig
    from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT

    return jax, jnp, JFA, JConfig, JViT


@pytest.fixture(scope="module")
def runs():
    """The ranks' results and the JAX references: {"ranks", "sinkhorn",
    "sink_model", "hessian", "inputs"}."""
    jax, jnp, JFA, JConfig, JViT = _jax_setup()
    from uncertainty_vit_tpu.ops import attention as JA
    from uncertainty_vit_tpu.train import engine_finetune as JE
    from uncertainty_vit_tpu.train import optim as JO
    from uncertainty_vit_tpu.train import schedules as JS

    rs = np.random.RandomState(0)
    # the sinkformer model's weights: the port's init from a seed, the rel-pos
    # table and the head drawn wider, crossed into the JAX tree
    sink = VisionTransformer(ViTConfig(**SINK_MODEL), device="cpu",
                             generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in sink.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    sink_state = {k: v.clone() for k, v in sink.state_dict().items()}
    sink_images = rs.randn(3, 16, 16, 3).astype(np.float32)
    sink_labels = np.array([1, 4, 7])
    # the AdaHessian step's weights and z (tests/test_torch_port_adahessian.py)
    images = rs.randn(4, 16, 16, 3).astype(np.float32)
    labels = np.array([1, 3, 5, 7])
    jmodel = JViT(cfg=JConfig(**SMALL, num_classes=10, use_flash_attention=False))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(images))["params"]
    prs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda s: (0.2 * prs.randn(*s.shape)).astype(np.float32), shapes)
    model = C.load_flax_params(VisionTransformer(ViTConfig(**SMALL, num_classes=10),
                                                 device="cpu"), params)
    zrs = np.random.RandomState(9)
    z_tree = jax.tree_util.tree_map(
        lambda p: zrs.choice([-1.0, 1.0], size=np.shape(p)).astype(np.float32), params)
    z = {k: v.numpy() for k, v in C.flax_to_state_dict(z_tree).items()}
    inputs = {"sink_model": (sink_state, sink_images, sink_labels),
              "hessian": (model.state_dict(), z, images, labels)}
    ranks = _Ranks(inputs)
    ranks.start()
    out = {"inputs": inputs}
    prev = JFA.BOUNDED_SCORES
    try:
        JFA.BOUNDED_SCORES = False
        # the Sinkhorn probabilities and their gradient on the whole sequence
        out["sinkhorn"] = []
        for b, h, n, eps, iters in SINKHORN:
            scores, w = _scores(b, h, n)
            fn = jax.jit(jax.value_and_grad(
                lambda s: (JA.sinkhorn_probs(s, eps, iters) * w).sum(), has_aux=False))
            probs = np.asarray(jax.jit(lambda s: JA.sinkhorn_probs(s, eps, iters))(scores))
            out["sinkhorn"].append((probs, np.asarray(fn(scores)[1])))
        # the sinkformer model's logits and gradients
        jsink = JViT(cfg=JConfig(**{**SINK_MODEL, "use_flash_attention": False}))
        jparams = C.state_dict_to_flax({k: v.numpy() for k, v in sink_state.items()})["params"]

        def sink_loss(p):
            logits = jsink.apply({"params": p}, jnp.asarray(sink_images), deterministic=True)
            onehot = jax.nn.one_hot(sink_labels, 10)
            return -(jax.nn.log_softmax(logits) * onehot).sum(-1).mean(), logits

        (_, jlogits), jgrads = jax.jit(jax.value_and_grad(sink_loss, has_aux=True))(jparams)
        out["sink_model"] = (np.asarray(jlogits), {
            k: v.numpy() for k, v in C.flax_to_state_dict(
                jax.tree_util.tree_map(np.asarray, jgrads)).items()})
        # the AdaHessian step: the JAX engine with z injected, its D and
        # gradient copied out of the jit
        seen = {"d": [], "g": []}
        orig_est, orig_update = JO.hutchinson_hessian_diag, JE.hessian_aware_update
        leaves = iter(jax.tree_util.tree_leaves(z_tree))

        def keep(key, tree):
            jax.debug.callback(lambda t: seen[key].append(
                {k: v.numpy() for k, v in C.flax_to_state_dict(
                    jax.tree_util.tree_map(np.asarray, t)).items()}), tree)

        def est(grad_fn, p, rng):
            d = orig_est(grad_fn, p, rng)
            keep("d", d)
            return d

        def update(tx, grads, opt_state, p, **kw):
            keep("g", grads)
            return orig_update(tx, grads, opt_state, p, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "rademacher",
                       lambda key, shape, dtype: jnp.asarray(next(leaves), dtype))
            mp.setattr(JO, "hutchinson_hessian_diag", est)
            mp.setattr(JE, "hessian_aware_update", update)
            lr = JS.constant_schedule(LR)
            tx = JO.make_optimizer(params, lr, **OPT)
            jstate = JE.FinetuneState(params=params, opt_state=tx.init(params),
                                      step=jnp.zeros([], jnp.int32))
            jstep = JE.make_finetune_train_step(jmodel, tx, JE.FinetuneHParams(**HP), lr,
                                                use_hessian=True)
            _, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                          jax.random.PRNGKey(0))
            jax.effects_barrier()
        out["hessian"] = (float(jm["loss"]), float(jm["grad_norm"]), seen["d"][0], seen["g"][0])
    finally:
        JFA.BOUNDED_SCORES = prev
        ranks.join()
    if ranks.error is not None:
        raise ranks.error
    out["ranks"] = ranks.result
    return out


@pytest.mark.parametrize("case", range(len(SINKHORN)))
def test_two_rank_sinkhorn_rows_match_jax(runs, case):
    """The ranks' rows of the Sinkhorn plan, concatenated, against JAX's plan
    of the whole sequence (rtol 2e-4 / atol 2e-5), and their gradients of a
    weighted sum (each rank's loss the sum over its rows: the column steps'
    logsumexp hands each rank the others' share) at rtol 1e-3 / atol 1e-4."""
    probs = np.concatenate([r["sinkhorn"][case][0] for r in runs["ranks"]], axis=2)
    grads = np.concatenate([r["sinkhorn"][case][1] for r in runs["ranks"]], axis=2)
    want_probs, want_grads = runs["sinkhorn"][case]
    np.testing.assert_allclose(probs, want_probs, **PROBS)
    np.testing.assert_allclose(grads, want_grads, **GRADS)


def test_sinkhorn_without_a_group_is_the_one_process_plan():
    """Without a group the rows are the whole sequence: the same function as
    before the group argument, to the bit."""
    scores, _ = _scores(2, 2, 7)
    s = torch.from_numpy(scores)
    assert torch.equal(TA.sinkhorn_probs(s, 1.0, 3), TA.sinkhorn_probs(s, 1.0, 3, n_rows=7))


def test_two_rank_sinkformer_model_matches_jax(runs):
    """A 2-deep sinkformer model, its tokens split 3 | 2: both ranks' logits
    and the gradients summed over the group against the JAX model's."""
    jlogits, jgrads = runs["sink_model"]
    for logits, grads in (r["sink_model"] for r in runs["ranks"]):
        np.testing.assert_allclose(logits, jlogits, rtol=2e-4, atol=2e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(g, jgrads[k], err_msg=k, **GRADS)


def test_two_rank_adahessian_step_matches_jax_engine(runs):
    """One AdaHessian finetune step on the seq group against the JAX engine's
    in one process: the loss at rtol 1e-4, the gradient and D = z ⊙ Hz (each
    rank's share summed over the group, as the optimizer sums it) at rtol
    1e-3 / atol 1e-4, the same on both ranks."""
    jloss, jnorm, jd, jg = runs["hessian"]
    for r in runs["ranks"]:
        loss, norm, d, g = r["hessian"]
        assert loss == pytest.approx(jloss, rel=1e-4)
        assert norm == pytest.approx(jnorm, rel=1e-4)
        for k in jd:
            np.testing.assert_allclose(g[k], jg[k], err_msg=k, **STEP)
            np.testing.assert_allclose(d[k], jd[k], err_msg=k, **STEP)
    a, b = (r["hessian"][2] for r in runs["ranks"])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_the_old_gather_backward_misses_the_hold(runs):
    """With the k/v gather's backward as an all-reduce in place (cut off from
    the second backward), the step's loss and gradient are the same but D
    loses every term through the gather: it misses the hold above."""
    jloss, _, jd, jg = runs["hessian"]
    for r in runs["ranks"]:
        loss, _, d, g = r["hessian_old_gather"]
        assert loss == pytest.approx(jloss, rel=1e-4)
        for k in jg:
            np.testing.assert_allclose(g[k], jg[k], err_msg=k, **STEP)
        missed = [k for k in jd if not np.allclose(d[k], jd[k], **STEP)]
        worst = max(float(np.abs(d[k] - jd[k]).max()) / max(float(np.abs(jd[k]).max()), 1e-30)
                    for k in jd)
        assert missed and worst > 10 * STEP["rtol"], (missed, worst)
        assert math.isfinite(worst)
