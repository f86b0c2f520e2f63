"""PyTorch port: the three train engines on a (data × seq × model) mesh of
gloo ranks, against the JAX package's unsharded and sharded steps.

One module fixture starts eight ranks on the CPU once
(``parallel.seq.run_ranks(..., mesh=(2, 2, 2))``) and runs in each the
dry run's engines (``parallel.dryrun.run_engines``): the cyclical step
(target batch norm on, masks whose counts differ between the two data
shards, a clip low enough to fire), the finetune step with batch mixup and
the SNGP head, and the dist triplet step (λ 0.3, the positive distance's
maximum held by data rank 1 only), each from weights crossed from seeded
JAX params. The JAX side runs each step jitted on one CPU device and on
the conftest's eight devices, ``pmesh.create_mesh(8, model_parallel=2,
seq_parallel=2)`` with the tensor-parallel param specs, the batch over
``data`` (the JAX dry run's layout, __graft_entry__.py:73-118). The mixup
draws of the JAX steps are handed to the port's ranks. Tolerances: the
loss and the gradient's global norm at rtol 1e-4 (tests/test_train.py:377,
407), the gathered parameters at rtol 1e-3 / atol 1e-4 where the gradient
is well posed and within 2·lr elsewhere (Adam's first update, as
tests/test_torch_port_train.py holds it). The ranks also take two
mini-steps of the cyclical step at update_freq 2 under momentum, held
against JAX's optax.MultiSteps step.

The JAX side is imported by the fixture ``J``: the ranks import this
module by name and need none of it.
"""

import concurrent.futures
import math
import threading
import types

import numpy as np
import pytest
import torch

from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.evals.calibration import fit_temperature
from uncertainty_vit_tpu_torch.evals.laplace import fit_last_layer_laplace
from uncertainty_vit_tpu_torch.models.dist_vit import DistVisionTransformer
from uncertainty_vit_tpu_torch.ops import losses as TL
from uncertainty_vit_tpu_torch.ops import mixup as TM
from uncertainty_vit_tpu_torch.parallel import dryrun as D
from uncertainty_vit_tpu_torch.parallel import mesh as M
from uncertainty_vit_tpu_torch.parallel import seq
from uncertainty_vit_tpu_torch.utils import checkpoint as C

from torch_threads import one_torch_thread  # noqa: F401  (this process; each rank sets its own)

MESH = (2, 2, 2)
CFG = dict(D.TINY, drop_path_rate=0.0)  # the JAX steps' draws cannot be matched
BATCH = 8
CLIP = 0.05
HP = {"cyclical": dict(target_batch_norm=True, clip_grad=CLIP),
      "dist": dict(lambda_finetuning=0.3, lambda_pvn=0.3)}
RTOL, ATOL = 1e-3, 1e-4
LOSS_RTOL = 1e-4
FT_RNG, DIST_RNG, CYC_RNG = 11, 13, 7
ENGINES = D.ENGINES
# the accumulation case: an optimizer whose update carries the gradient's size
ACC_OPT, ACC_HP = "momentum", dict(target_layers=(0, 1), ema_start_at=10, target_batch_norm=True,
                                   update_freq=2)


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp

    from uncertainty_vit_tpu.core.config import ViTConfig
    from uncertainty_vit_tpu.models.cyclical import CyclicalViT
    from uncertainty_vit_tpu.models.dist_vit import DistVisionTransformer as JDist
    from uncertainty_vit_tpu.models.vit import VisionTransformer
    from uncertainty_vit_tpu.ops import mixup as JM
    from uncertainty_vit_tpu.parallel import mesh as pmesh
    from uncertainty_vit_tpu.train import engine_cyclical as JEC
    from uncertainty_vit_tpu.train import engine_finetune as JEF
    from uncertainty_vit_tpu.train import engine_finetune_dist as JED
    from uncertainty_vit_tpu.train import optim as JO
    from uncertainty_vit_tpu.train import schedules as JS

    return types.SimpleNamespace(jax=jax, jnp=jnp, ViTConfig=ViTConfig, Cyc=CyclicalViT,
                                 Dist=JDist, ViT=VisionTransformer, JM=JM, pmesh=pmesh,
                                 EC=JEC, EF=JEF, ED=JED, O=JO, S=JS)


def _jax_cfgs(J):
    base = J.ViTConfig(**dict(CFG, use_flash_attention=False))
    return {"cyclical": base,
            "finetune": base.replace(num_classes=D.NUM_CLASSES, head_type="sngp"),
            "dist": base.replace(num_classes=D.NUM_CLASSES)}


def _jax_models(J, mesh=None):
    cfgs = _jax_cfgs(J)
    return {"cyclical": J.Cyc(cfg=cfgs["cyclical"], seq_mesh=mesh),
            "finetune": J.ViT(cfg=cfgs["finetune"], seq_mesh=mesh),
            "dist": J.Dist(cfg=cfgs["dist"])}


def _numpy_variables(J, shapes, seed):
    """Seeded values for every leaf: kernels scaled by 1/√fan_in, LayerNorm
    scales near 1, the SNGP buffers as the heads' own (a positive definite
    precision matrix)."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
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

    return J.jax.tree_util.tree_map_with_path(draw, shapes)


def _inputs():
    """The global batch: images, masks whose counts differ between the data
    shards (more masked patches in the first half), labels, and a triplet
    whose positives for the second half are far from their anchors."""
    rs = np.random.RandomState(5)
    images = rs.randn(BATCH, 32, 32, 3).astype(np.float32)
    mask = (rs.rand(BATCH, 4) < 0.35).astype(np.float32)
    mask[:, 1] = 1.0
    mask[: BATCH // 2, 2] = 1.0
    pos = images + 0.01
    pos[BATCH // 2:] = rs.randn(BATCH // 2, 32, 32, 3).astype(np.float32) * 3.0
    neg = rs.randn(BATCH, 32, 32, 3).astype(np.float32)
    labels = rs.randint(0, D.NUM_CLASSES, size=BATCH).astype(np.int64)
    return dict(images=images, mask=mask, labels=labels, pos=pos, neg=neg)


def _jax_batch_draws(J, rng, splits):
    """The batch-mode mixup draws the JAX step makes from ``rng`` at step 0
    (r_mix of split(fold_in(rng, 0), splits); JAX ops/mixup.py:179-202)."""
    jax = J.jax
    r_mix = jax.random.split(jax.random.fold_in(rng, 0), splits)[0]
    r_apply, r_switch, r_lam, r_box = jax.random.split(r_mix, 4)
    ry, rx = jax.random.split(r_box)
    return TM.MixupDraws(bool(jax.random.bernoulli(r_apply, 1.0)),
                         bool(jax.random.bernoulli(r_switch, 0.5)),
                         float(J.JM._beta(r_lam, 0.8)),
                         float(J.JM._beta(jax.random.fold_in(r_lam, 2), 1.0)),
                         int(jax.random.randint(ry, (), 0, 32)),
                         int(jax.random.randint(rx, (), 0, 32)))


def _patched_draws(draws):
    """A stand-in for ``draw_mixup_batch`` handing out ``draws`` in order."""
    queue = list(draws)

    def draw(*args, **kwargs):
        return queue.pop(0)

    return draw


def _plan():
    return D.Plan(MESH, CFG, BATCH, hp=HP)


# the post-hoc fits' data: 16 rows, split 10 | 6 over the data axis
POSTHOC_SPLIT = (slice(0, 10), slice(10, 16))


def _posthoc_data():
    rs = np.random.RandomState(9)
    labels = rs.randint(0, 5, size=16)
    # overconfident logits that mostly point at the label: a curved NLL, its
    # minimum well inside the grid
    logits = 6.0 * np.eye(5)[labels] + 3.0 * rs.randn(16, 5)
    logits = torch.from_numpy(logits.astype(np.float32))
    feats = torch.from_numpy(rs.randn(16, 6).astype(np.float32))
    labels = torch.from_numpy(labels)
    head = {"weight": torch.from_numpy(rs.randn(5, 6).astype(np.float32)),
            "bias": torch.from_numpy(rs.randn(5).astype(np.float32))}
    return logits, feats, labels, head


def _posthoc(rows=slice(None), mesh=None):
    """The Laplace factors' eigenvalues, count and log-likelihood, and the
    temperature, fitted on ``rows`` (batches of 4) of the post-hoc data."""
    logits, feats, labels, head = _posthoc_data()
    logits, feats, labels = logits[rows], feats[rows], labels[rows]
    batches = [((logits[i:i + 4], feats[i:i + 4]), labels[i:i + 4])
               for i in range(0, labels.shape[0], 4)]
    la = fit_last_layer_laplace(lambda x: x, head, batches, mesh)
    t = fit_temperature(logits, labels, device="cpu", mesh=mesh)
    return la.a, la.g, la.n, la.loglik, t


def _accum_batches(images, neg, mask):
    """The two mini-steps of the accumulation case: the images, then the
    negatives with the mask's rows reversed (the data shards' mask counts
    swapped)."""
    return [(images, mask), (neg, mask[::-1].copy() if isinstance(mask, np.ndarray)
                             else mask.flip(0))]


def _accumulated(mesh, payload):
    """The cyclical step at update_freq 2 (momentum, no clip) on this rank's
    rows of two mini-batches: each mini-step's loss, reported norm and the
    axes of the gradient sums so far, then the gathered parameters and
    momentum trace (the window's mean gradient)."""
    from uncertainty_vit_tpu_torch.train import engine_cyclical as EC
    from uncertainty_vit_tpu_torch.train.optim import make_optimizer
    from uncertainty_vit_tpu_torch.train.schedules import constant_schedule

    cfg = _configs_port()["cyclical"]
    model = D._model("cyclical", cfg, "cpu", mesh)
    model.load_state_dict(M.shard_state_dict(payload["states"]["cyclical"], mesh))
    opt = make_optimizer(model, opt_name=ACC_OPT, weight_decay=0.05, layer_decay=0.9,
                         depth=cfg.depth, update_freq=2)
    state = EC.init_cyclical_state(model, opt)
    step = EC.make_cyclical_train_step(model, opt, EC.CyclicalHParams(**ACC_HP),
                                       constant_schedule(D.LR))
    sums, real = [], seq.sum_in_place
    axis = {id(mesh.group(a)): a for a in M.AXES}
    seq.sum_in_place = lambda tensors, group: (sums.append(axis[id(group.group)]),
                                               real(tensors, group))
    out = {"loss": [], "grad_norm": [], "sums": []}
    try:
        for images, mask in _accum_batches(payload["images"], payload["neg"], payload["mask"]):
            m = step(state, M.shard_batch(images, mesh), M.shard_batch(mask, mesh),
                     torch.Generator().manual_seed(CYC_RNG))
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(None if m["grad_norm"] is None else float(m["grad_norm"]))
            out["sums"].append(list(sums))
    finally:
        seq.sum_in_place = real
    out["params"] = C.full_state_dict(model)
    names = [n for n, _ in opt._named]
    out["trace"] = M.gather_state_dict(dict(zip(names, opt._core.trace)), mesh)
    return out


def _mesh_rank(mesh, plan, path, draws):
    """One rank: the engines on the JAX draws, the accumulation case, then
    elem mixup and the post-hoc fits on its rows."""
    torch.set_num_threads(1)
    payload = torch.load(path)
    TM.draw_mixup_batch = _patched_draws(draws)
    out = D.run_engines(mesh, plan, payload, "cpu")
    out["accum"] = _accumulated(mesh, payload)
    x = M.shard_batch(payload["images"], mesh)
    y = M.shard_batch(payload["labels"], mesh)
    out["elem"] = TM.mixup_cutmix(torch.Generator().manual_seed(3), x, y, D.NUM_CLASSES,
                                  prob=0.7, mode="elem", mesh=mesh)
    out["coords"] = tuple(mesh.index(a) for a in M.AXES)
    out["posthoc"] = _posthoc(POSTHOC_SPLIT[mesh.index("data")], mesh)
    return out


@pytest.fixture(scope="module")
def setup(J, tmp_path_factory):
    """(JAX variables and inputs, mixup draws, the port's payload)."""
    jax, jnp = J.jax, J.jnp
    inputs = _inputs()
    models = _jax_models(J)
    variables, states = {}, {}
    cfgs = _configs_port()
    for i, engine in enumerate(ENGINES):
        args = (jnp.asarray(inputs["images"]),)
        if engine == "cyclical":
            args += (jnp.asarray(inputs["mask"]),)
        shapes = jax.eval_shape(models[engine].init, jax.random.PRNGKey(0), *args)
        variables[engine] = _numpy_variables(J, dict(shapes), seed=10 + i)
        port = D._model(engine, cfgs[engine], "cpu")
        C.load_flax_params(port, variables[engine]["params"], variables[engine])
        states[engine] = {k: v.detach().clone() for k, v in port.state_dict().items()}
    draws = [_jax_batch_draws(J, jax.random.PRNGKey(FT_RNG), 6),
             _jax_batch_draws(J, jax.random.PRNGKey(DIST_RNG), 5)]
    payload = {"states": states, **{k: torch.from_numpy(v) for k, v in inputs.items()}}
    path = str(tmp_path_factory.mktemp("mesh") / "payload.pt")
    torch.save(payload, path)
    # the ranks run while this process compiles the JAX steps
    started = _Ranks(path, draws)
    yield variables, inputs, draws, payload, started
    started.thread.join()


class _Ranks:
    """The eight ranks' run, in a thread of this process."""

    def __init__(self, path, draws):
        self.result, self.error = None, None
        self.thread = threading.Thread(target=self._run, args=(path, draws), daemon=True)
        self.thread.start()

    def _run(self, path, draws):
        try:
            self.result = seq.run_ranks(_mesh_rank, 8, _plan(), path, draws, timeout=600.0,
                                        mesh=MESH)
        except BaseException as e:  # raised in the fixture that waits for it
            self.error = e

    def wait(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.result


def _configs_port():
    return D._configs(_plan())


@pytest.fixture(scope="module")
def ranks(setup, jax_steps):
    return setup[4].wait()


@pytest.fixture(scope="module")
def port_ref(setup):
    """The unsharded port in this process on the same draws: its gradients
    say where a parameter's Adam update is well posed."""
    _, _, draws, payload, _ = setup
    saved = TM.draw_mixup_batch
    TM.draw_mixup_batch = _patched_draws(draws)
    try:
        return D.run_engines(None, _plan(), payload, "cpu")
    finally:
        TM.draw_mixup_batch = saved


# XLA's CPU backend without its LLVM optimization passes: the same
# operations, compiled in a fraction of the time
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _run(step, *args):
    return step.lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def _jax_step(J, engine, variables, inputs, sharded):
    """(metrics, new state) of the JAX engine's step from ``variables``, on
    one device or on the eight-device mesh with the tensor-parallel specs."""
    jax, jnp, pmesh = J.jax, J.jnp, J.pmesh
    mesh = pmesh.create_mesh(8, model_parallel=2, seq_parallel=2) if sharded else None
    model = _jax_models(J, mesh)[engine]
    params = variables["params"]
    lr = J.S.constant_schedule(D.LR)
    depth = CFG["depth"]

    def put(tree, spec_tree=None):
        if not sharded:
            return tree
        if spec_tree is None:
            return jax.device_put(tree, pmesh.replicated(mesh))
        return jax.tree_util.tree_map(jax.device_put, tree, spec_tree)

    def batch(name):
        x = jnp.asarray(inputs[name])
        return pmesh.shard_batch(x, mesh) if sharded else x

    shardings = pmesh.param_shardings(params, mesh, tensor_parallel=True) if sharded else None
    if engine == "cyclical":
        tx = J.O.make_optimizer(params, lr, weight_decay=0.05, clip_grad=CLIP, layer_decay=0.9,
                                depth=depth)
        state = J.EC.CyclicalState(params=put(params, shardings), opt_state=put(tx.init(params)),
                                   ema_params=put(jax.tree_util.tree_map(np.copy, params),
                                                  shardings),
                                   step=put(jnp.zeros([], jnp.int32)))
        hp = J.EC.CyclicalHParams(target_layers=(0, 1), ema_start_at=10, target_batch_norm=True)
        step = J.EC.make_cyclical_train_step(model, tx, hp, lr, donate=False)
        state, m = _run(step, state, batch("images"), batch("mask"),
                        jax.random.PRNGKey(CYC_RNG))
    elif engine == "finetune":
        tx = J.O.make_optimizer(params, lr, weight_decay=0.05, layer_decay=0.65, depth=depth)
        state = J.EF.FinetuneState(params=put(params, shardings), opt_state=put(tx.init(params)),
                                   step=put(jnp.zeros([], jnp.int32)),
                                   sngp_state=put(variables["sngp_state"]),
                                   sngp_frozen=put(variables["sngp_frozen"]))
        hp = J.EF.FinetuneHParams(num_classes=D.NUM_CLASSES, num_patches=4, head_type="sngp",
                                  mixup_active=True)
        step = J.EF.make_finetune_train_step(model, tx, hp, lr)
        state, m = _run(step, state, batch("images"), batch("labels"),
                        jax.random.PRNGKey(FT_RNG))
    else:
        tx = J.O.make_optimizer(params, lr, weight_decay=0.05)
        state = J.ED.DistFinetuneState(params=put(params, shardings),
                                       opt_state=put(tx.init(params)),
                                       step=put(jnp.zeros([], jnp.int32)))
        hp = J.ED.DistFinetuneHParams(num_classes=D.NUM_CLASSES, **HP["dist"])
        step = J.ED.make_dist_finetune_train_step(model, tx, hp, lr)
        state, m = _run(step, state, batch("images"), batch("pos"), batch("neg"),
                        batch("labels"), jax.random.PRNGKey(DIST_RNG))
    return ({k: float(v) for k, v in m.items()}, jax.device_get(state))


def _jax_accumulated(J, variables, inputs):
    """The JAX cyclical step at update_freq 2 (optax.MultiSteps over
    momentum, no clip) on one device over the accumulation case's two
    mini-batches: each mini-step's metrics, the state after the window, and
    the momentum trace."""
    import optax

    jax, jnp = J.jax, J.jnp
    params = variables["params"]
    lr = J.S.constant_schedule(D.LR)
    tx = J.O.make_optimizer(params, lr, weight_decay=0.05, layer_decay=0.9, depth=CFG["depth"],
                            opt_name=ACC_OPT, accum_steps=2)
    state = J.EC.CyclicalState(params=params, opt_state=tx.init(params),
                               ema_params=jax.tree_util.tree_map(np.copy, params),
                               step=jnp.zeros([], jnp.int32))
    step = J.EC.make_cyclical_train_step(_jax_models(J)["cyclical"], tx,
                                         J.EC.CyclicalHParams(**ACC_HP), lr, donate=False)
    metrics, compiled = [], None
    for images, mask in _accum_batches(inputs["images"], inputs["neg"], inputs["mask"]):
        args = (state, jnp.asarray(images), jnp.asarray(mask), jax.random.PRNGKey(CYC_RNG))
        compiled = compiled or step.lower(*args).compile(compiler_options=FAST_COMPILE)
        state, m = compiled(*args)
        metrics.append({k: float(v) for k, v in m.items()})
    traces = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    assert len(traces) == 1
    return metrics, jax.device_get(state), jax.device_get(traces[0].trace)


@pytest.fixture(scope="module")
def jax_steps(J, setup):
    """The six JAX steps and the accumulation case, compiled side by side in
    threads (XLA's compiler runs outside the interpreter's lock)."""
    variables, inputs, _, _, _ = setup
    cases = [(engine, sharded) for engine in ENGINES for sharded in (False, True)]
    with concurrent.futures.ThreadPoolExecutor(len(cases) + 1) as pool:
        futures = {c: pool.submit(_jax_step, J, c[0], variables[c[0]], inputs, c[1])
                   for c in cases}
        futures["accum"] = pool.submit(_jax_accumulated, J, variables["cyclical"], inputs)
        return {c: f.result() for c, f in futures.items()}


def _held(got, want, grads, what):
    """Every entry within RTOL / ATOL where the unsharded gradient is above
    1e-6, within 2·lr elsewhere; most entries well posed."""
    posed = total = 0
    for k, w in want.items():
        g = got[k].double().numpy()
        w = np.asarray(w, np.float64)
        grad = grads.get(k)
        well = np.ones_like(g, bool) if grad is None else grad.abs().numpy() > D.WELL_POSED
        np.testing.assert_allclose(g[well], w[well], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")
        assert np.abs(g - w).max(initial=0.0) <= 2 * D.LR, f"{what} {k}"
        posed, total = posed + well.sum(), total + well.size
    assert posed / total > 0.5, what


@pytest.mark.parametrize("sharded", [False, True], ids=["jax_one_device", "jax_mesh"])
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_on_the_mesh_matches_jax(J, setup, ranks, port_ref, jax_steps, engine, sharded):
    """The loss of every rank and rank 0's gathered parameters (the teacher
    too for the cyclical step) after one step on the 2 × 2 × 2 mesh against
    the JAX step, unsharded or on the JAX mesh."""
    metrics, state = jax_steps[(engine, sharded)]
    for r in ranks:
        np.testing.assert_allclose(r[engine]["loss"], metrics["loss"], rtol=LOSS_RTOL)
        assert r[engine]["step"] == 1 and r[engine]["finite"]
    params = ranks[0][engine]["params"]
    grads = port_ref[engine]["grads"]
    _held(params, C.flax_to_state_dict(state.params), grads, engine)
    if engine == "cyclical":
        teacher = {k.removeprefix("teacher."): v for k, v in params.items()
                   if k.startswith("teacher.")}
        _held(teacher, C.flax_to_state_dict(state.ema_params), grads, "teacher")
        np.testing.assert_allclose(ranks[0][engine]["mask_count"], metrics["mask_count"],
                                   rtol=1e-6)


@pytest.mark.parametrize("sharded", [False, True], ids=["jax_one_device", "jax_mesh"])
def test_clip_norm_is_the_global_norm(jax_steps, ranks, sharded):
    """The cyclical step's clip fires (its norm above 0.05) and the reported
    norm, the one the clip reads, is the global gradient's: the squares of
    the model-sharded gradients summed over the model axis, the replicated
    ones once, every share summed over data and seq."""
    metrics, _ = jax_steps[("cyclical", sharded)]
    assert metrics["grad_norm"] > CLIP
    for r in ranks:
        np.testing.assert_allclose(r["cyclical"]["grad_norm"], metrics["grad_norm"], rtol=1e-4)


@pytest.mark.parametrize("sharded", [False, True], ids=["jax_one_device", "jax_mesh"])
@pytest.mark.parametrize("engine", ["finetune", "dist"])
def test_grad_norm_matches_jax(jax_steps, ranks, engine, sharded):
    """The finetune and dist steps' gradient norm on every rank against the
    JAX step's: the parameter holds read little of the gradient's size
    (Adam's first update is about lr·sign(g)); the norm reads it whole, so
    a share summed once too often or too seldom shows here."""
    metrics, _ = jax_steps[(engine, sharded)]
    for r in ranks:
        np.testing.assert_allclose(r[engine]["grad_norm"], metrics["grad_norm"], rtol=1e-4)


def test_accumulation_sums_the_shares_once_a_window(jax_steps, ranks):
    """update_freq 2 on the 2 × 2 × 2 mesh (the cyclical step under
    momentum, two mini-batches whose mask counts differ between the data
    shards) against JAX's optax.MultiSteps step on one device: each
    mini-step's loss; the seq group's sum runs every mini-step (it
    completes the mini-step's gradient of the token-sharded model) and the
    data group's once, at the window's end; the first mini-step reports no
    norm and the second the window mean's, the norm of JAX's momentum
    trace; the gathered trace (the window's mean gradient, which a momentum
    step carries into the parameters at its size) and the parameters after
    the update."""
    metrics, state, trace = jax_steps["accum"]
    want = {k: np.asarray(v, np.float64) for k, v in C.flax_to_state_dict(trace).items()}
    norm = math.sqrt(sum(float((v * v).sum()) for v in want.values()))
    for r in ranks:
        acc = r["accum"]
        np.testing.assert_allclose(acc["loss"], [m["loss"] for m in metrics], rtol=LOSS_RTOL)
        assert acc["sums"] == [["seq"], ["seq", "seq", "data"]]
        assert acc["grad_norm"][0] is None
        np.testing.assert_allclose(acc["grad_norm"][1], norm, rtol=1e-4)
    acc = ranks[0]["accum"]
    assert set(acc["trace"]) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(acc["trace"][k].double().numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(initial=0.0) + 1e-12, err_msg=k)
    for k, w in C.flax_to_state_dict(state.params).items():
        np.testing.assert_allclose(acc["params"][k].double().numpy(), np.asarray(w, np.float64),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("sharded", [False, True], ids=["jax_one_device", "jax_mesh"])
def test_sngp_precision_after_one_step_matches_jax(setup, jax_steps, ranks, sharded):
    """The precision matrix after the finetune step: φᵀφ / B over the global
    batch of eight, summed over the data axis, equal on every rank."""
    _, state = jax_steps[("finetune", sharded)]
    want = np.asarray(state.sngp_state["head"]["precision_matrix"])
    got = ranks[0]["finetune"]["params"]["head.precision_matrix"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert ranks[0]["finetune"]["precision_moved"] > 0


def test_the_draws_reach_every_case(setup):
    """The inputs hold what the cases need: masks of unequal counts on the
    two data shards, and the positive distance's maximum on data rank 1's
    rows only (the dist model's pooled features, before the step)."""
    _, inputs, draws, payload, _ = setup
    counts = inputs["mask"].reshape(2, -1).sum(axis=1)
    assert counts[0] != counts[1]
    assert draws[0].apply and draws[1].apply
    model = DistVisionTransformer(TViTConfig(**dict(CFG, num_classes=D.NUM_CLASSES,
                                                    use_flash_attention=False)), device="cpu")
    model.load_state_dict(payload["states"]["dist"])
    model.eval()
    with torch.no_grad():
        images, targets = TM.mix_batch(payload["images"], payload["labels"], D.NUM_CLASSES, 0.1,
                                       draws[1])
        mean, cov, _ = model(images)
        pmean, pcov, _ = model(payload["pos"])
    s = torch.sigmoid
    d = TL.wasserstein_distance(s(mean), s(cov), s(pmean), s(pcov))
    assert (d == d.max())[BATCH // 2:].any() and not (d == d.max())[: BATCH // 2].any()


def test_sharded_steps_equal_the_unsharded_port(ranks, port_ref):
    """The mesh's step against the port's own unsharded step on the same
    draws (the dry run's hold), and every rank's loss equal."""
    for engine in ENGINES:
        res = D.compare(port_ref[engine], ranks[0][engine])
        assert res["ok"], (engine, res)
        assert len({r[engine]["loss"] for r in ranks}) == 1, engine


def test_elem_mixup_pairs_rows_across_data_ranks(setup, ranks):
    """elem mixup on the mesh: each data rank's rows, put together, equal
    the unsharded mix of the global batch from the same seed (the partner
    of row i is row B−1−i, on the other data rank)."""
    _, _, _, payload, _ = setup
    want_x, want_t = TM.mixup_cutmix(torch.Generator().manual_seed(3), payload["images"],
                                     payload["labels"], D.NUM_CLASSES, prob=0.7, mode="elem")
    shards = {}
    for r in ranks:
        shards.setdefault(r["coords"][0], r["elem"])
    got_x = torch.cat([shards[d][0] for d in range(MESH[0])])
    got_t = torch.cat([shards[d][1] for d in range(MESH[0])])
    assert torch.equal(got_x, want_x)
    assert torch.equal(got_t, want_t)


def test_no_kernel_launches_on_the_cpu(ranks):
    """The CPU ranks run the kernels' plain versions, which count nothing."""
    for r in ranks:
        for engine in ENGINES:
            assert r[engine]["launches"] == {"K1": 0, "K2": 0, "K5": 0}


def test_mesh_layout_is_jax_device_order():
    """rank = d·s·m + q·m + t: JAX's devices.reshape(n // (m·s), s, m)
    (parallel/mesh.py:115-118), and the slices of each axis."""
    grid = np.arange(8).reshape(2, 2, 2)
    for r in range(8):
        assert tuple(np.argwhere(grid == r)[0]) == M.coords(r, (2, 2, 2))
    assert M.axis_slices((2, 2, 2), "model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert M.axis_slices((2, 2, 2), "seq") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert M.axis_slices((2, 2, 2), "data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert M.axis_slices((4, 1, 2), "data") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert D.mesh_shape(8) == (2, 2, 2) and D.mesh_shape(4) == (1, 2, 2)
    assert D.mesh_shape(6) == (3, 1, 2) and D.mesh_shape(3) == (3, 1, 1)


@pytest.mark.parametrize("model_size", [2, 4])
def test_param_specs_cut_whole_heads(model_size):
    """qkv's q, k and v each cut into contiguous head groups, the biases and
    rel-pos columns alike, fc1 on dim 0, proj / fc2 on dim 1, the rest
    whole; the pieces put back give the full tensor."""
    cfg = TViTConfig(**dict(CFG, num_heads=4, use_shared_rel_pos_bias=True,
                            use_rel_pos_bias=True))
    model = D._model("finetune", cfg.replace(num_classes=5, head_type="sngp"), "cpu")
    state = model.state_dict()
    cut = {k for k in state if M.param_spec(k) is not None}
    assert "patch_embed.proj.weight" not in cut and "head._gp_output_layer.weight" not in cut
    assert {"blocks.0.attn.qkv.weight", "blocks.0.attn.q_bias", "blocks.0.attn.v_bias",
            "blocks.0.attn.proj.weight", "blocks.0.mlp.fc1.weight", "blocks.0.mlp.fc1.bias",
            "blocks.0.mlp.fc2.weight", "rel_pos_bias.relative_position_bias_table",
            "blocks.0.attn.relative_position_bias_table"} <= cut
    assert "blocks.0.attn.proj.bias" not in cut and "blocks.0.mlp.fc2.bias" not in cut
    qkv = state["blocks.0.attn.qkv.weight"]
    c, hd = cfg.embed_dim, cfg.embed_dim // 4
    heads = 4 // model_size
    for t in range(model_size):
        piece = M.shard_tensor(qkv, M.param_spec("blocks.0.attn.qkv.weight"), t, model_size)
        want = torch.cat([qkv[j * c + t * heads * hd: j * c + (t + 1) * heads * hd]
                          for j in range(3)])
        assert torch.equal(piece, want)
    for k in cut:
        spec = M.param_spec(k)
        pieces = [M.shard_tensor(state[k], spec, t, model_size) for t in range(model_size)]
        assert torch.equal(M.unshard_tensor(pieces, spec), state[k]), k


def test_global_batch_helpers_without_a_mesh():
    """Without a mesh the helpers are the plain ops."""
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(M.flip_batch(x, None), x.flip(0))
    assert torch.equal(M.shard_batch(x, None), x)
    assert torch.equal(M.global_max(x, None), x.max())
    assert torch.equal(M.sum_over(x, None), x)
    mesh = M.Mesh((2, 2, 1), rank=3)
    assert mesh.batch_rows(4) == (4, 8, 8) and M.shard_batch(torch.arange(8), mesh).tolist() == [
        4, 5, 6, 7]
    assert M.shard_batch(torch.arange(8), mesh, include_seq=True).tolist() == [6, 7]


def test_posthoc_fits_sum_over_the_data_axis(ranks):
    """The Laplace factor sums, log-likelihood and count and the
    temperature's NLL curve summed over the data axis (JAX evals/
    laplace.py:117-136, calibration.py:51-61): shards of 10 and 6 rows give
    every rank the unsharded fit of all 16."""
    a, g, n, loglik, t = _posthoc()
    for r in ranks:
        ra, rg, rn, rloglik, rt = r["posthoc"]
        assert rn == n == 16
        np.testing.assert_allclose(ra.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rg.numpy(), g.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rloglik, loglik, rtol=1e-5)
        assert rt == pytest.approx(t, rel=1e-6)
