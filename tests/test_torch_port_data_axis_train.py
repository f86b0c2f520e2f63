"""PyTorch port: the finetune driver's data axis with nothing refused
(slice 19): attention dropout, the AdaHessian pass and ``--stochastic`` on
a data axis, against one process given the global batch, against the JAX
package, and what still raises.

- Attention dropout: the mask bits through a data rank's batch fold (b, B,
  off) are one process's rows, in a plain batch, in the folded MC-dropout
  batch and in the split one's tiled trunk (``ops/philox.py``, the plain
  versions of K1-K4, the model's MC forwards); a training step on (2, 1, 1)
  with attention dropout equals one process's, and at rate 0 the JAX
  engine's.
- AdaHessian: steps on (2, 1, 1) and (2, 2, 1) against the JAX engine in one
  process with an injected Rademacher z (as tests/test_torch_port_adahessian.py
  injects it); the same step with each rank's Hz share left unsummed over
  the data group misses the hold. The dist engine's pass on (2, 1, 1)
  against the port's one process, and with the global max's backward as it
  stood before slice 19 (an all-reduce outside the graph), which misses it.
- ``--stochastic``: the triplet loader's shards against the JAX package's
  ``TripletDataset`` read in one process's order; two epochs of the driver
  on (2, 1, 1) against one process (``BatchLoader(hosts_per_batch=2)``),
  and ``--eval --stochastic`` against one process and the JAX driver.

One module fixture starts four gloo ranks once (``parallel.seq.run_ranks``)
as the mesh (2, 2, 1); each case runs there or on each seq index's data
pair as a (2, 1, 1) mesh. The models are narrow: width 64 in one head of 64
(the attention kernels' route, their plain versions on the CPU), depth 2;
the driver's dist runs take ``beit_test_patch16_32``. The ranks import this
module by name, so it imports JAX only inside fixtures.
"""

import contextlib
import functools
import io
import json
import math
import os
import pickle
import threading
import types

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)
from uncertainty_vit_tpu_torch.cli import builders as TB
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.data import datasets as TD
from uncertainty_vit_tpu_torch.data.pipeline import BatchLoader
from uncertainty_vit_tpu_torch.evals.mc_dropout import make_mc_dropout_forward
from uncertainty_vit_tpu_torch.models.dist_vit import DistVisionTransformer
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.ops import philox as P
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
from uncertainty_vit_tpu_torch.parallel import seq
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import engine_finetune_dist as TED
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils import checkpoint as C

# width 64 in one head of 64 (the attention kernels' route), 16x16 images of
# 8x8 patches: 5 tokens, split 3 | 2 over a seq pair
SMALL = dict(img_size=16, patch_size=8, embed_dim=64, depth=2, num_heads=1, init_values=0.1,
             use_shared_rel_pos_bias=True, use_abs_pos_emb=False, num_classes=10)
BATCH, DATA = 4, 2  # the global batch over the data axis
HP = dict(num_classes=10, mixup_active=False, label_smoothing=0.1)
OPT = dict(weight_decay=0.05, clip_grad=3.0, layer_decay=0.75, depth=2)
LR = 1e-4
ATTN_DROP = 0.05
MESHES = {"m221": (2, 2, 1), "m211": (2, 1, 1)}
# the ranks against one process: f32 sums in another order
STEP_RTOL = 1e-4
# against the JAX engine: the loss at the forward's tolerance, the gradients
# and D at the backward's (and D's own hold, tests/test_torch_port_optim_chain.py)
FWD = dict(rtol=2e-4, atol=2e-5)
BWD = dict(rtol=1e-3, atol=1e-4)
# the dist pass on the ranks against one process's: max|ΔD| / max|D| (f32
# sums in another order: read 3.1e-7 here; the global max's backward of
# before slice 19 read 2.1e-4)
DIST_D_REL = 1e-5
# the driver's dist runs
N_TRAIN, N_TEST, DIST_BATCH = 11, 8, 2
METRIC_ATOL = 1e-4


def _data_pair(mesh):
    """The (2, 1, 1) mesh of this rank's seq index: the data axis's ranks."""
    group = mesh.group(meshlib.DATA_AXIS)
    return meshlib.Mesh((mesh.size("data"), 1, 1), mesh.index("data"), (group, None, None), group)


def _rows(mesh):
    if mesh is None:
        return slice(None)
    b = BATCH // mesh.size("data")
    return slice(mesh.index("data") * b, (mesh.index("data") + 1) * b)


def _model(state, mesh, **cfg):
    model = VisionTransformer(TViTConfig(**dict(SMALL, **cfg)), device="cpu", mesh=mesh)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model


@contextlib.contextmanager
def _kept_hessians(out):
    """Each optimizer step's Hessian estimate, after the step (summed over
    the ranks there), appended to ``out``."""
    real = TO.ChainOptimizer.step

    def step(self, lr, wd, hessian=None):
        norm = real(self, lr, wd, hessian)
        if hessian is not None:
            out.append([h.detach().clone() for h in hessian])
        return norm

    TO.ChainOptimizer.step = step
    try:
        yield
    finally:
        TO.ChainOptimizer.step = real


@contextlib.contextmanager
def _injected_z(z, names):
    """The Hutchinson pass draws ``z`` (name → array) for the parameters
    ``names``, in order."""
    real = TO.draw_rademacher
    TO.draw_rademacher = lambda params, gen: [torch.from_numpy(z[n]) for n in names]
    try:
        yield
    finally:
        TO.draw_rademacher = real


@contextlib.contextmanager
def _hz_unsummed_over_data():
    """The mutation: each rank's share of D is not summed over the data
    group (the gradient still is)."""
    real_est, real_sum = TO.hutchinson_hessian_diag, meshlib.GradReducer.sum_data
    mine = []

    def est(*a, **k):
        d = real_est(*a, **k)
        mine.append(d)
        return d

    def sum_data(self, tensors):
        if not any(tensors is d for d in mine):
            real_sum(self, tensors)

    TO.hutchinson_hessian_diag, meshlib.GradReducer.sum_data = est, sum_data
    try:
        yield
    finally:
        TO.hutchinson_hessian_diag, meshlib.GradReducer.sum_data = real_est, real_sum


def _finetune_step(data, mesh=None, hessian=False, attn_drop=0.0):
    """One finetune step (AdaHessian with ``hessian``) of this rank's rows of
    the global batch: loss, grad norm, the summed gradients, D and the
    parameters after, by name."""
    images, labels = data["batch"]
    model = _model(data["state"], mesh, attn_drop_rate=attn_drop)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    # AdamW clips the gradients in place: its steps run unclipped, so that
    # the summed gradient stays readable after the step
    opt = TO.make_optimizer(model, opt_name="adahessian" if hessian else "adamw",
                            **dict(OPT, clip_grad=OPT["clip_grad"] if hessian else None))
    step = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**HP),
                                       TS.constant_schedule(LR), use_hessian=hessian)
    gens = TE.step_generators(0, 0, "cpu", hessian=hessian)
    ds = []
    with _kept_hessians(ds), _injected_z(data["z"], names):
        m = step(TE.init_finetune_state(model, opt), torch.from_numpy(images[_rows(mesh)]),
                 torch.from_numpy(labels[_rows(mesh)]), gens.model,
                 hessian_generator=gens.hessian)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            "d": {n: d.numpy() for n, d in zip(names, ds[0])} if ds else None,
            "params": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}


def _old_global_max_backward(ctx, grad):
    """The global max's backward before slice 19: the ranks' cotangents
    summed by an all-reduce outside the graph, which a second backward
    cannot see through (the mutation)."""
    hit, ties = ctx.saved_tensors
    for g in ctx.groups:
        grad = meshlib._all_reduce(grad, g.group)
    return hit.to(grad.dtype) * (grad / ties), None


def _dist_step(data, mesh=None):
    """One AdaHessian step of the dist engine on this rank's rows of the
    global triplet batch: loss and D by name."""
    images, pos, neg, labels = data["triplets"]
    model = DistVisionTransformer(TViTConfig(**SMALL), device="cpu", mesh=mesh)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in data["dist_state"].items()},
                          strict=True)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    opt = TO.make_optimizer(model, opt_name="adahessian", **OPT)
    step = TED.make_dist_finetune_train_step(model, opt, TED.DistFinetuneHParams(**HP),
                                             TS.constant_schedule(LR), use_hessian=True)
    gens = TE.step_generators(0, 0, "cpu", hessian=True)
    sl = _rows(mesh)
    ds = []
    with _kept_hessians(ds), _injected_z(data["dist_z"], names):
        m = step(TE.init_finetune_state(model, opt), *(torch.from_numpy(a[sl]) for a in
                                                       (images, pos, neg, labels)),
                 gens.model, hessian_generator=gens.hessian)
    return {"loss": float(m["loss"]), "d": {n: d.numpy() for n, d in zip(names, ds[0])}}


def _dist_argv(root, name, batch, *extra, train=False):
    return ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
            "--data_path", root, "--batch_size", str(batch), "--num_workers", "0",
            "--dtype", "float32", "--output_dir", os.path.join(root, name),
            "--finetune", os.path.join(root, "dist.pth"), "--no_auto_resume", "--stochastic",
            *([] if train else ["--eval"]), *extra]


DIST_TRAIN = ["--epochs", "2", "--warmup_epochs", "1", "--save_ckpt_freq", "1",
              "--attn_drop_rate", "0.1", "--drop", "0.1", "--drop_path", "0.1"]


def _rank_cases(mesh, data):
    """Every case, in one rank of the (2, 2, 1) mesh."""
    torch.set_num_threads(1)
    pair = _data_pair(mesh)
    out = {"attn_drop": _finetune_step(data, pair, attn_drop=ATTN_DROP),
           "attn0": _finetune_step(data, pair),
           "hessian_m221": _finetune_step(data, mesh, hessian=True),
           "hessian_m211": _finetune_step(data, pair, hessian=True),
           "dist": _dist_step(data, pair)}
    with _hz_unsummed_over_data():
        out["hessian_unsummed"] = _finetune_step(data, pair, hessian=True)
    backward = meshlib._GlobalMax.backward
    meshlib._GlobalMax.backward = staticmethod(_old_global_max_backward)
    try:
        out["dist_old_max"] = _dist_step(data, pair)
    finally:
        meshlib._GlobalMax.backward = backward
    tag = f"_seq{mesh.index('seq')}"
    with contextlib.redirect_stdout(io.StringIO()):
        state = TFT.run_rank(pair, TFT.get_args_parser().parse_args(
            _dist_argv(data["root"], "stochastic" + tag, DIST_BATCH, *DIST_TRAIN, train=True)),
            "cpu")
        out["stochastic_eval"] = TFT.run_rank(pair, TFT.get_args_parser().parse_args(
            _dist_argv(data["root"], "stochastic_eval" + tag, DIST_BATCH)), "cpu")
        out["stochastic_corrupted"] = TFT.run_rank(pair, TFT.get_args_parser().parse_args(
            _dist_argv(data["root"], "stochastic_c" + tag, DIST_BATCH, *_corrupted(data))),
            "cpu")
    out["stochastic_train"] = None if state is None else {
        k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()}
    return out, (mesh.index("data"), mesh.index("seq"))


def _corrupted(data):
    return ["--corrupted_data", "--corruption_data_path", os.path.join(data["root"], "cifar-c")]


def _write_cifar(root):
    base = os.path.join(root, "cifar-100-python")
    os.makedirs(base, exist_ok=True)
    rs = np.random.RandomState(19)
    for name, n in (("train", N_TRAIN), ("test", N_TEST)):
        data = rs.randint(0, 256, (n, 3072), dtype=np.uint8)
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": (np.arange(n) % 100).tolist()}, f)


def _z_of(state, seed):
    rs = np.random.RandomState(seed)
    return {k: rs.choice([-1.0, 1.0], size=v.shape).astype(np.float32)
            for k, v in state.items()}


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules, its Pallas kernels in interpret mode and the
    exact softmax in both packages."""
    import jax
    import jax.numpy as jnp

    import uncertainty_vit_tpu.ops.flash_attention as JFA
    from uncertainty_vit_tpu.cli import finetune as JFT
    from uncertainty_vit_tpu.core.config import ViTConfig
    from uncertainty_vit_tpu.data import datasets as JD
    from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
    from uncertainty_vit_tpu.train import engine_finetune, optim, schedules

    prev = (JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES)
    JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = True, False, False
    yield types.SimpleNamespace(jax=jax, jnp=jnp, FA=JFA, FT=JFT, D=JD, ViTConfig=ViTConfig,
                                ViT=JViT, E=engine_finetune, O=optim, S=schedules)
    JFA.INTERPRET, JFA.BOUNDED_SCORES, TFA.BOUNDED_SCORES = prev


def _numpy_params(jax, shapes, seed):
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if "kernel" in name:
            return (rs.randn(*leaf.shape) / math.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        return (0.2 * rs.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def runs(J, tmp_path_factory):
    """(inputs, JAX params, each rank's results) of one run of four ranks."""
    root = str(tmp_path_factory.mktemp("data_axis_train"))
    _write_cifar(root)
    rs = np.random.RandomState(0)
    images = rs.randn(BATCH, 16, 16, 3).astype(np.float32)
    labels = np.array([1, 3, 5, 7])
    jmodel = J.ViT(cfg=J.ViTConfig(**SMALL, use_flash_attention=False))
    shapes = J.jax.eval_shape(jmodel.init, J.jax.random.PRNGKey(0),
                              J.jnp.asarray(images))["params"]
    params = _numpy_params(J.jax, shapes, 1)
    state = {k: v.numpy() for k, v in C.flax_to_state_dict(params).items()}
    dist = DistVisionTransformer(TViTConfig(**SMALL), device="cpu",
                                 generator=torch.Generator().manual_seed(4))
    dist_state = {k: v.detach().numpy().copy() for k, v in dist.state_dict().items()}
    triplets = tuple(rs.randn(BATCH, 16, 16, 3).astype(np.float32) for _ in range(3)) + (labels,)
    cfg = get_preset("beit_test_patch16_32", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)
    gen = torch.Generator().manual_seed(1)
    pth = DistVisionTransformer(cfg, device="cpu", generator=gen)
    with torch.no_grad():  # logits well apart, a rel-pos bias that is not zero
        pth.head.weight.normal_(0.0, 0.5, generator=gen)
        pth.rel_pos_bias.relative_position_bias_table.normal_(0.0, 0.2, generator=gen)
    torch.save({"model": pth.state_dict()}, os.path.join(root, "dist.pth"))
    os.makedirs(os.path.join(root, "cifar-c"))  # two distortions of 16 images
    np.save(os.path.join(root, "cifar-c", "labels.npy"), np.arange(16) % 100)
    for name in ("gaussian_noise", "contrast"):
        np.save(os.path.join(root, "cifar-c", f"{name}.npy"),
                rs.randint(0, 256, (16, 32, 32, 3), dtype=np.uint8))
    data = {"batch": (images, labels), "state": state, "z": _z_of(state, 9), "root": root,
            "triplets": triplets, "dist_state": dist_state, "dist_z": _z_of(dist_state, 10)}
    ranks = _Ranks(data)
    ranks.start()
    try:  # one process's runs while the ranks run
        data["one"] = _one_process_runs(J, data, params)
    finally:
        ranks.join()
    if ranks.error is not None:
        raise ranks.error
    return data, params, ranks.result


class _Ranks(threading.Thread):
    def __init__(self, data):
        super().__init__(daemon=True)
        self.data, self.result, self.error = data, None, None

    def run(self):
        try:
            self.result = seq.run_ranks(_rank_cases, 4, self.data, timeout=600.0,
                                        mesh=MESHES["m221"])
        except BaseException as e:  # raised in the fixture
            self.error = e


def _one_process_runs(J, data, params):
    """The references in one process: the JAX engine's AdaHessian step on
    the global batch (z injected), the port driver's two --stochastic epochs
    with a batch of 2 · --batch_size over the ranks' global batches
    (``BatchLoader(hosts_per_batch=2)``), and its --eval --stochastic and
    the JAX driver's."""
    images, labels = data["batch"]
    out = {}
    z = C.state_dict_to_flax({k: torch.from_numpy(v) for k, v in data["z"].items()})["params"]
    assert J.jax.tree_util.tree_structure(z) == J.jax.tree_util.tree_structure(params)
    leaves = iter(J.jax.tree_util.tree_leaves(z))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J.jax.random, "rademacher",
                   lambda key, shape, dtype: J.jnp.asarray(np.asarray(next(leaves)), dtype))
        out["jax_hessian"] = _jax_step(J, params, images, labels)
    train = _dist_argv(data["root"], "stochastic_one", DATA * DIST_BATCH, *DIST_TRAIN, train=True)
    evals = _dist_argv(data["root"], "stochastic_eval_one", DATA * DIST_BATCH)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        mp.setattr(J.FA, "BOUNDED_SCORES", J.FA.BOUNDED_SCORES)
        mp.delenv("UVIT_ATTN_BOUNDED_SCORES", raising=False)
        with contextlib.redirect_stdout(io.StringIO()):
            out["jax_eval"] = J.FT.main(J.FT.get_args_parser().parse_args(evals))["dist_eval"]
            mp.setattr(TB, "BatchLoader", functools.partial(BatchLoader, hosts_per_batch=DATA))
            state = TFT.main(TFT.get_args_parser().parse_args(train), device="cpu")
            out["train"] = {k: v.detach().numpy().copy() for k, v in
                            state.model.state_dict().items()}
            out["eval"] = TFT.main(TFT.get_args_parser().parse_args(evals),
                                   device="cpu")["dist_eval"]
            mp.setattr(TB, "BatchLoader", BatchLoader)
            out["corrupted"] = TFT.main(TFT.get_args_parser().parse_args(_dist_argv(
                data["root"], "stochastic_c_one", DIST_BATCH, *_corrupted(data))), device="cpu")
    return out


# ---------------------------------------------------------------------------
# attention dropout through the batch fold
# ---------------------------------------------------------------------------

FOLDS = ((1, 2, 2, 5), (3, 2, 2, 7), (2, 3, 2, 4))  # (k folds, b a rank, D ranks, tokens)


@pytest.mark.parametrize("k,b,d_size,n", FOLDS)
def test_attention_bits_through_the_fold_are_one_process_rows(k, b, d_size, n):
    """A data rank's images of a batch tiled k times (the folded MC-dropout
    batch; k = 1 a plain batch) under the fold (b, D·b, d·b) draw the bits
    of one process's images k'·D·b + d·b + i, and the plain forward and
    backward of K1-K4 through the fold are one process's rows, to the bit."""
    h = 2
    seed = torch.tensor([0x51DE], dtype=torch.int64)
    whole = P.attention_bits(seed, k * d_size * b, h, n, n)
    gen = torch.Generator().manual_seed(n)
    qkv = torch.randn(k * d_size * b, n, 3 * h * 64, generator=gen)
    g = torch.randn(k * d_size * b, n, h * 64, generator=gen)
    out_w, lse_w = TFA.fused_qkv_attention_plain(qkv, None, None, 0.125, h, bounded_scores=False,
                                                 seed=seed, dropout_rate=0.3)
    dq_w, _, _ = TFA.fused_qkv_attention_bwd_plain(qkv, None, None, lse_w, g, 0.125, h,
                                                   out=out_w, seed=seed, dropout_rate=0.3)
    for d in range(d_size):
        fold = (b, d_size * b, d * b)
        rows = P.fold_images(k * b, fold)
        index, total = meshlib.fold_index(k * b, (d * b, (d + 1) * b, d_size * b))
        assert torch.equal(rows, index) and total == k * d_size * b
        assert torch.equal(P.attention_bits(seed, k * b, h, n, n, fold=fold), whole[rows])
        assert torch.equal(P.attention_bits(seed, k * b, h, 2, 2, row0=1, col0=2, fold=fold),
                           whole[rows, :, 1:3, 2:4])
        out, lse = TFA.fused_qkv_attention_plain(qkv[rows], None, None, 0.125, h,
                                                 bounded_scores=False, seed=seed,
                                                 dropout_rate=0.3, fold=fold)
        assert torch.equal(out, out_w[rows]) and torch.equal(lse, lse_w[rows])
        dq, _, _ = TFA.fused_qkv_attention_bwd_plain(qkv[rows], None, None, lse, g[rows], 0.125,
                                                     h, out=out, seed=seed, dropout_rate=0.3,
                                                     fold=fold)
        assert torch.equal(dq, dq_w[rows])
    with pytest.raises(ValueError, match="fold"):
        P.attention_bits(seed, 3, h, n, n, fold=(2, 4, 0))
    with pytest.raises(ValueError, match="fold"):
        TFA.fused_qkv_attention_plain(qkv[:3], None, None, 0.125, h, bounded_scores=False,
                                      seed=seed, dropout_rate=0.3, fold=(2, 4, 0))


@pytest.mark.parametrize("split", [0, 1])
def test_mc_forward_with_attention_dropout_draws_the_global_masks(split):
    """Folded and split MC-dropout forwards with attention dropout on a data
    axis (a mesh built without a process group: its draws need none) keep
    the rows of the global batch's forward in each fold: K1's masks keyed
    through the fold, K8's likewise."""
    cfg = TViTConfig(**dict(SMALL, drop_rate=0.2, attn_drop_rate=0.3, init_values=1.0))
    gen = torch.Generator().manual_seed(2)
    full = VisionTransformer(cfg, device="cpu", generator=gen)
    with torch.no_grad():  # logits well apart
        full.head.weight.normal_(0.0, 0.5, generator=gen)
    assert all(blk.attn.use_kernel for blk in full.blocks)
    images = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(3))
    want = make_mc_dropout_forward(full, 3, split_at=split)(images,
                                                            torch.Generator().manual_seed(4))
    scale = want.abs().max().item()
    for d in range(2):
        part = VisionTransformer(cfg, device="cpu", mesh=meshlib.Mesh((2, 1, 1), d))
        part.load_state_dict(full.state_dict())
        got = make_mc_dropout_forward(part, 3, split_at=split)(
            images[2 * d:2 * d + 2], torch.Generator().manual_seed(4))
        torch.testing.assert_close(got, want[:, 2 * d:2 * d + 2], rtol=0, atol=1e-5 * scale)


def _close_step(got, want, rtol):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=rtol)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=rtol)
    for k, v in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], v, rtol=rtol,
                                   atol=rtol * max(np.abs(v).max(), 1e-30), err_msg=k)


def test_attention_dropout_step_on_the_data_axis_equals_one_process(runs):
    """A training step with attention dropout 0.05 on (2, 1, 1) against the
    same step in one process with the global batch: loss, grad norm and
    every summed gradient within rtol 1e-4 (the masks one process's: K1 and
    K2 key them through the rank's fold), every rank's parameters equal."""
    data, _, results = runs
    one = _finetune_step(data, attn_drop=ATTN_DROP)
    zero = _finetune_step(data)
    for res, _ in results:
        _close_step(res["attn_drop"], one, STEP_RTOL)
        for k, v in res["attn_drop"]["params"].items():
            assert np.array_equal(v, results[0][0]["attn_drop"]["params"][k]), k
    # the rate takes effect: the step without dropout is another step
    assert abs(one["loss"] - zero["loss"]) > 1e-3 * abs(zero["loss"])


def _jax_step(J, params, images, labels):
    """The JAX engine's AdaHessian step in one process on the global batch:
    (metrics, {"g": [its gradient], "d": [D]} by the port's names). The
    Rademacher z is injected by the caller."""
    jax, jnp = J.jax, J.jnp
    seen = {"d": [], "g": []}
    orig_est, orig_update = J.O.hutchinson_hessian_diag, J.E.hessian_aware_update

    def keep(key, tree):
        jax.debug.callback(lambda t: seen[key].append(C.flax_to_state_dict(
            jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t))), tree)

    def est(grad_fn, p, rng):
        d = orig_est(grad_fn, p, rng)
        keep("d", d)
        return d

    def update(tx, grads, opt_state, p, **kw):
        keep("g", grads)
        return orig_update(tx, grads, opt_state, p, **kw)

    jmodel = J.ViT(cfg=J.ViTConfig(**SMALL, use_flash_attention=False))
    lr = J.S.constant_schedule(LR)
    tx = J.O.make_optimizer(params, lr, opt_name="adahessian", **OPT)
    state = J.E.FinetuneState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros([], jnp.int32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J.O, "hutchinson_hessian_diag", est)
        mp.setattr(J.E, "hessian_aware_update", update)
        step = J.E.make_finetune_train_step(jmodel, tx, J.E.FinetuneHParams(**HP), lr,
                                            use_hessian=True)
        _, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                          jax.random.PRNGKey(0))
        jax.effects_barrier()
    return metrics, seen


@pytest.fixture(scope="module")
def jax_hessian_step(runs):
    """The JAX engine's AdaHessian step on the global batch, z injected."""
    return runs[0]["one"]["jax_hessian"]


def test_rate_zero_step_on_the_data_axis_matches_the_jax_engine(runs, jax_hessian_step):
    """At attention-dropout rate 0 the (2, 1, 1) step (the kernels' route,
    through the rank's fold) against the JAX engine's step in one process:
    the loss at the forward's tolerance, every summed gradient at the
    backward's."""
    data, _, results = runs
    metrics, seen = jax_hessian_step
    for res, _ in results:
        got = res["attn0"]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), **FWD)
        for k, v in seen["g"][0].items():
            np.testing.assert_allclose(got["grads"][k], v.numpy(), err_msg=k, **BWD)


# ---------------------------------------------------------------------------
# the AdaHessian pass on the data axis
# ---------------------------------------------------------------------------

def _held_d(got, want):
    """Whether D by name holds against the JAX engine's (BWD)."""
    return all(np.allclose(got[k], v.numpy(), **BWD) for k, v in want.items())


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_adahessian_on_the_data_axis_matches_the_jax_engine(runs, jax_hessian_step, mesh):
    """The finetune engine's AdaHessian step on the mesh (the same injected z
    on every rank; each rank's share of D summed over the seq and data
    groups) against the JAX engine's in one process with the global batch:
    the loss within rtol 1e-4, the summed gradient and D within rtol 1e-3
    (atol 1e-4)."""
    data, _, results = runs
    metrics, seen = jax_hessian_step
    assert len(seen["d"]) == len(seen["g"]) == 1
    for res, _ in results:
        got = res[f"hessian_{mesh}"]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=STEP_RTOL)
        for k, v in seen["g"][0].items():
            np.testing.assert_allclose(got["grads"][k], v.numpy(), err_msg=k, **BWD)
        for k, v in seen["d"][0].items():
            np.testing.assert_allclose(got["d"][k], v.numpy(), err_msg=k, **BWD)


def test_hz_unsummed_over_the_data_group_misses_the_hold(runs, jax_hessian_step):
    """The mutation: each rank's share of D left unsummed over the data group
    (the gradient still summed). Its loss and gradient hold; its D misses
    the hold against the JAX engine's."""
    _, _, results = runs
    metrics, seen = jax_hessian_step
    for res, _ in results:
        got = res["hessian_unsummed"]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=STEP_RTOL)
        assert not _held_d(got["d"], seen["d"][0])
        assert _held_d(res["hessian_m211"]["d"], seen["d"][0])


def _dist_rel(got, want):
    top = max(np.abs(v).max() for v in want.values())
    return max(np.abs(got[k] - v).max() for k, v in want.items()) / top


def test_dist_pass_on_the_data_axis_equals_one_process(runs):
    """The dist engine's AdaHessian step on (2, 1, 1) (its loss reaches the
    global max of the Wasserstein terms over the data ranks) against the
    port's one process with the global triplet batch: the loss within rtol
    1e-4, D within ``DIST_D_REL`` of its largest entry."""
    data, _, results = runs
    one = _dist_step(data)
    for res, _ in results:
        np.testing.assert_allclose(res["dist"]["loss"], one["loss"], rtol=STEP_RTOL)
        assert _dist_rel(res["dist"]["d"], one["d"]) <= DIST_D_REL


def test_old_global_max_backward_misses_the_dist_pass_hold(runs):
    """The same step with the global max's backward as it stood before
    slice 19: the ranks' cotangents summed by an all-reduce in place, outside
    the graph, which the Hessian pass's second backward cannot see through.
    The loss is the forward's and holds; D misses ``DIST_D_REL`` by more
    than ten times."""
    data, _, results = runs
    one = _dist_step(data)
    for res, _ in results:
        np.testing.assert_allclose(res["dist_old_max"]["loss"], one["loss"], rtol=STEP_RTOL)
        assert _dist_rel(res["dist_old_max"]["d"], one["d"]) > 10 * DIST_D_REL


# ---------------------------------------------------------------------------
# --stochastic on the data axis
# ---------------------------------------------------------------------------

def test_triplet_shards_equal_the_jax_dataset_in_one_process_order(J, tmp_path):
    """The triplet loader's shards on a data axis (``build_loaders(triplet=True,
    mesh=)``, the padded odd split): each rank's batches, negatives
    included, equal the JAX package's ``TripletDataset`` read in one
    process's order (every rank's batch of each global batch, one item after
    another), at epoch 0; at epoch 1 one process's stream of that epoch,
    read so by the port's own dataset."""
    _write_cifar(str(tmp_path))
    args = TFT.get_args_parser().parse_args(_dist_argv(str(tmp_path), "t", DIST_BATCH))
    base = J.D.load_cifar(str(tmp_path), cifar100=True, train=True)
    for epoch in (0, 1):
        loaders = []
        for d in range(DATA):
            loader, _ = TB.build_loaders(args, is_train=True, triplet=True,
                                         mesh=meshlib.Mesh((DATA, 1, 1), d))
            assert loader.num_hosts == DATA
            loader.set_epoch(epoch)
            loaders.append(list(loader))
        one = BatchLoader(TD.TripletDataset(TD.load_cifar(str(tmp_path), cifar100=True,
                                                           train=True), seed=args.seed),
                          DATA * DIST_BATCH, seed=args.seed, num_workers=0,
                          hosts_per_batch=DATA)
        one.set_epoch(epoch)
        jds = J.D.TripletDataset(base, seed=args.seed)
        want = [[jds[int(i)] for i in one._indices()[k:k + DATA * DIST_BATCH]]
                for k in range(0, len(one) * DATA * DIST_BATCH, DATA * DIST_BATCH)]
        got_one = list(one)
        assert len(loaders[0]) == len(loaders[1]) == len(got_one) == len(want) > 0
        for k, batch in enumerate(got_one):
            for d in range(DATA):
                part = slice(d * DIST_BATCH, (d + 1) * DIST_BATCH)
                for col in range(4):
                    assert np.array_equal(loaders[d][k][col], batch[col][part]), (epoch, k, d)
                    if epoch == 0:
                        ref = np.stack([np.asarray(item[col]) for item in want[k][part]])
                        assert np.array_equal(loaders[d][k][col], ref), (k, d, col)


@pytest.mark.parametrize("hosts_per_batch", [1, DATA], ids=["flat", "global_order"])
def test_triplet_negatives_do_not_depend_on_the_worker_threads(J, tmp_path, hosts_per_batch):
    """A triplet loader keys each negative on its read (``TripletDataset.plan``,
    on every loader): with four worker threads it gives, over two epochs,
    the batches it gives with none, and at epoch 0 those are the JAX
    package's ``TripletDataset`` read in the loader's order."""
    _write_cifar(str(tmp_path))
    base = TD.load_cifar(str(tmp_path), cifar100=True, train=True)
    jds = J.D.TripletDataset(J.D.load_cifar(str(tmp_path), cifar100=True, train=True), seed=3)
    batch = DATA * DIST_BATCH
    for epoch in (0, 1):
        got = {}
        for workers in (0, 4):
            loader = BatchLoader(TD.TripletDataset(base, seed=3), batch, seed=3,
                                 num_workers=workers, prefetch=1,
                                 hosts_per_batch=hosts_per_batch)
            loader.set_epoch(epoch)
            got[workers] = list(loader)
        assert len(got[0]) == len(got[4]) > 0
        for a, b in zip(got[0], got[4]):
            for col in range(4):
                assert np.array_equal(a[col], b[col]), (epoch, col)
        if epoch == 0:
            order = loader._indices()
            for k, one in enumerate(got[0]):
                want = [jds[int(i)] for i in order[k * batch:(k + 1) * batch]]
                for col in range(4):
                    ref = np.stack([np.asarray(item[col]) for item in want])
                    assert np.array_equal(one[col], ref), (k, col)


def test_stochastic_training_on_the_data_axis_equals_one_process(runs):
    """Two epochs of ``--stochastic`` training on (2, 1, 1) (the train
    transform, mixup, dropout, drop-path and attention dropout of the dist
    model drawn for the global batch; each anchor's negative one process's
    draw at its read) against one process with a batch of 2 ·
    --batch_size: each epoch's losses and test metrics in log.txt, and the
    parameters."""
    data, _, results = runs
    want = data["one"]["train"]
    got = results[0][0]["stochastic_train"]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=STEP_RTOL, atol=1e-6, err_msg=k)
    for res, (d, _) in results:
        assert (res["stochastic_train"] is None) == (d > 0)
    logs = []
    for tag in ("stochastic_seq0", "stochastic_seq1", "stochastic_one"):
        with open(os.path.join(data["root"], tag, "log.txt")) as f:
            logs.append([json.loads(line) for line in f])
    assert len(logs[0]) == len(logs[1]) == len(logs[2]) == 2
    for mesh_log in logs[:2]:
        for g, w in zip(mesh_log, logs[2]):
            for key in ("train_loss", "train_wasserstein_loss", "test_nll"):
                assert g[key] == pytest.approx(w[key], rel=STEP_RTOL), key
            assert g["test_acc1"] == w["test_acc1"]


def test_eval_stochastic_on_the_data_axis(runs):
    """``--eval --stochastic`` on (2, 1, 1): rank 0's metrics, over the union
    of the shards, equal to one process's (within 1e-5) and to the JAX
    driver's dist evaluation (acc equal, the rest within 1e-4)."""
    data, _, results = runs
    one, want = data["one"]["eval"], data["one"]["jax_eval"]
    got = results[0][0]["stochastic_eval"]["dist_eval"]
    for res, (d, _) in results:  # rank 0 of each seq index's data pair returns the result
        assert (res["stochastic_eval"] is None) == (d > 0)
    assert sorted(got) == sorted(one) == sorted(want)
    for k, v in one.items():
        assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), k
        if k in ("acc1", "acc5"):
            assert got[k] == pytest.approx(want[k], abs=1e-6), k
        else:
            assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])


def _close_dicts(got, want, where):
    assert sorted(got) == sorted(want), where
    for k, v in want.items():
        if isinstance(v, dict):
            _close_dicts(got[k], v, f"{where}.{k}")
        else:
            assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), (where, k, got[k], v)


def test_corrupted_stochastic_on_the_data_axis_is_one_process(runs):
    """``--eval --stochastic --corrupted_data`` on (2, 1, 1): every rank
    reads the whole corruption split (the post-hoc dispatches' rule, the
    dist model's deterministic logits), and rank 0's results are one
    process's at the same --batch_size."""
    data, _, results = runs
    got = results[0][0]["stochastic_corrupted"]
    for res, (d, _) in results:
        assert (res["stochastic_corrupted"] is None) == (d > 0)
    _close_dicts(got, data["one"]["corrupted"], "corruption")


# ---------------------------------------------------------------------------
# what still raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["attn_drop_seq", "mc_attn_drop_seq", "stochastic_seq",
                                  "gumbel_data", "dual_sto_data", "model_axis",
                                  "cyclical_adahessian"])
def test_what_still_raises(runs, case):
    """Attention dropout (training and ``--mc_dropout``) and ``--stochastic``
    under ``--seq_parallel`` raise the JAX package's ValueErrors; the Gumbel
    variants on a data axis name item 20's rest; the int8 trunk and
    attention dropout in training under a model axis, and the cyclical
    engine's AdaHessian pass on a data axis, name item 21. Each raise comes
    before any rank starts."""
    from uncertainty_vit_tpu_torch.models.cyclical import CyclicalViT
    from uncertainty_vit_tpu_torch.train import engine_cyclical as TEC

    data, _, _ = runs
    small = dict(img_size=32, patch_size=16, embed_dim=128, depth=1, num_heads=2,
                 num_classes=5)
    if case == "model_axis":
        tp = meshlib.Mesh((1, 1, 2), 0)
        with pytest.raises(NotImplementedError, match="item 21"):
            VisionTransformer(TViTConfig(**small, quant="int8"), device="cpu", mesh=tp)
        model = VisionTransformer(TViTConfig(**small, attn_drop_rate=0.1), device="cpu",
                                  mesh=tp).train()
        with pytest.raises(NotImplementedError, match="item 21"):
            model(torch.zeros(2, 32, 32, 3), generator=torch.Generator())
        return
    if case == "cyclical_adahessian":
        model = CyclicalViT(TViTConfig(**small), device="cpu", mesh=meshlib.Mesh((2, 1, 1), 0))
        with pytest.raises(NotImplementedError, match="item 21"):
            TEC.make_cyclical_train_step(model, TO.make_optimizer(model, opt_name="adahessian"),
                                         TEC.CyclicalHParams(), TS.constant_schedule(1e-3),
                                         use_hessian=True)
        return
    extra, train, mesh, error, words = {
        "attn_drop_seq": (["--attn_drop_rate", "0.1"], True, (2, 2, 1), ValueError,
                          "sequence-parallel attention requires attn_drop=0"),
        "mc_attn_drop_seq": (["--mc_dropout", "--attn_drop_rate", "0.1"], False, (1, 2, 1),
                             ValueError, "sequence-parallel attention requires attn_drop=0"),
        "stochastic_seq": ([], True, (2, 2, 1), ValueError,
                           "--seq_parallel is not wired for --stochastic"),
        "gumbel_data": (["--gumbel_softmax"], True, (2, 1, 1), NotImplementedError,
                        "item 20's rest"),
        "dual_sto_data": (["--h_sto_trans"], False, (2, 1, 1), NotImplementedError,
                          "item 20's rest"),
    }[case]
    if case == "stochastic_seq":
        argv = _dist_argv(data["root"], case, DIST_BATCH, train=train)
    else:
        argv = ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set",
                "CIFAR100", "--data_path", data["root"], "--batch_size", str(DIST_BATCH),
                "--num_workers", "0", "--output_dir", os.path.join(data["root"], case),
                *([] if train else ["--eval"]), *extra]
    argv += ["--seq_parallel", str(mesh[1])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
        mp.setattr(TFT.seq, "run_ranks", lambda *a, **k: pytest.fail("the ranks started"))
        with pytest.raises(error, match=words):
            TFT.main(TFT.get_args_parser().parse_args(argv), device="cpu", mesh=mesh)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_k1_k3_through_the_fold_on_the_card():
    """K1 (N = 197) and K3 (N = 577) with dropout through a data rank's fold,
    and K2 / K4 replaying it: against their plain versions (the attention
    bounds of ``chip_smoke.py``) and to the bit against the unfolded call's
    rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    seed = torch.tensor([0x51DE], dtype=torch.int64, device=dev)
    h, d = 2, 64
    for n, dtype, tol in ((197, torch.bfloat16, 1e-2), (197, torch.float32, 1e-4),
                          (577, torch.bfloat16, 1e-2), (577, torch.float32, 1e-4)):
        qkv = (torch.randn(8, n, 3 * h * d, generator=gen, device=dev) * 0.5).to(dtype)
        g = torch.randn(8, n, h * d, generator=gen, device=dev).to(dtype)
        out_w, lse_w = TFA.fused_qkv_attention(qkv, None, None, seed, d**-0.5, h, 0.1,
                                               want_lse=True)
        dq_w, _, _ = TFA.fused_qkv_attention_bwd(qkv, None, None, lse_w, g, d**-0.5, h,
                                                 out=out_w, seed=seed, dropout_rate=0.1)
        for r in range(2):
            fold = (2, 4, 2 * r)
            rows = P.fold_images(4, fold, dev)
            out, lse = TFA.fused_qkv_attention(qkv[rows], None, None, seed, d**-0.5, h, 0.1,
                                               want_lse=True, fold=fold)
            ref, _ = TFA.fused_qkv_attention_plain(qkv[rows], None, None, d**-0.5, h,
                                                   bounded_scores=False, seed=seed,
                                                   dropout_rate=0.1, fold=fold)
            assert torch.equal(out, out_w[rows])
            assert (out.float() - ref.float()).abs().max().item() <= tol
            dq, _, _ = TFA.fused_qkv_attention_bwd(qkv[rows].contiguous(), None, None, lse,
                                                   g[rows].contiguous(), d**-0.5, h, out=out,
                                                   seed=seed, dropout_rate=0.1, fold=fold)
            assert torch.equal(dq, dq_w[rows])
