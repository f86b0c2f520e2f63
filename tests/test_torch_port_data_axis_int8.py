"""PyTorch port: the int8 trunk (``quant="int8"``) on the driver's data axis,
against one process given the global batch and against the JAX package, on
the CPU.

A data rank's int8 layer must be one process's over the global batch's
trunk: the gradients' stochastic rounding draws the bits of the global
row, the row window (rows, start, n, image0) adding the rank's first image
of the global batch to the seq window (``ops/philox.py``), and wgrad's
column scales are a max over the data × seq ranks. One module fixture
starts four gloo ranks once (``parallel.seq.run_ranks``) as the mesh
(2, 2, 1) and runs every case there and on each seq index's data pair as a
(2, 1, 1) mesh: the layer's pieces (scales, K7's int32 sums, K6's dgrad
rows, ``int8_dense``'s gradients), one finetune step of a width-128 int8
ViT of 17 tokens (split 9 | 8 over a seq pair), the same step with every
data rank's image offset at 0 (the mutation the hold must see), and the
driver's ``--eval --quant int8`` dispatch (``cli.finetune.run_eval_dispatch``)
over a CIFAR split. The parent runs each in one process with the global
batch, and the JAX package's ``evaluate`` with its int8 kernels in
interpret mode. Width 128 is the narrowest at which the int8 trunk runs:
its K and N must be multiples of 128.

The ranks import this module by name, so it imports JAX only inside
fixtures.
"""

import contextlib
import io
import math
import os
import pickle
import types

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)
from uncertainty_vit_tpu_torch.cli import builders as TB
from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.core.config import get_preset
from uncertainty_vit_tpu_torch.evals import classification as TEV
from uncertainty_vit_tpu_torch.models import layers as TL
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import philox as P
from uncertainty_vit_tpu_torch.ops import quant as TQ
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
from uncertainty_vit_tpu_torch.parallel import seq
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils.checkpoint import flax_to_state_dict

# every trunk matmul int8 (qkv 128 → 384, proj 128 → 128, fc1 128 → 512, fc2
# 512 → 128) over a global batch of 4 images of 17 tokens: 68 rows, a data
# rank's 2 images (34 rows), a seq rank's 9 or 8 tokens of them
I8 = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, num_classes=5,
          mlp_ratio=4.0, use_flash_attention=False, quant="int8",
          use_shared_rel_pos_bias=True, init_values=0.1)
N_TOK = 17
BATCH = 4  # the global batch; a data rank's is BATCH // DATA
DATA = 2
HP = dict(num_classes=5, mixup_active=False, label_smoothing=0.1)
LR = 1e-3
# the layer case: x [B, N, K] of the global batch, the gradient [B, N, OUT]
OP_K, OP_OUT = 128, 256
OP_SEED = 0x0123456789ABCDEF
MESHES = {"m221": (2, 2, 1), "m211": (2, 1, 1)}
# the ranks against one process: tests/test_torch_port_int8_large.py's F4
# bounds (f32 sums in another order; at most FLIP_FRACTION of a gradient's
# entries moved by a rounding decision on its threshold, its norm within
# FLIP_NORM_REL)
SUM_ORDER_REL = 1e-6
FLIP_FRACTION, FLIP_NORM_REL = 1e-2, 1e-3
# int8 against JAX (tests/test_torch_port_quant.py): eval logits within 2e-2
# of the largest logit (a LayerNorm ulp can flip an int8 value)
LOGIT_REL = 2e-2
N_EVAL = 8  # the eval split: 2 batches of 2 a data rank


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


def _op_inputs():
    rs = np.random.RandomState(22)
    x = rs.randn(BATCH, N_TOK, OP_K).astype(np.float32)
    g = (rs.randn(BATCH, N_TOK, OP_OUT) * 0.01).astype(np.float32)
    w = (rs.randn(OP_OUT, OP_K) * 0.05).astype(np.float32)
    b = (rs.randn(OP_OUT) * 0.1).astype(np.float32)
    return x, g, w, b


def _data_pair(mesh):
    """The (2, 1, 1) mesh of this rank's seq index: the data axis's ranks."""
    group = mesh.group(meshlib.DATA_AXIS)
    return meshlib.Mesh((mesh.size("data"), 1, 1), mesh.index("data"), (group, None, None), group)


def _place(mesh):
    """(images, seq shard or None, image0) of a rank of ``mesh`` (or one
    process's whole batch for None)."""
    if mesh is None:
        return slice(None), None, 0
    b = BATCH // mesh.size("data")
    d = mesh.index("data")
    shard = mesh.seq_group.shard(N_TOK) if mesh.seq_group is not None else None
    return slice(d * b, (d + 1) * b), shard, d * b


def _layer(x, g, w, b, mesh=None):
    """The layer's pieces on this rank's rows of x [B, N, K] and g [B, N,
    OUT] of the global batch: the wgrad scales over the data × seq ranks,
    K7's int32 sums, K6's dgrad, wgrad, and ``int8_dense``'s gradients."""
    images, shard, image0 = _place(mesh)
    rows = slice(None) if shard is None else slice(shard.start, shard.stop)
    x, g = x[images, rows], g[images, rows]
    x, g, w, b = (torch.from_numpy(np.ascontiguousarray(a)) for a in (x, g, w, b))
    seed = torch.tensor([OP_SEED], dtype=torch.int64)
    window = group = None
    if mesh is not None:
        start, n = (0, N_TOK) if shard is None else (shard.start, shard.n)
        window, group = (x.shape[1], start, n, image0), mesh.trunk_group
    x2, g2 = x.reshape(-1, OP_K), g.reshape(-1, OP_OUT)
    sx, sg = TQ.wgrad_scales(x2, g2, group)
    acc = TQ.wgrad_acc_plain(x2, g2, sx.reciprocal(), sg.reciprocal(), seed, window)
    wtq, wts = TQ.quantize_cols(w)
    dx = TQ.qmm(g2, wtq, wts, None, seed, True, torch.float32, window)
    dw = TQ.wgrad(x2, g2, seed, window, group)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    (TQ.int8_dense(xl, wl, b, seed, shard, image0=image0, group=group) * g).sum().backward()
    return {"sx": sx.numpy(), "sg": sg.numpy(), "acc": acc.numpy(), "dx": dx.numpy(),
            "dw": dw.numpy(), "layer_dx": xl.grad.numpy(), "layer_dw": wl.grad.numpy()}


def _port_step(state, images, labels, mesh=None):
    """One finetune step of the int8 model from ``state`` (this rank's rows of
    the global batch on ``mesh``): loss, grad norm, the summed gradients and
    the parameters after."""
    sl, _, _ = _place(mesh)
    model = VisionTransformer(TViTConfig(**I8), device="cpu", mesh=mesh)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    opt = TO.make_optimizer(model, weight_decay=0.0)
    step = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**HP),
                                       TS.constant_schedule(LR))
    m = step(TE.init_finetune_state(model, opt), torch.from_numpy(images[sl]),
             torch.from_numpy(labels[sl]), torch.Generator().manual_seed(6))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()},
            "params": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}


@contextlib.contextmanager
def _image0_zero():
    """Every int8 layer draws its rounding bits as if its images began the
    global batch (image0 = 0 on every data rank): the mutation."""
    real = TL.quant_ops.int8_dense

    def at_zero(*a, image0=0, **k):
        return real(*a, image0=0, **k)

    TL.quant_ops.int8_dense = at_zero
    try:
        yield
    finally:
        TL.quant_ops.int8_dense = real


def _eval_args(root, batch):
    return TFT.get_args_parser().parse_args([
        "--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
        "--data_path", root, "--batch_size", str(batch), "--num_workers", "0",
        "--dtype", "float32", "--eval", "--quant", "int8", "--nb_classes", "5"])


def _eval_dispatch(state, root, mesh=None):
    """The driver's --eval --quant int8 dispatch on the int8 model (this
    rank's shard of the split on ``mesh``): its results, and the logits and
    labels its metrics were taken on (the union of the data ranks')."""
    model = VisionTransformer(TViTConfig(**I8), device="cpu", mesh=mesh)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    args = _eval_args(root, BATCH // DATA if mesh is not None else BATCH)
    loader, _ = TB.build_loaders(args, is_train=False, mesh=mesh)
    seen = []
    real = TEV._metrics

    def kept(m, logits, labels):
        seen.append((np.array(logits), np.array(labels)))
        return real(m, logits, labels)

    TEV._metrics = kept
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            res = TFT.run_eval_dispatch(args, model, loader, 5)
    finally:
        TEV._metrics = real
    return res, seen[0]


def _rank_cases(mesh, data):
    """Every case on the (2, 2, 1) mesh and its data pair, in one rank."""
    torch.set_num_threads(1)
    out = {}
    images, labels = data["batch"]
    for key, m in (("m221", mesh), ("m211", _data_pair(mesh))):
        out[key] = {"layer": _layer(*data["ops"], m),
                    "step": _port_step(data["state"], images, labels, m),
                    "eval": _eval_dispatch(data["state"], data["root"], m)}
    with _image0_zero():
        out["m211_image0_zero"] = _port_step(data["state"], images, labels, _data_pair(mesh))
    return out, (mesh.index("data"), mesh.index("seq"))


def _write_cifar(root, n):
    base = os.path.join(root, "cifar-100-python")
    os.makedirs(base, exist_ok=True)
    rs = np.random.RandomState(n)
    for name in ("train", "test"):
        data = rs.randint(0, 256, (n, 3072), dtype=np.uint8)
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": (np.arange(n) % 5).tolist()}, f)


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules, its Pallas kernels in interpret mode."""
    import jax
    import jax.numpy as jnp

    import uncertainty_vit_tpu.ops.flash_attention as FA
    from uncertainty_vit_tpu.core.config import ViTConfig
    from uncertainty_vit_tpu.evals import classification as JEV
    from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
    from uncertainty_vit_tpu.ops import quant as Q

    prev = (FA.INTERPRET, Q.INTERPRET)
    FA.INTERPRET = Q.INTERPRET = True
    yield types.SimpleNamespace(jax=jax, jnp=jnp, ViTConfig=ViTConfig, ViT=JViT, EV=JEV)
    FA.INTERPRET, Q.INTERPRET = prev


@pytest.fixture(scope="module")
def runs(J, tmp_path_factory):
    """(inputs, JAX params, each rank's results) of one run of four ranks."""
    root = str(tmp_path_factory.mktemp("data_axis_int8"))
    _write_cifar(root, N_EVAL)
    rs = np.random.RandomState(7)
    images = rs.randn(BATCH, 32, 32, 3).astype(np.float32)
    labels = (np.arange(BATCH) % 5).astype(np.int64)
    shapes = J.jax.eval_shape(J.ViT(cfg=J.ViTConfig(**I8)).init, J.jax.random.PRNGKey(0),
                              J.jnp.asarray(images))["params"]
    params = _numpy_params(J.jax, shapes, 1)
    data = {"ops": _op_inputs(), "batch": (images, labels), "root": root,
            "state": {k: v.numpy() for k, v in flax_to_state_dict(params).items()}}
    return data, params, seq.run_ranks(_rank_cases, 4, data, timeout=600.0,
                                       mesh=MESHES["m221"])


# ---------------------------------------------------------------------------
# the bits of the global rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,d,q", [("m211", 0, 0), ("m211", 1, 0), ("m221", 0, 0),
                                      ("m221", 0, 1), ("m221", 1, 0), ("m221", 1, 1)])
def test_quant_bits_through_the_image_offset_are_one_process_rows(mesh, d, q):
    """ViT-B/16 384's N = 577 (split 289 | 288 on a seq pair) over a data
    pair of 3 images a rank: under the window (rows, start, n, d·3) rank
    (d, q) draws the bits, and the uniforms, of one process's rows (d·3 +
    b)·n + start + r, whole and by tiles; with image0 = 0 those of data
    rank 0."""
    n, b, cols = 577, 3, 40
    s = MESHES[mesh][1]
    shard = seq.SeqGroup(q, s).shard(n)
    rows = shard.stop - shard.start
    window = (rows, shard.start, n, d * b)
    seed = torch.tensor([OP_SEED], dtype=torch.int64)
    whole = P.quant_bits(seed, DATA * b * n, cols).reshape(DATA * b, n, cols)
    want = whole[d * b:(d + 1) * b, shard.start:shard.stop].reshape(-1, cols)
    got = P.quant_bits(seed, b * rows, cols, window=window)
    assert torch.equal(got, want)
    assert torch.equal(P.quant_uniform(seed, b * rows, cols, window=window),
                       (want >> 8).float() * 2.0**-24)
    for row0, col0, r, c in ((0, 0, 7, 5), (rows - 3, 6, 9, 11), (2 * rows - 1, 3, 2, 37)):
        assert torch.equal(P.quant_bits(seed, r, c, row0=row0, col0=col0, window=window),
                           got[row0:row0 + r, col0:col0 + c])
    first = whole[:b, shard.start:shard.stop].reshape(-1, cols)
    assert torch.equal(P.quant_bits(seed, b * rows, cols, window=(rows, shard.start, n, 0)),
                       first)


@pytest.mark.parametrize("window", [(5, 0, 5, -1), (5, 0, 5, 2**29), (5, 0, 5)])
def test_window_with_a_bad_image_offset_raises(window):
    """A negative image offset, one whose rows pass 2³¹, and a window
    without its image offset raise."""
    seed = torch.tensor([1], dtype=torch.int64)
    with pytest.raises(ValueError):
        TQ.qmm_plain(torch.randn(10, 128), *TQ.quantize_cols(torch.randn(128, 128)), None,
                     seed, True, torch.float32, window)


def test_use_quant_decides_on_the_global_token_count():
    """The int8 decision counts the global batch's tokens, as the reference
    decides on its whole trunk: one image of 5 tokens is 5 rows (below the
    kernels' 8, bf16) in one process, but a data rank's image of a global
    batch of 2 stands for 10 (int8), on the rank's folds too; at ViT-L/16
    512 a data rank's 64 images of a global batch of 256 are 262,400 rows
    (bf16) where one process's 64 would be int8."""
    from uncertainty_vit_tpu.ops import quant as JQ

    x = torch.empty(1, 5, 128, device="meta")
    assert not TL._use_quant("int8", x, 128) and not JQ.supported(5, 128, 128)
    for d in range(2):
        with TL.batch_shard(meshlib.Mesh((2, 1, 1), d), 1):
            assert TL._use_quant("int8", x, 128) and JQ.supported(10, 128, 128)
        with TL.folded_batch(3), TL.batch_shard(meshlib.Mesh((2, 1, 1), d), 3):
            assert TL.global_images(3) == 6
    cfg = get_preset("beit_large_patch16_512")
    n, c = cfg.num_patches + 1, cfg.embed_dim
    x = torch.empty(64, n, c, device="meta")
    assert TL._use_quant("int8", x, 3 * c) == JQ.supported(64 * n, c, 3 * c) is True
    for d in range(4):
        with TL.batch_shard(meshlib.Mesh((4, 1, 1), d), 64):
            assert TL._use_quant("int8", x, 3 * c) == JQ.supported(256 * n, c, 3 * c) is False
        shard = seq.SeqGroup(1, 2).shard(n)
        with TL.batch_shard(meshlib.Mesh((4, 2, 1), 2 * d + 1), 64):
            xs = torch.empty(64, shard.stop - shard.start, c, device="meta")
            assert not TL._use_quant("int8", xs, 3 * c, shard)
    with TL.whole_batch(), TL.batch_shard(meshlib.Mesh((4, 1, 1), 1), 64):
        assert TL._use_quant("int8", x, 3 * c)


# ---------------------------------------------------------------------------
# the ranks against one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_layer_pieces_add_up_to_one_process(runs, mesh):
    """Each rank's column scales are the global trunk's (exact: a max over
    the data × seq ranks); K7's int32 sums of the ranks add up to one
    process's exactly; K6's stochastic dgrad gives one process's rows to the
    bit; the dequantized weight gradients, and ``int8_dense``'s, sum to one
    process's to f32 summation order."""
    data, _, results = runs
    x, g, w, b = data["ops"]
    one = _layer(x, g, w, b)
    ranks = [(res[mesh]["layer"], dq) for res, dq in results]
    if mesh == "m211":  # each seq index's data pair is a mesh of its own
        ranks = [(lay, dq) for lay, dq in ranks if dq[1] == 0]
    for lay, _ in ranks:
        assert np.array_equal(lay["sx"], one["sx"]) and np.array_equal(lay["sg"], one["sg"])
    total = sum(lay["acc"].astype(np.int64) for lay, _ in ranks)
    assert np.array_equal(total, one["acc"].astype(np.int64))
    out = one["dx"].shape[-1]
    for key in ("dx", "layer_dx"):
        want = one[key].reshape(BATCH, N_TOK, -1)
        for lay, (d, q) in ranks:
            images, shard, _ = _place(meshlib.Mesh(MESHES[mesh], 2 * d + q if mesh == "m221"
                                                   else d))
            rows = slice(None) if shard is None else slice(shard.start, shard.stop)
            assert np.array_equal(lay[key].reshape(BATCH // DATA, -1, want.shape[-1]),
                                  want[images, rows]), (key, d, q)
    assert out == OP_K
    for key in ("dw", "layer_dw"):
        got = sum(lay[key] for lay, _ in ranks)
        np.testing.assert_allclose(got, one[key], rtol=0,
                                   atol=SUM_ORDER_REL * np.abs(one[key]).max(), err_msg=key)


def _step_diffs(rank, one):
    """A rank's step against one process's: the relative differences of the
    loss and the grad norm, and for each gradient (name, share of entries
    off by more than ``SUM_ORDER_REL`` of its largest, norm of the
    difference / norm)."""
    grads = []
    for k, v in one["grads"].items():
        diff = np.abs(rank["grads"][k] - v)
        off = float((diff > SUM_ORDER_REL * max(np.abs(v).max(), 1e-30)).mean())
        grads.append((k, off, float(np.linalg.norm(diff) / max(np.linalg.norm(v), 1e-30))))
    return {key: abs(rank[key] - one[key]) / abs(one[key]) for key in ("loss", "grad_norm")}, grads


def _held(diffs) -> bool:
    """Whether a rank's step meets the hold against one process."""
    scalars, grads = diffs
    return (all(v <= SUM_ORDER_REL for v in scalars.values())
            and all(off <= FLIP_FRACTION and rel <= FLIP_NORM_REL for _, off, rel in grads))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_data_axis_int8_step_equals_one_process(runs, mesh):
    """One finetune step of the int8 model on the mesh (stochastic rounding
    active: seeds from the step's generator) against the same step in one
    process with the global batch: loss and grad norm at rtol
    ``SUM_ORDER_REL``; every summed gradient within ``SUM_ORDER_REL`` of its
    tensor's largest entry but for at most ``FLIP_FRACTION`` of its entries,
    and its norm within ``FLIP_NORM_REL``; every rank's parameters equal."""
    data, _, results = runs
    images, labels = data["batch"]
    one = _port_step(data["state"], images, labels)
    steps = [res[mesh]["step"] for res, _ in results]
    for r in steps:
        diffs = _step_diffs(r, one)
        assert _held(diffs), diffs
        for k, v in r["params"].items():
            assert np.array_equal(v, steps[0]["params"][k]), k


def test_image_offset_zero_misses_the_hold(runs):
    """The mutation: every data rank draws its rounding bits as if its images
    began the global batch (image0 = 0, rank-local bits). The loss is the
    forward's and holds, but the gradients miss the hold: the grad norm
    moves by more than ``SUM_ORDER_REL`` and some trunk gradient by more
    than ten times ``FLIP_NORM_REL`` of its norm."""
    data, _, results = runs
    images, labels = data["batch"]
    one = _port_step(data["state"], images, labels)
    for res, _ in results:
        scalars, grads = diffs = _step_diffs(res["m211_image0_zero"], one)
        assert not _held(diffs)
        assert scalars["loss"] <= SUM_ORDER_REL
        assert scalars["grad_norm"] > SUM_ORDER_REL, scalars
        assert max(rel for _, _, rel in grads) > 10 * FLIP_NORM_REL, grads


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_eval_quant_int8_on_the_mesh(runs, J, mesh):
    """The driver's ``--eval --quant int8`` dispatch on the mesh: every
    metric of the union of the data ranks' logits equal to one process's
    (within 1e-5), those logits within ``LOGIT_REL`` of the largest of the
    JAX package's ``evaluate`` on the same weights and images (its int8
    kernels in interpret mode), and its top-1 hits but where a near tie
    (two logits within that bound) could flip them."""
    data, params, results = runs
    res0, (logits0, labels0) = results[0][0][mesh]["eval"]
    one, (logits1, labels1) = _eval_dispatch(data["state"], data["root"])
    assert np.array_equal(labels0, labels1)
    np.testing.assert_allclose(logits0, logits1, rtol=0, atol=1e-5 * np.abs(logits1).max())
    for k, v in one["eval"].items():
        assert abs(res0["eval"][k] - v) <= 1e-5 * max(1.0, abs(v)), k
    # JAX's evaluate on the same normalized images, in the split's order
    args = _eval_args(data["root"], BATCH)
    loader, _ = TB.build_loaders(args, is_train=False)
    batches = [(TFT._eval_prep(x, args, torch.device("cpu")).numpy(), y) for x, y in loader]
    jmodel = J.ViT(cfg=J.ViTConfig(**I8))
    apply = J.jax.jit(lambda v, x: jmodel.apply(v, x, deterministic=True))
    seen = []

    def forward(variables, x):
        out = apply(variables, x)
        seen.append(np.asarray(out))
        return out

    want = J.EV.evaluate(jmodel, {"params": params},
                         [(J.jnp.asarray(x), J.jnp.asarray(y)) for x, y in batches],
                         forward=forward)
    ref = np.concatenate(seen)
    scale = np.abs(ref).max()
    assert np.abs(logits0 - ref).max() <= LOGIT_REL * scale, (np.abs(logits0 - ref).max(), scale)
    top2 = np.sort(ref, axis=1)[:, -2:]
    ties = int((top2[:, 1] - top2[:, 0] <= 2 * LOGIT_REL * scale).sum())
    assert abs(res0["eval"]["acc1"] - want["acc1"]) * N_EVAL / 100 <= ties + 1e-6


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_k6_k7_through_the_image_offset_on_the_card():
    """K6's stochastic dgrad and K7's int32 sums through a row window with an
    image offset (a data rank's images of a seq shard's rows) against their
    plain versions to the bit, and against the unwindowed call's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    seed = torch.tensor([OP_SEED], dtype=torch.int64, device=dev)
    n_img, n, k, m_out = 3, 197, 256, 384
    x = torch.randn(2 * n_img * n, k, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(2 * n_img * n, m_out, generator=gen, device=dev).to(torch.bfloat16)
    wq, ws = TQ.quantize_cols(torch.randn(k, m_out, generator=gen, device=dev))
    whole = TQ.qmm(x, wq, ws, None, seed, True, torch.bfloat16).reshape(2 * n_img, n, m_out)
    sx, sg = TQ.wgrad_scales(x, g)
    acc_whole = TQ.wgrad_acc(x, g, sx.reciprocal(), sg.reciprocal(), seed)
    total = 0
    for d in range(2):
        for start, stop in ((0, 99), (99, n)):
            window = (stop - start, start, n, d * n_img)
            part = lambda t: t.reshape(2 * n_img, n, -1)[d * n_img:(d + 1) * n_img,  # noqa: E731
                                                          start:stop].reshape(-1, t.shape[-1])
            xs, gs = part(x).contiguous(), part(g).contiguous()
            got = TQ.qmm(xs, wq, ws, None, seed, True, torch.bfloat16, window)
            assert torch.equal(got, TQ.qmm_plain(xs, wq, ws, None, seed, True, torch.bfloat16,
                                                 window))
            assert torch.equal(got.reshape(n_img, -1, m_out),
                               whole[d * n_img:(d + 1) * n_img, start:stop])
            acc = TQ.wgrad_acc(xs, gs, sx.reciprocal(), sg.reciprocal(), seed, window)
            assert torch.equal(acc, TQ.wgrad_acc_plain(xs, gs, sx.reciprocal(), sg.reciprocal(),
                                                       seed, window))
            total = total + acc
    assert torch.equal(total, acc_whole)
