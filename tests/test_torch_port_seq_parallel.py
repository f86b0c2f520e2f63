"""PyTorch port: sequence-parallel attention and the token-sharded model
against the JAX package's seq mesh, on the CPU over gloo.

One module fixture starts four ranks once (``parallel.seq.run_ranks``: gloo,
``file://`` rendezvous) and runs every sharded case in them; the ranks run
the plain versions of the kernels (CPU tensors), one thread each. The JAX
side runs on the conftest's virtual CPU devices with
``pmesh.create_mesh(S, seq_parallel=S)`` (data and model axes of 1) and its
Pallas kernels in interpret mode, as tests/test_seq_parallel.py runs them.
Inputs are made with numpy from a seed and handed to both. Forward: rtol
2e-4 / atol 2e-5; gradients: rtol 1e-3 / atol 1e-4
(tests/test_flash_attention.py:206, :229); the train step as
tests/test_seq_parallel.py:58-92 holds it.

The JAX side is imported by the fixture ``J``, not at the top: the ranks
import this module by name to find their function and need none of it
(importing it would add seconds to every rank's start).
"""

import math
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.models import layers as TL
from uncertainty_vit_tpu_torch.models.vit import ViTBackbone, VisionTransformer
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA
from uncertainty_vit_tpu_torch.ops import quant as TQ
from uncertainty_vit_tpu_torch.parallel import seq
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train import schedules as TS
from uncertainty_vit_tpu_torch.utils.checkpoint import flax_to_state_dict

B, H, D = 2, 2, 64
C = H * D
SCALE = D**-0.5
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
RTOL, ATOL = 1e-3, 1e-4
# (S, n): n = 13 is odd and leaves the last rank short (the cut-keys path)
ATTN_CASES = [(2, 13), (2, 16), (4, 13), (4, 16)]
# the model of tests/test_seq_parallel.py:31-35 with a shared rel-pos bias
# and layer scale; N = 5 tokens, split 3 | 2 over two ranks
MODEL = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2, num_classes=5,
             mlp_ratio=2.0, drop_path_rate=0.0, drop_rate=0.0, attn_drop_rate=0.0,
             use_flash_attention=True, use_shared_rel_pos_bias=True, init_values=0.1)
# port-only variants held against the unsharded port: (name, config overrides)
VARIANTS = [
    ("dropout", dict(drop_rate=0.1, drop_path_rate=0.1)),
    ("plain_attn_dropout", dict(use_flash_attention=False, attn_drop_rate=0.1, drop_rate=0.1,
                                drop_path_rate=0.1)),
    ("cls", dict(use_mean_pooling=False)),
    ("layer_weights", dict(learn_layer_weights=True)),
]
HP = dict(num_classes=5, mixup_active=False, label_smoothing=0.1)
# The int8 trunk's token cap during the cap case: the global trunk of the
# batch (4 images x 5 tokens = 20 rows) lies above it, each rank's rows (3 and
# 2 tokens: 12 and 8) within [8, cap], where ``quant.supported`` admits them.
INT8_CAP = 12
LR, WD, LAYER_DECAY = 1e-3, 0.05, 0.75


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules, its Pallas kernels in interpret mode."""
    import jax
    import jax.numpy as jnp

    import uncertainty_vit_tpu.ops.flash_attention as FA
    from uncertainty_vit_tpu.core.config import ViTConfig
    from uncertainty_vit_tpu.models.vit import VisionTransformer
    from uncertainty_vit_tpu.parallel import mesh
    from uncertainty_vit_tpu.train import engine_finetune, optim, schedules

    prev = (FA.INTERPRET, FA.BOUNDED_SCORES)
    FA.INTERPRET, FA.BOUNDED_SCORES = True, False
    yield types.SimpleNamespace(jax=jax, jnp=jnp, FA=FA, ViTConfig=ViTConfig,
                                ViT=VisionTransformer, pmesh=mesh, E=engine_finetune, O=optim,
                                S=schedules)
    FA.INTERPRET, FA.BOUNDED_SCORES = prev


def _attention_inputs(n, seed=0):
    rs = np.random.RandomState(seed + n)
    qkv = rs.randn(B, n, 3 * C).astype(np.float32)
    bias = (rs.randn(H, n, n) * 0.5).astype(np.float32)
    qvb = (rs.randn(3, C) * 0.3).astype(np.float32)
    qvb[1] = 0.0  # the reference's structurally zero key bias
    g = rs.randn(B, n, C).astype(np.float32)
    return qkv, bias, qvb, g


def _numpy_params(jax, shapes, seed):
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


def _batch(n_images=4, seed=7):
    rs = np.random.RandomState(seed)
    images = rs.randn(n_images, 32, 32, 3).astype(np.float32)
    labels = rs.randint(0, MODEL["num_classes"], size=n_images).astype(np.int64)
    return images, labels


def _port_model(cfg_kw, state, group=None):
    model = VisionTransformer(TViTConfig(**cfg_kw), device="cpu", seq_group=group)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    return model


def _port_runs(cfg_kw, state, images, labels, group=None):
    """Eval logits, train-mode logits and one train step of the port's
    model (sharded under ``group``): every draw from generators of fixed
    seeds."""
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    model = _port_model(cfg_kw, state, group)
    model.eval()
    with torch.no_grad():
        logits = model(x)
    model.train()  # under grad mode: the site dropouts are ``dropout``, not K8
    train_logits = model(x, generator=torch.Generator().manual_seed(5)).detach()
    opt = TO.make_optimizer(model, weight_decay=WD, layer_decay=LAYER_DECAY,
                            depth=cfg_kw["depth"])
    step = TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(**HP),
                                       TS.constant_schedule(LR))
    m = step(TE.init_finetune_state(model, opt), x, y, torch.Generator().manual_seed(6))
    return {"logits": logits.numpy(), "train_logits": train_logits.numpy(),
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
            "grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()}}


def _int8_layers(state, images, group=None, cap=None):
    """(int8 matmuls, eval logits) of one forward of MODEL with the int8
    trunk, sharded under ``group``; with ``cap`` the trunk's token limit
    lowered to it. Counts the calls of int8_dense's plain version."""
    calls = []
    plain, prev_cap = TQ.qmm_plain, TQ._MAX_M_INT32_ACC

    def counted(*args, **kwargs):
        calls.append(args[0].shape[0])
        return plain(*args, **kwargs)

    TQ.qmm_plain = counted
    TQ._MAX_M_INT32_ACC = prev_cap if cap is None else cap
    try:
        model = _port_model(dict(MODEL, quant="int8"), state, group).eval()
        with torch.no_grad():
            logits = model(torch.from_numpy(images)).numpy()
    finally:
        TQ.qmm_plain, TQ._MAX_M_INT32_ACC = plain, prev_cap
    return len(calls), logits


def _sharded_attention(group, n, qkv, bias, qvb, g):
    """This rank's out, dqkv and dbias rows and its share of dqvb."""
    start, stop = group.rows(n)
    qkv_l = torch.from_numpy(np.ascontiguousarray(qkv[:, start:stop])).requires_grad_()
    bias_l = torch.from_numpy(np.ascontiguousarray(bias[:, start:stop])).requires_grad_()
    qvb_t = torch.from_numpy(qvb).requires_grad_()
    out = TFA.seq_sharded_qkv_attention(qkv_l, bias_l, qvb_t, SCALE, H, group, n)
    (out * torch.from_numpy(np.ascontiguousarray(g[:, start:stop]))).sum().backward()
    return out.detach().numpy(), qkv_l.grad.numpy(), bias_l.grad.numpy(), qvb_t.grad.numpy()


def _rank_cases(group, data):
    """Every sharded case, in one rank of four: the attention at S = 2 (ranks
    0 and 1) and S = 4, then the models at S = 2."""
    torch.set_num_threads(1)
    pair = dist.new_group([0, 1])  # every rank takes part in making it
    groups = {4: group, 2: seq.SeqGroup.of(pair) if group.rank < 2 else None}
    out = {"attention": {}}
    for s, n in ATTN_CASES:
        if groups[s] is not None:
            out["attention"][(s, n)] = _sharded_attention(groups[s], n, *data["attention"][n])
    if groups[2] is None:
        return out
    g2 = groups[2]
    images, labels = data["batch"]
    out["jax_model"] = _port_runs(MODEL, data["jax_state"], images, labels, g2)
    out["int8"] = {cap: _int8_layers(data["jax_state"], images, g2, cap)
                   for cap in (None, INT8_CAP)}
    for name, overrides in VARIANTS:
        out[name] = _port_runs(dict(MODEL, **overrides), data["variant_states"][name], images,
                               labels, g2)
    # attention dropout on the kernel route raises in training, not in eval
    model = _port_model(dict(MODEL, attn_drop_rate=0.1), data["jax_state"], g2)
    try:
        model(torch.from_numpy(images), generator=torch.Generator().manual_seed(0))
        out["attn_drop_error"] = None
    except ValueError as e:
        out["attn_drop_error"] = str(e)
    model.eval()
    with torch.no_grad():
        out["attn_drop_eval"] = model(torch.from_numpy(images)).numpy()
    return out


def _jax_params(J):
    images, _ = _batch()
    shapes = J.jax.eval_shape(J.ViT(cfg=J.ViTConfig(**MODEL)).init, J.jax.random.PRNGKey(0),
                              J.jnp.asarray(images))["params"]
    return _numpy_params(J.jax, shapes, seed=1)


def _variant_state(overrides, seed):
    """The state of a port model of the variant, its rel-pos table drawn so
    that the bias is not zero."""
    gen = torch.Generator().manual_seed(seed)
    model = VisionTransformer(TViTConfig(**dict(MODEL, **overrides)), device="cpu",
                              generator=gen)
    with torch.no_grad():
        model.rel_pos_bias.relative_position_bias_table.normal_(0.0, 0.2, generator=gen)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def sharded(J):
    """(inputs, JAX params, each rank's results) of one run of four ranks."""
    params = _jax_params(J)
    data = {
        "attention": {n: _attention_inputs(n) for n in sorted({n for _, n in ATTN_CASES})},
        "batch": _batch(),
        "jax_state": {k: v.numpy() for k, v in flax_to_state_dict(params).items()},
        "variant_states": {name: _variant_state(ov, i) for i, (name, ov) in enumerate(VARIANTS)},
    }
    return data, params, seq.run_ranks(_rank_cases, 4, data, timeout=600.0)


@pytest.mark.parametrize("s,n", ATTN_CASES)
def test_seq_sharded_attention_matches_jax(J, sharded, s, n):
    """out, dqkv, dbias and dqvb of the S shards, put together, against JAX
    ``seq_sharded_qkv_attention`` over a seq axis of S and its jax.grad."""
    jax, jnp, FA = J.jax, J.jnp, J.FA
    data, _, results = sharded
    qkv, bias, qvb, g = data["attention"][n]
    parts = [r["attention"][(s, n)] for r in results[:s]]
    out, dqkv, dbias = (np.concatenate([p[i] for p in parts], axis=1) for i in range(3))
    dqvb = sum(p[3] for p in parts)
    mesh = J.pmesh.create_mesh(s, seq_parallel=s)

    def out_and_grads(a, b, c):
        ref, vjp = jax.vjp(lambda *x: FA.seq_sharded_qkv_attention(*x, SCALE, H, mesh), a, b, c)
        return ref, vjp(jnp.asarray(g))

    ref, grads = jax.jit(out_and_grads)(jnp.asarray(qkv), jnp.asarray(bias), jnp.asarray(qvb))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=FWD_RTOL, atol=FWD_ATOL)
    for name, got, r in zip(("dqkv", "dbias", "dqvb"), (dqkv, dbias, dqvb), grads):
        np.testing.assert_allclose(got, np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=name)


def test_seq_group_rows_split_the_padded_sequence():
    """Rank r of S holds [r·m, min((r + 1)·m, n)), m = ceil(n / S); a split
    that leaves a rank empty is refused."""
    assert [seq.SeqGroup(r, 4).rows(13) for r in range(4)] == [(0, 4), (4, 8), (8, 12), (12, 13)]
    assert [seq.SeqGroup(r, 2).rows(1025) for r in range(2)] == [(0, 513), (513, 1025)]
    assert seq.SeqGroup(1, 2).shard(5) == seq.SeqShard(seq.SeqGroup(1, 2), 5, 3, 5)
    with pytest.raises(ValueError):
        seq.SeqGroup(0, 4).shard(5)


@pytest.mark.parametrize("overrides", [{}, dict(use_mean_pooling=False),
                                       dict(learn_layer_weights=True)],
                         ids=["mean", "cls", "layer_weights"])
def test_token_parameters_are_the_backbones(overrides):
    """The train step sums over the group exactly the parameters the
    backbone registers, used before the pooling: not the norm, head or
    layer weights that act on the pooled feature."""
    cfg = TViTConfig(**dict(MODEL, **overrides))
    model = VisionTransformer(cfg, device="cpu")
    token = {id(p) for p in model.token_parameters()}
    after = [k for k, p in model.named_parameters() if id(p) not in token]
    assert len(token) == len(model.token_parameters())
    assert len(token) == len(list(ViTBackbone(cfg, device="cpu").parameters()))
    assert after and all(k.startswith(("fc_norm.", "norm.", "head.", "layer_log_weights"))
                         for k in after), after


def test_sharded_model_logits_match_jax(J, sharded):
    """Eval logits of the two-rank model (JAX weights) against the JAX
    model with a seq mesh of 2, and equal on both ranks."""
    data, params, results = sharded
    images, _ = data["batch"]
    mesh = J.pmesh.create_mesh(2, seq_parallel=2)
    jmodel = J.ViT(cfg=J.ViTConfig(**MODEL), seq_mesh=mesh)
    ref = J.jax.jit(lambda p, im: jmodel.apply({"params": p}, im))(
        params, J.pmesh.shard_batch(J.jnp.asarray(images), mesh))
    got = [r["jax_model"]["logits"] for r in results[:2]]
    assert np.array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], np.asarray(ref), rtol=FWD_RTOL, atol=FWD_ATOL)


def test_sharded_train_step_matches_jax(J, sharded):
    """One train step of the two-rank model against the JAX step with a seq
    mesh of 2 (tests/test_seq_parallel.py:58-92): the loss within 1e-5 and
    every updated parameter at rtol 1e-4 / atol 1e-5, equal on both ranks.
    Adam's first update is lr·g/(|g| + eps): where |g| ≲ 1e-6 the f32
    rounding of g moves it by up to one lr step, so there the bound is
    |Δ| ≤ lr (as tests/test_torch_port_train.py holds the unsharded step;
    |g| from the unsharded port's step, which that file holds against
    JAX's gradients)."""
    jax, jnp = J.jax, J.jnp
    data, params, results = sharded
    images, labels = data["batch"]
    mesh = J.pmesh.create_mesh(2, seq_parallel=2)
    cfg = J.ViTConfig(**MODEL)
    lr = J.S.constant_schedule(LR)
    tx = J.O.make_optimizer(params, lr, weight_decay=WD, layer_decay=LAYER_DECAY,
                            depth=MODEL["depth"])
    state = J.E.FinetuneState(params=params, opt_state=tx.init(params),
                              step=jnp.zeros([], jnp.int32))
    step = J.E.make_finetune_train_step(
        J.ViT(cfg=cfg, seq_mesh=mesh), tx, J.E.FinetuneHParams(num_patches=cfg.num_patches, **HP),
        lr)
    new_state, metrics = step(state, J.pmesh.shard_batch(jnp.asarray(images), mesh),
                              jnp.asarray(labels), jax.random.PRNGKey(3))
    grads = _port_runs(MODEL, data["jax_state"], images, labels)["grads"]
    ranks = [r["jax_model"] for r in results[:2]]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert abs(ranks[0]["loss"] - float(metrics["loss"])) < 1e-5
    np.testing.assert_allclose(ranks[0]["grad_norm"], float(metrics["grad_norm"]), rtol=1e-4)
    ref = flax_to_state_dict(jax.device_get(new_state.params))
    for k, v in ranks[0]["params"].items():
        assert np.array_equal(v, ranks[1]["params"][k]), k
        well_posed = np.abs(grads[k]) > 1e-6
        np.testing.assert_allclose(v[well_posed], ref[k].numpy()[well_posed], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        assert np.abs(v - ref[k].numpy()).max() <= LR, k
        assert well_posed.mean() > 0.99, k


@pytest.mark.parametrize("name", [name for name, _ in VARIANTS])
def test_sharded_model_equals_unsharded_port(sharded, name):
    """The two-rank model against the unsharded port on the same weights and
    generator seeds: eval and train-mode logits (dropout 0.1 and drop-path
    0.1 draw what the unsharded model draws for the same tokens; on the
    plain attention route the attention dropout too), one step's loss, grad
    norm and parameters. cls pooling takes token 0 from rank 0;
    learn_layer_weights pools every layer over the group."""
    data, _, results = sharded
    overrides = dict(VARIANTS)[name]
    images, labels = data["batch"]
    ref = _port_runs(dict(MODEL, **overrides), data["variant_states"][name], images, labels)
    for r in results[:2]:
        got = r[name]
        for k in ("logits", "train_logits"):
            np.testing.assert_allclose(got[k], ref[k], rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=k)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-4)
        for k, v in got["params"].items():
            np.testing.assert_allclose(v, ref["params"][k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_sharded_attention_dropout_raises_in_training(sharded):
    """The kernel route under a seq group refuses attention dropout in
    training with the reference's words (models/layers.py:353-358) and runs
    in evaluation."""
    data, _, results = sharded
    for r in results[:2]:
        assert "requires attn_drop=0" in r["attn_drop_error"]
        assert np.isfinite(r["attn_drop_eval"]).all()
    ref = _port_model(dict(MODEL, attn_drop_rate=0.1), data["jax_state"]).eval()
    with torch.no_grad():
        want = ref(torch.from_numpy(data["batch"][0])).numpy()
    np.testing.assert_allclose(results[0]["attn_drop_eval"], want, rtol=FWD_RTOL, atol=FWD_ATOL)


# (batch, whether the reference's trunk of ViT-L/16 512 is int8): B·1025 rows
# against the cap of 131,072
F3_CASES = [(64, True), (128, False), (256, False)]


@pytest.mark.parametrize("batch,want", F3_CASES)
def test_int8_decision_under_a_seq_group_is_the_global_trunks(batch, want):
    """ViT-L/16 512 (N = 1025, width 1024, MLP 4096) with S = 2: each rank
    decides every dense layer as the JAX rule decides on the global [B·N, C]
    trunk (``ops/quant.py:supported`` of the JAX package), though its own
    rows (513 and 512 per image) alone would fall under the cap at B = 128
    and, on rank 1 only, at B = 256."""
    from uncertainty_vit_tpu.ops import quant as JQ

    n, c, hidden = 1025, 1024, 4096
    layers = [(c, 3 * c), (c, c), (c, hidden), (hidden, c)]  # qkv, proj, fc1, fc2: (K, N)
    for rank in range(2):
        shard = seq.SeqGroup(rank, 2).shard(n)
        for k, features in layers:
            x = torch.empty(batch, shard.stop - shard.start, k, device="meta")
            got = TL._use_quant("int8", x, features, shard)
            assert got == JQ.supported(batch * n, k, features) == want, (rank, k, features)


def test_sharded_int8_trunk_runs_the_unsharded_layers(sharded):
    """The two-rank int8 model runs in int8 exactly the layers the unsharded
    port runs: all 8 (qkv, proj, fc1, fc2 of 2 blocks) at the real cap, none
    with the cap lowered below the global trunk's 20 rows though each rank's
    rows fit under it. The logits of both ranks are equal and match the
    unsharded int8 model's."""
    data, _, results = sharded
    images, _ = data["batch"]
    for cap, layers in ((None, 2 * 4), (INT8_CAP, 0)):
        want_calls, want = _int8_layers(data["jax_state"], images, cap=cap)
        assert want_calls == layers, cap
        got = [r["int8"][cap] for r in results[:2]]
        assert [g[0] for g in got] == [layers, layers], cap
        assert np.array_equal(got[0][1], got[1][1]), cap
        np.testing.assert_allclose(got[0][1], want, rtol=FWD_RTOL, atol=FWD_ATOL, err_msg=str(cap))
