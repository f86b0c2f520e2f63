"""PyTorch port: the multi-process bootstrap and what a mesh refuses.

``parallel.distributed`` against the reference's probe order (utils.py:
263-297, as the JAX package's parallel/distributed.py reads it): explicit
arguments, ``env://``, SLURM, OMPI; a single process starts nothing; one
two-rank ``file://`` group on the CPU picks gloo; print gating and
``save_on_master``. Then what a ``parallel.mesh.Mesh`` holds without a
process group: the draws of a data shard (the global batch's rows), the
refusals under a model axis (a head count that does not split, the int8
trunk, attention dropout in training, the other attention variants, the
optimizers that read whole tensors), the heads and passes refused under any
mesh, the sharded import of JAX params, and the driver's ``--sngp`` /
``--gp_layer`` under ``--seq_parallel`` in training.
"""

import builtins
import math
import os
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.core.config import ViTConfig
from uncertainty_vit_tpu_torch.data.pipeline import host_shard
from uncertainty_vit_tpu_torch.models import layers as TLY
from uncertainty_vit_tpu_torch.models.cyclical import CyclicalViT
from uncertainty_vit_tpu_torch.models.dist_vit import DistVisionTransformer
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.parallel import distributed as PD
from uncertainty_vit_tpu_torch.parallel import mesh as M
from uncertainty_vit_tpu_torch.train import engine_finetune as TE
from uncertainty_vit_tpu_torch.train import optim as TO
from uncertainty_vit_tpu_torch.train.schedules import constant_schedule
from uncertainty_vit_tpu_torch.utils import checkpoint as C

from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2, num_classes=5)
MODEL2 = M.Mesh((1, 1, 2), rank=1)  # model index 1 of 2; no process group is needed here
DATA2 = M.Mesh((2, 1, 1), rank=1)  # data index 1 of 2
CLUSTER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID",
                "SLURM_NTASKS_PER_NODE", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
                "OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE")


@pytest.fixture
def no_cluster(monkeypatch):
    for name in CLUSTER_VARS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env,want", [
    ({}, (1, 0, 0, 1, None)),
    ({"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
     (8, 3, 1, 2, "env://")),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "2"}, (4, 2, 2, 4, "env://")),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "3", "SLURM_LOCALID": "1",
      "SLURM_NTASKS_PER_NODE": "2"}, (4, 3, 1, 2, "env://")),
    ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1"}, (2, 1, 1, 2, "env://")),
    # env:// before SLURM before OMPI, as the reference probes them
    ({"RANK": "1", "WORLD_SIZE": "2", "SLURM_NTASKS": "4", "SLURM_PROCID": "3",
      "OMPI_COMM_WORLD_SIZE": "6"}, (2, 1, 1, 2, "env://")),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "3", "OMPI_COMM_WORLD_SIZE": "6",
      "OMPI_COMM_WORLD_RANK": "5"}, (4, 3, 3, 4, "env://")),
], ids=["none", "env", "slurm", "slurm_two_hosts", "ompi", "env_first", "slurm_before_ompi"])
def test_probe_follows_the_reference_order(no_cluster, env, want):
    for k, v in env.items():
        no_cluster.setenv(k, v)
    c = PD.probe_cluster()
    assert (c.world_size, c.rank, c.local_rank, c.local_size, c.init_method) == want


def test_explicit_arguments_beat_the_environment(no_cluster):
    no_cluster.setenv("SLURM_NTASKS", "4")
    no_cluster.setenv("SLURM_PROCID", "3")
    c = PD.probe_cluster("file:///x", world_size=2, rank=1)
    assert (c.world_size, c.rank, c.init_method) == (2, 1, "file:///x")


def test_single_process_is_a_no_op(no_cluster):
    """As the JAX package's test_distributed_helpers holds its own
    (tests/test_cli_eval_paths.py:114-123)."""
    assert PD.init_distributed_mode(suppress_output=False) == 0
    assert not torch.distributed.is_initialized()
    assert PD.is_main_process() and PD.save_on_master(lambda: 42) == 42


def test_a_cluster_without_rendezvous_raises(no_cluster):
    no_cluster.setenv("OMPI_COMM_WORLD_SIZE", "2")
    no_cluster.setenv("OMPI_COMM_WORLD_RANK", "0")
    with pytest.raises(ValueError, match="rendezvous"):
        PD.init_distributed_mode()


def test_backend_is_chosen_once():
    """nccl only where every rank of a host has a card; here gloo."""
    assert PD.choose_backend(1, "cpu") == "gloo"
    if not torch.cuda.is_available():
        assert PD.choose_backend(1, "cuda") == "gloo"


def test_print_gating(capsys):
    base = builtins.print
    try:
        PD.setup_for_distributed(False)
        print("hidden")
        print("shown", force=True)
        PD.setup_for_distributed(True)  # re-gating wraps the original print, not the gate
        print("again")
    finally:
        builtins.print = base
    assert capsys.readouterr().out == "shown\nagain\n"


def _bootstrap_rank(rank, path, results):
    torch.set_num_threads(1)
    try:
        got = PD.init_distributed_mode("file://" + path, world_size=2, rank=rank, device="cpu",
                                       suppress_output=False)
        x = torch.tensor([float(rank + 1)])
        torch.distributed.all_reduce(x)
        written = PD.save_on_master(lambda: "written")
        results.put((rank, got, torch.distributed.get_backend(), float(x), written,
                     PD.is_main_process()))
        torch.distributed.destroy_process_group()
    except BaseException as e:  # reported to the test
        results.put((rank, repr(e)))


def test_two_ranks_over_file_rendezvous(tmp_path):
    """Two processes start one gloo group through init_distributed_mode;
    rank 0 alone saves."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_bootstrap_rank, args=(r, str(tmp_path / "rdv"), results))
             for r in range(2)]
    for p in procs:
        p.start()
    got = sorted(results.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=30)
    assert got == [(0, 0, "gloo", 3.0, "written", True), (1, 1, "gloo", 3.0, None, False)]


def test_host_shard_under_a_mesh():
    """The ranks of one data index read the same images."""
    assert host_shard(M.Mesh((2, 2, 2), rank=5)) == (1, 2)
    assert host_shard(M.Mesh((4, 1, 2), rank=5)) == (2, 4)


def test_data_shard_draws_the_global_batchs_rows():
    """Under a data axis every mask is the global batch's, this rank's rows
    kept: rand_rows, and dropout / drop-path inside batch_shard."""
    want = torch.rand((4, 3), generator=torch.Generator().manual_seed(1))
    got = M.rand_rows((2, 3), torch.Generator().manual_seed(1), "cpu", M.data_rows(DATA2, 2))
    assert torch.equal(got, want[2:])
    assert M.data_rows(None, 2) is None and M.data_rows(MODEL2, 2) is None
    x = torch.ones(4, 5, 8)
    full = TLY.dropout(x, 0.5, True, torch.Generator().manual_seed(2))
    with TLY.batch_shard(DATA2, 2):
        part = TLY.dropout(x[2:], 0.5, True, torch.Generator().manual_seed(2))
    assert torch.equal(part, full[2:])
    full = TLY.drop_path(x, 0.5, True, torch.Generator().manual_seed(3))
    with TLY.batch_shard(DATA2, 2):
        part = TLY.drop_path(x[2:], 0.5, True, torch.Generator().manual_seed(3))
        with pytest.raises(RuntimeError, match="for a shard of 2"):
            TLY.drop_path(x, 0.5, True, torch.Generator())
    assert torch.equal(part, full[2:])


def test_a_model_axis_builds_the_shards_shapes():
    """H/T heads, hidden/T of fc1, proj and fc2 on their input."""
    cfg = ViTConfig(**dict(SMALL, use_shared_rel_pos_bias=True))
    model = VisionTransformer(cfg, device="cpu", mesh=MODEL2)
    full = VisionTransformer(cfg, device="cpu").state_dict()
    shard = M.shard_state_dict(full, MODEL2)
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in shard.items()}
    assert model.blocks[0].attn.num_heads == 1 and model.rel_pos_bias(
    ).shape[0] == 1
    model.load_state_dict(shard)
    assert torch.equal(model.blocks[0].mlp.fc1.weight, full["blocks.0.mlp.fc1.weight"][256:])


@pytest.mark.parametrize("case", ["heads", "int8", "gumbel", "dual_sto", "attn_drop",
                                  "dist_attn_drop"])
def test_model_axis_refusals(case):
    """What the model axis does not run raises NotImplementedError naming
    ROADMAP.md item 21."""
    with pytest.raises(NotImplementedError, match="item 21"):
        if case == "heads":
            VisionTransformer(ViTConfig(**dict(SMALL, embed_dim=192, num_heads=3)), device="cpu",
                              mesh=MODEL2)
        elif case == "int8":
            VisionTransformer(ViTConfig(**dict(SMALL, quant="int8")), device="cpu", mesh=MODEL2)
        elif case in ("gumbel", "dual_sto"):
            VisionTransformer(ViTConfig(**dict(SMALL, attn_variant=case)), device="cpu",
                              mesh=MODEL2)
        elif case == "attn_drop":
            model = VisionTransformer(ViTConfig(**dict(SMALL, attn_drop_rate=0.1)), device="cpu",
                                      mesh=MODEL2)
            model.train()
            model(torch.zeros(2, 32, 32, 3), generator=torch.Generator())
        else:
            model = DistVisionTransformer(ViTConfig(**dict(SMALL, attn_drop_rate=0.1)),
                                          device="cpu", mesh=MODEL2)
            model.train()
            model(torch.zeros(2, 32, 32, 3), generator=torch.Generator())


@pytest.mark.parametrize("opt", ["lamb", "lars", "adamp", "sgdp", "adafactor", "novograd",
                                 "lookahead_lamb"])
def test_whole_tensor_optimizers_raise_under_a_model_axis(opt):
    model = VisionTransformer(ViTConfig(**SMALL), device="cpu", mesh=MODEL2)
    with pytest.raises(NotImplementedError, match="item 21"):
        TO.make_optimizer(model, opt_name=opt)


@pytest.mark.parametrize("opt", ["adamw", "adam", "sgd", "momentum", "lookahead_adamw",
                                 "rmsprop"])
def test_element_wise_optimizers_run_under_a_model_axis(opt):
    model = VisionTransformer(ViTConfig(**SMALL), device="cpu", mesh=MODEL2)
    assert TO.make_optimizer(model, opt_name=opt) is not None


def test_refused_under_any_mesh():
    """The heteroscedastic head, the split-trunk MC-dropout forward, the
    AdaHessian pass and a resumable checkpoint under a model axis."""
    with pytest.raises(NotImplementedError, match="item 21"):
        VisionTransformer(ViTConfig(**dict(SMALL, head_type="het")), device="cpu", mesh=DATA2)
    model = VisionTransformer(ViTConfig(**SMALL), device="cpu", mesh=DATA2).eval()
    with pytest.raises(NotImplementedError, match="MC-dropout under a mesh"):
        model(torch.zeros(2, 32, 32, 3), mc_samples=2)
    opt = TO.make_optimizer(model, opt_name="adahessian")
    with pytest.raises(NotImplementedError, match="item 21"):
        TE.make_finetune_train_step(model, opt, TE.FinetuneHParams(num_classes=5),
                                    constant_schedule(1e-3), use_hessian=True)
    tp = CyclicalViT(ViTConfig(**SMALL), device="cpu", mesh=MODEL2)
    state = types.SimpleNamespace(model=tp)
    with pytest.raises(NotImplementedError, match="item 21"):
        C.save_checkpoint("unused", 0, state, 0)


def test_global_norm_without_a_model_axis_is_the_plain_one():
    ts = [torch.full((3,), 2.0), torch.full((2, 2), 1.0)]
    assert torch.equal(TO.global_norm(ts, [True, False], None), TO.global_norm(ts))
    assert float(TO.global_norm(ts)) == pytest.approx(math.sqrt(16.0))


def test_jax_params_load_into_a_model_shard():
    """load_flax_params crosses the JAX params into the full dict, then this
    rank's shard (parallel.mesh.shard_state_dict)."""
    import jax

    from uncertainty_vit_tpu.core.config import ViTConfig as JConfig
    from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT

    shapes = jax.eval_shape(JViT(cfg=JConfig(**SMALL)).init, jax.random.PRNGKey(0),
                            np.zeros((1, 32, 32, 3), np.float32))["params"]
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(lambda s: rs.randn(*s.shape).astype(np.float32), shapes)
    full = C.flax_to_state_dict(params)
    model = C.load_flax_params(VisionTransformer(ViTConfig(**SMALL), device="cpu",
                                                 mesh=MODEL2), params)
    got = model.state_dict()
    for k, v in M.shard_state_dict(full, MODEL2).items():
        assert torch.equal(got[k], v), k
    qkv = full["blocks.1.attn.qkv.weight"]
    assert torch.equal(got["blocks.1.attn.qkv.weight"],
                       torch.cat([qkv[64:128], qkv[192:256], qkv[320:384]]))


@pytest.mark.parametrize("flag", ["--sngp", "--gp_layer"])
def test_seq_parallel_trains_the_sngp_heads(flag):
    """--sngp / --gp_layer train under --seq_parallel (the engine sums the
    precision update over the data axis, and a seq group's ranks hold the
    same pooled feature); their evaluation there still raises."""
    base = ["--model", "beit_test_patch16_32", "--data_path", "unused", "--seq_parallel", "2",
            flag]
    TFT._check_seq_flags(TFT.get_args_parser().parse_args(base))
    with pytest.raises(NotImplementedError, match="item 21"):
        TFT._check_seq_flags(TFT.get_args_parser().parse_args(base + ["--eval"]))
