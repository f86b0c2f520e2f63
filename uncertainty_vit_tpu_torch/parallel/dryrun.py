"""The multi-rank dry run: three train engines on one (data × seq × model) mesh.

Counterpart of ``dryrun_multichip`` of the JAX package's entry points
(__graft_entry__.py:30-246)::

    python -m uncertainty_vit_tpu_torch.parallel.dryrun --devices 8 [--device cpu]

starts ``--devices`` gloo ranks (``parallel.seq.run_ranks``; on the card
they share it) on the JAX rule's mesh: a model axis of 2 where the count
is even, then a seq axis of 2 where it still divides, data the rest
(:73-77). On it it takes one step of each engine the JAX dry run takes,
from weights and inputs made from a seed in this process:

* the cyclical step (``train.engine_cyclical``; clip 3.0, layer decay 0.9),
* the finetune step with batch mixup and the SNGP head (layer decay 0.65),
* the dist triplet step (the dist model on the data and model axes; the
  ranks of a seq axis hold replicas).

It asserts what the JAX dry run asserts (a finite loss, step 1, the SNGP
precision moved) and holds each engine's loss and gathered parameters
against the same step of one unsharded process from the same weights and
draws (``compare``). The trunk is the JAX dry run's (32² images, patch 16,
width 128, 2 blocks of 2 heads, drop-path 0.1), in float32, at a constant
lr of 1e-3 (the JAX dry run's warm-up starts at 0, which would leave the
parameters where they were), on a global batch of two images a rank,
from seed 0. It runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import tempfile
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

TINY = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0,
            drop_path_rate=0.1, use_flash_attention=True)
ENGINES = ("cyclical", "finetune", "dist")
NUM_CLASSES = 5
LR = 1e-3
SEED = 0
TIMEOUT = 900.0  # seconds for the ranks' run
# the holds of a sharded step against the unsharded one, in float32: the loss
# and the gradient's global norm (Adam's update lr·g/(|g| + eps) reads little
# of the gradient's size), and the parameters where the unsharded gradient is
# well posed (|g| > 1e-6; elsewhere Adam's first update may round either way,
# and the bound is 2·lr)
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-4
WELL_POSED = 1e-6


def mesh_shape(devices: int) -> Tuple[int, int, int]:
    """(data, seq, model): model 2 if the count is even, then seq 2 where
    it divides what is left (__graft_entry__.py:73-77)."""
    model = 2 if devices % 2 == 0 else 1
    seq = 2 if devices % (model * 2) == 0 else 1
    return devices // (model * seq), seq, model


@dataclasses.dataclass(frozen=True)
class Plan:
    """One dry run: the mesh, the trunk's ViTConfig fields, the global
    batch, and each engine's hyperparameter overrides."""

    mesh: Tuple[int, int, int]
    cfg: Dict[str, Any]
    batch: int
    hp: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)


def _configs(plan: Plan):
    from uncertainty_vit_tpu_torch.core.config import ViTConfig

    base = ViTConfig(**plan.cfg)
    return {"cyclical": base,
            "finetune": base.replace(num_classes=NUM_CLASSES, head_type="sngp"),
            "dist": base.replace(num_classes=NUM_CLASSES, use_flash_attention=False)}


def _model(engine: str, cfg, device, mesh=None, generator=None):
    from uncertainty_vit_tpu_torch.models.cyclical import CyclicalViT
    from uncertainty_vit_tpu_torch.models.dist_vit import DistVisionTransformer
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer

    cls = {"cyclical": CyclicalViT, "finetune": VisionTransformer,
           "dist": DistVisionTransformer}[engine]
    return cls(cfg, device=device, generator=generator, mesh=mesh)


def make_payload(plan: Plan) -> Dict[str, Any]:
    """The three models' full state dicts and the global inputs, on the
    CPU, from ``SEED``: images, masks of [B, patches] whose counts
    differ between the rows, labels, and the triplet's pos (the images
    moved by 0.01) and neg."""
    gen = torch.Generator().manual_seed(SEED)
    cfgs = _configs(plan)
    states = {}
    for i, engine in enumerate(ENGINES):
        g = torch.Generator().manual_seed(SEED + 100 + i)
        states[engine] = {k: v.detach().clone()
                          for k, v in _model(engine, cfgs[engine], "cpu", generator=g)
                          .state_dict().items()}
    cfg = cfgs["cyclical"]
    b, s = plan.batch, cfg.img_size
    images = torch.randn(b, s, s, cfg.in_chans, generator=gen)
    mask = (torch.rand(b, cfg.num_patches, generator=gen) < 0.4).float()
    mask[:, 1] = 1.0  # every image masks at least one patch
    return {"states": states, "images": images, "mask": mask,
            "labels": torch.randint(0, NUM_CLASSES, (b,), generator=gen),
            "pos": images + 0.01, "neg": torch.randn(b, s, s, cfg.in_chans, generator=gen)}


def _launches() -> Dict[str, int]:
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA

    return {"K1": FA.fused_qkv_attention.launches, "K2": FA.fused_qkv_attention_bwd.launches,
            "K5": FA.cross_qkv_attention.launches + FA.cross_qkv_attention_bwd.launches}


def _reset_launches() -> None:
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA

    FA.fused_qkv_attention.launches = FA.fused_qkv_attention_bwd.launches = 0
    FA.cross_qkv_attention.launches = FA.cross_qkv_attention_bwd.launches = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_engines(mesh, plan: Plan, payload: Dict[str, Any], device
                ) -> Dict[str, Dict[str, Any]]:
    """One step of each engine on this rank of ``mesh`` (None: one
    unsharded process on the global batch). Every rank returns its
    metrics, launches and seconds, on the card also those of a second step; rank 0
    and the unsharded run the gathered parameters after the first step, the
    unsharded run also its gradients."""
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA
    from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
    from uncertainty_vit_tpu_torch.parallel import seq
    from uncertainty_vit_tpu_torch.train import engine_cyclical as EC
    from uncertainty_vit_tpu_torch.train import engine_finetune as EF
    from uncertainty_vit_tpu_torch.train import engine_finetune_dist as ED
    from uncertainty_vit_tpu_torch.train.optim import make_optimizer
    from uncertainty_vit_tpu_torch.train.schedules import constant_schedule
    from uncertainty_vit_tpu_torch.utils.checkpoint import full_state_dict

    device = torch.device(device)
    FA.BOUNDED_SCORES = False  # the exact softmax on every rank and in the reference
    cfgs = _configs(plan)
    keep = mesh is None or mesh.rank == 0

    def local(name):
        return meshlib.shard_batch(payload[name], mesh).to(device)

    def gen(offset, on=device):
        return torch.Generator(device=on).manual_seed(SEED + offset)

    lr = constant_schedule(LR)
    out = {}
    for engine in ENGINES:
        cfg = cfgs[engine]
        model = _model(engine, cfg, device, mesh)
        full = {k: v.to(device) for k, v in payload["states"][engine].items()}
        model.load_state_dict(meshlib.shard_state_dict(full, mesh), strict=True)
        hp_kw = dict(plan.hp.get(engine, {}))
        precision0 = None
        if engine == "cyclical":
            opt = make_optimizer(model, weight_decay=0.05, clip_grad=hp_kw.pop("clip_grad", 3.0),
                                 layer_decay=0.9, depth=cfg.depth)
            state = EC.init_cyclical_state(model, opt)
            hp_kw.setdefault("target_layers", tuple(range(max(cfg.depth - 6, 0), cfg.depth)))
            hp_kw.setdefault("ema_start_at", 10)
            step = EC.make_cyclical_train_step(model, opt, EC.CyclicalHParams(**hp_kw), lr)
            args = (state, local("images"), local("mask"), gen(7))
            kwargs = {}
        elif engine == "finetune":
            opt = make_optimizer(model, weight_decay=0.05, layer_decay=0.65, depth=cfg.depth)
            state = EF.init_finetune_state(model, opt)
            hp = EF.FinetuneHParams(num_classes=NUM_CLASSES, head_type="sngp",
                                    mixup_active=True, **hp_kw)
            step = EF.make_finetune_train_step(model, opt, hp, lr)
            precision0 = model.head.precision_matrix.clone()
            args = (state, local("images"), local("labels"), gen(11))
            kwargs = {"mix_generator": gen(12, "cpu")}
        else:
            opt = make_optimizer(model, weight_decay=0.05)
            state = EF.init_finetune_state(model, opt)
            step = ED.make_dist_finetune_train_step(
                model, opt, ED.DistFinetuneHParams(num_classes=NUM_CLASSES, **hp_kw), lr)
            args = (state, local("images"), local("pos"), local("neg"), local("labels"), gen(13))
            kwargs = {"mix_generator": gen(14, "cpu")}
        _sync(device)
        _reset_launches()
        t0 = time.perf_counter()
        metrics = step(*args, **kwargs)
        _sync(device)
        seconds = time.perf_counter() - t0
        res = {"launches": _launches(), "seconds": seconds, "step": int(state.step),
               **{k: float(v) for k, v in metrics.items()}}
        params = full_state_dict(model)
        if engine == "cyclical":
            teacher = full_state_dict(state.teacher)
            params.update({f"teacher.{k}": v for k, v in teacher.items()})
        res["finite"] = all(bool(torch.isfinite(v).all()) for v in params.values())
        if mesh is not None:  # every rank's gathered parameters must agree
            seq.check_equal_on_ranks(list(params.values()), seq.SeqGroup.of(),
                                     f"the {engine} step's parameters")
        if engine == "finetune":
            res["precision_moved"] = float((model.head.precision_matrix - precision0)
                                           .abs().sum())
        if keep:
            # copies: the second step below moves the parameters in place
            res["params"] = {k: v.detach().to("cpu", copy=True) for k, v in params.items()}
            if mesh is None:
                res["grads"] = {k: p.grad.detach().to("cpu", copy=True)
                                for k, p in model.named_parameters() if p.grad is not None}
        if device.type == "cuda":
            # a second step, timed alone: the first pays for the process's
            # first launches and allocations on the card
            _sync(device)
            t0 = time.perf_counter()
            step(*args, **kwargs)
            _sync(device)
            res["warm_seconds"] = time.perf_counter() - t0
        out[engine] = res
        del model, opt, state, step, args, params
    return out


def _rank(mesh, plan: Plan, path: str, device: str) -> Dict[str, Any]:
    """One rank of the dry run (``parallel.seq.run_ranks`` with a mesh)."""
    torch.set_num_threads(1)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    payload = torch.load(path, map_location="cpu")
    out = run_engines(mesh, plan, payload, device)
    out["coords"] = [mesh.index(a) for a in ("data", "seq", "model")]
    return out


def run_sharded(plan: Plan, payload: Dict[str, Any], device):
    """Every rank's result of the dry run on ``plan.mesh``."""
    from uncertainty_vit_tpu_torch.parallel import seq

    n = plan.mesh[0] * plan.mesh[1] * plan.mesh[2]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "payload.pt")
        torch.save(payload, path)
        return seq.run_ranks(_rank, n, plan, path, str(device), timeout=TIMEOUT, mesh=plan.mesh)


def compare(ref: Dict[str, Any], got: Dict[str, Any]) -> Dict[str, Any]:
    """The sharded step (rank 0's gathered parameters) against the
    unsharded one: the relative difference of the loss and of the
    gradient's global norm, the parameters' worst excess over PARAM_RTOL /
    PARAM_ATOL where the gradient is well posed,
    their largest difference elsewhere against 2·lr, and the share of
    well-posed entries (above one half: the dist model's unread cov_qkv
    has no gradient). ``ok`` when all hold."""
    loss_rel = abs(got["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-30)
    norm_rel = abs(got["grad_norm"] - ref["grad_norm"]) / max(ref["grad_norm"], 1e-30)
    worst, worst_key, loose, posed, total = 0.0, None, 0.0, 0, 0
    for k, want in ref["params"].items():
        have = got["params"][k]
        grad = ref["grads"].get(k.removeprefix("teacher."))
        diff = (have.double() - want.double()).abs()
        if grad is None:
            mask = torch.ones_like(diff, dtype=torch.bool)
        else:
            mask = grad.abs() > WELL_POSED
        excess = diff - (PARAM_ATOL + PARAM_RTOL * want.double().abs())
        if mask.any():
            e = float(excess[mask].max())
            if e > worst or worst_key is None:
                worst, worst_key = e, k
        if (~mask).any():
            loose = max(loose, float(diff[~mask].max()))
        posed += int(mask.sum())
        total += mask.numel()
    share = posed / total
    ok = (loss_rel <= LOSS_RTOL and norm_rel <= LOSS_RTOL and worst <= 0.0 and loose <= 2 * LR
          and share > 0.5 and got["finite"] and got["step"] == 1)
    return {"loss": got["loss"], "ref_loss": ref["loss"], "loss_rel": loss_rel,
            "grad_norm": got["grad_norm"], "ref_grad_norm": ref["grad_norm"],
            "grad_norm_rel": norm_rel,
            "worst_excess": worst, "worst_param": worst_key, "loose_max": loose,
            "well_posed_share": share, "ok": ok}


def dryrun(plan: Plan, device) -> Dict[str, Any]:
    """The dry run: the unsharded steps in this process, then the ranks;
    returns the comparisons and every rank's metrics, and raises where an
    assert or a hold fails."""
    device = torch.device(device)
    payload = make_payload(plan)
    if device.type == "cuda":
        from uncertainty_vit_tpu_torch.ops import _native

        _native.build_all()  # once here, before the ranks would race for the build
    ref = run_engines(None, plan, payload, device)
    ranks = run_sharded(plan, payload, device)
    report = {"mesh": plan.mesh, "engines": {}}
    failures = []
    for engine in ENGINES:
        res = compare(ref[engine], ranks[0][engine])
        res["launches_per_rank"] = [r[engine]["launches"] for r in ranks]
        res["seconds_per_rank"] = [r[engine]["seconds"] for r in ranks]
        res["warm_seconds_per_rank"] = [r[engine].get("warm_seconds") for r in ranks]
        res["ref_seconds"] = ref[engine]["seconds"]
        res["ref_warm_seconds"] = ref[engine].get("warm_seconds")
        if not all(math.isfinite(r[engine]["loss"]) for r in ranks):
            failures.append(f"{engine}: a non-finite loss")
        if len({r[engine]["loss"] for r in ranks}) != 1:
            failures.append(f"{engine}: the ranks' losses differ")
        if engine == "finetune":
            res["precision_moved"] = ranks[0][engine]["precision_moved"]
            if not res["precision_moved"] > 0.0:
                failures.append("sngp precision matrix did not update")
        if not res["ok"]:
            failures.append(f"{engine}: the sharded step disagrees with the unsharded one: "
                            f"{ {k: v for k, v in res.items() if k != 'ok'} }")
        report["engines"][engine] = res
    if failures:
        raise AssertionError("; ".join(failures))
    return report


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("uncertainty_vit_tpu_torch.parallel.dryrun")
    p.add_argument("--devices", type=int, default=8, help="ranks (gloo processes)")
    p.add_argument("--device", default="cuda", help="cuda (every rank on card 0) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = get_args_parser().parse_args(argv)
    if args.device not in ("cuda", "cpu"):
        raise ValueError(f"--device takes cuda or cpu, got {args.device!r}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    plan = Plan(mesh_shape(args.devices), dict(TINY), 2 * args.devices)
    report = dryrun(plan, device)
    parts = []
    for engine, res in report["engines"].items():
        parts.append(f"{engine} loss={res['loss']:.6f} (unsharded {res['ref_loss']:.6f}, "
                     f"rel {res['loss_rel']:.2e}; grad norm rel {res['grad_norm_rel']:.2e}; "
                     f"params worst excess {res['worst_excess']:.2e})")
    print(f"dryrun({args.devices}) ok: mesh (data, seq, model)={plan.mesh}, engines=["
          + ", ".join(parts) + f"], sngp precision moved {report['engines']['finetune']['precision_moved']:.4g}",
          flush=True)
    return report


if __name__ == "__main__":
    # through the module's own name, so that the spawned ranks find _rank and Plan
    from uncertainty_vit_tpu_torch.parallel import dryrun as _dryrun

    _dryrun.main()
    sys.exit(0)
