"""Supervised finetune / evaluation driver: counterpart of
uncertainty_vit_tpu/cli/finetune.py, which replaces the reference's
run_class_finetuning.py.

    python -m uncertainty_vit_tpu_torch.cli.finetune \
        --finetune CKPT.pth --data_set CIFAR100 --data_path DIR --output_dir OUT ...
    python -m uncertainty_vit_tpu_torch.cli.finetune --eval \
        [--mc_dropout | --ensembles --ensemble_checkpoints A.pth B.pth] \
        --finetune CKPT.pth --data_set CIFAR100 --data_path DIR ...
    python -m uncertainty_vit_tpu_torch.cli.finetune --stochastic \
        --model dist_beit_base_patch16_224 --finetune CKPT.pth ... [--eval]

Ported: the train loop (``main`` without ``--eval``, JAX :580-790): the
train split's uint8 batches onto the device, the train transform there
(random resized crop, flip, RandAugment or colour jitter, erasing), mixup
in batch, elem or pair mode (with ``--cutmix_minmax``), on-the-fly token
masking (``--masked_position_prob``), AdamW with layer decay and its
schedules, gradient accumulation (``--update_freq``), --linear_classifier
freezing, --finetune / --resume / --auto_resume / --start_epoch, the 2-deep
deferred readback of the metrics with the NaN abort, each epoch's
evaluation, log.txt and checkpoint-{N,best}.pth. The evaluation from images
(``--eval``): the split's loader, uint8 batches onto the device, the eval
resize and crop there, then the dispatch of run_class_finetuning.py:638-677
(JAX :374-549): plain evaluation, ``--mc_dropout``, ``--ensembles``, the
corruption (``--corrupted_data``: CIFAR-C ``.npy`` files or a
TinyImageNet-C tree) and perturbation (``--perturbed_data``: CIFAR-P)
benchmarks, the last-layer Laplace posterior (``--laplace``, probit or mc
link) and temperature scaling (``--temp_scaling`` fitted on the eval,
train or a held-out split), printing the JAX driver's JSON dict;
``--visualize_embedding`` writes the pooled features' TSVs and exits
(JAX :564-574). The heads (``--sngp``, ``--gp_layer``, ``--het_layer``) train
and evaluate: the SNGP precision matrix restarts at each epoch under
``--sngp_cov_momentum`` ≤ 0, and the heteroscedastic head draws its noise
from the step's fourth generator in training and from a fresh generator a
batch in evaluation. The driver's mesh (JAX :185-197, ``create_mesh``,
uncertainty_vit_tpu/parallel/mesh.py:21-44) is data × seq × model ranks,
model = 1: under a launcher (``parallel.distributed.probe_cluster``: RANK /
WORLD_SIZE, SLURM, OpenMPI) each of its W processes is one rank of a mesh
of data = W / --seq_parallel, seq = --seq_parallel, on the card of its
local rank; without one, ``--seq_parallel S`` runs S ranks sharing
``device`` (``parallel.seq.run_ranks``, one gloo group, one data index),
and ``main(args, device, mesh=(D, S, 1))`` lays out D · S such ranks (the
tests and the card's smoke; it is not a flag). The seq ranks of a data
index split the tokens of each image and read the same batches; the data
ranks read their shards of each split (``BatchLoader``'s host shards,
padded on a data axis) with --batch_size a rank, so a mesh of D data ranks
is one process given a batch of D · --batch_size: every draw (the train
transform's, mixup's, drop-path, dropout and masking, K8's MC-dropout
masks, the het head's noise) is the global batch's, the rank's rows kept,
and each evaluation's metrics are those of the union of the ranks' logits,
each sample once (``evals.collect.DataShards``). Rank 0 alone prints,
writes log.txt and the checkpoints, and returns its result (a rank's train
state is pickled back through a queue); the parameters are held equal on
every rank after each epoch. ``main`` takes ``device`` (the card by
default; the tests pass "cpu"); the JAX driver has no such flag, and
neither has this one.

``--stochastic`` selects the dist (mean+covariance) model (JAX :193-196,
``models.dist_vit.DistVisionTransformer``; ``--model`` also takes
``dist_beit_base_patch16_224``, which needs the flag): training reads
triplet batches (``data.datasets.TripletDataset``: the anchor through the
train transform and mixup, pos and neg through the eval transform, all on
the device; ``--decode_letterbox`` raises) into
``train.engine_finetune_dist``'s step, and each epoch's evaluation is the
metrics of the logits (``evals.classification.evaluate_dist``; the best
checkpoint by acc1); ``--eval`` gives ``results["dist_eval"]``, and
``--corrupted_data`` / ``--perturbed_data`` take the logits of its
deterministic forward. What the dist model does not read raises
``ValueError`` under the flag (``DIST_UNREAD``: the JAX driver ignores
each, ROADMAP.md §3): ``--model_ema``, ``--quant int8``,
``--masked_position_prob``, the heads (``--sngp``, ``--gp_layer``,
``--het_layer``), ``--learn_layer_weights``, ``--layernorm_before_combine``,
``--remove_final_norm``, ``--abs_pos_emb``, ``--per_block_rel_pos_bias``,
``--dropout_from_block``, the attention variants (``--sinkformer``,
``--gumbel_softmax``, ``--h_sto_trans``), an ``--init_scale`` other than
0.001 (the dist head is drawn unscaled), and the dispatches that would run
another model (``--mc_dropout``, ``--ensembles``,
``--visualize_embedding``, ``--laplace``, ``--temp_scaling``);
``--seq_parallel`` raises as in JAX. On the mesh's data axis the dist
model trains and evaluates as one process given the global batch: each
anchor's negative is one process's draw at its read
(``TripletDataset.plan``), the losses' maxima span the data ranks,
and the evaluation's metrics are the union's.

On the mesh every evaluation runs: ``--mc_dropout`` (folded and split;
each rank folds its rows and K8 draws the one-process masks' rows), the
heads (``--sngp``, ``--gp_layer``, ``--het_layer`` in training and
evaluation) and the post-hoc evaluations (-C, -P, ``--laplace``,
``--temp_scaling``, ``--visualize_embedding``), which read the whole
split on every rank and draw as one process (``WHOLE_SPLIT_DISPATCHES``),
so their fits sum over no group. ``--sinkformer`` and ``--opt
adahessian`` run on the data and seq axes (the Hessian pass's double
backward through the collectives' differentiable backwards,
``parallel.seq`` and ``parallel.mesh``; each rank's share of D summed as
its gradient is). On the data axis ``--quant int8`` runs in training and
evaluation (the gradients' rounding bits of the global batch's rows, K6 /
K7's row window with the rank's first image, the wgrad scales over the
data × seq ranks, the int8 decision on the global trunk) and so does
attention dropout in training and under ``--mc_dropout`` (K1-K4 key the
mask on the rank's images of the global batch, the batch fold).

Not ported yet, and raising ``NotImplementedError`` with the ROADMAP item
that ports it, before any rank starts: on the mesh the Gumbel-drawing
attention variants (item 20's rest); and under a gumbel or dual_sto
attention ``--laplace`` and ``--visualize_embedding``. A ``--finetune``
or ensemble member that is not a ``.pth`` is an orbax checkpoint
directory of the JAX package, read as
the JAX driver reads it (``load_variables``); a ``--resume`` or
``--auto_resume`` of one raises (ROADMAP.md item 23: its optax state does
not cross packages). Attention dropout under ``--seq_parallel`` raises
``ValueError`` in training and under ``--mc_dropout``, as the JAX
package's attention does.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch

from uncertainty_vit_tpu_torch.cli import builders as B
from uncertainty_vit_tpu_torch.cli.common import setup
from uncertainty_vit_tpu_torch.core.config import GUMBEL_VARIANTS, draws_gumbel
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.data import datasets as D
from uncertainty_vit_tpu_torch.data.pipeline import BatchLoader, device_prefetch
from uncertainty_vit_tpu_torch.evals import calibration as CAL
from uncertainty_vit_tpu_torch.evals import classification as E
from uncertainty_vit_tpu_torch.evals import laplace as LA
from uncertainty_vit_tpu_torch.evals import robustness as R
from uncertainty_vit_tpu_torch.evals.collect import (
    DataShards, _finish, _start_readback, per_call_generator,
)
from uncertainty_vit_tpu_torch.evals.ensembles import (
    ensemble_mean_logits, make_ensemble_forward, stack_params,
)
from uncertainty_vit_tpu_torch.evals.mc_dropout import make_mc_dropout_mean_forward
from uncertainty_vit_tpu_torch.models.dist_vit import DistVisionTransformer
from uncertainty_vit_tpu_torch.models.layers import whole_batch
from uncertainty_vit_tpu_torch.models.registry import sngp_reset_cov
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops.augment import (
    IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, IMAGENET_INCEPTION_MEAN, IMAGENET_INCEPTION_STD,
    eval_transform_batch, make_finetune_train_augment, normalize, to_float,
)
from uncertainty_vit_tpu_torch.parallel import distributed as dist_boot
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
from uncertainty_vit_tpu_torch.parallel import seq
from uncertainty_vit_tpu_torch.train.engine_finetune import (
    FinetuneHParams, init_finetune_state, make_finetune_train_step, optional_streams,
    step_generators,
)
from uncertainty_vit_tpu_torch.train.engine_finetune_dist import (
    DistFinetuneHParams, make_dist_finetune_train_step,
)
from uncertainty_vit_tpu_torch.train.optim import freeze_all_except, needs_hessian
from uncertainty_vit_tpu_torch.utils import checkpoint as C
from uncertainty_vit_tpu_torch.utils import embeddings as EMB
from uncertainty_vit_tpu_torch.utils.logging import JsonlLogger, MetricLogger, TensorboardLogger

# what the driver's mesh (--seq_parallel, or a launcher's ranks) does not
# run yet: flag → what it turns on. The Gumbel noise is drawn at the rank's
# own shapes (ROADMAP.md item 20's rest)
NOT_PORTED_UNDER_SEQ = {
    "gumbel_softmax": "the Gumbel-softmax attention",
    "h_sto_trans": "the dual stochastic attention",
}

# the --eval dispatches that run the whole split on every data rank (one
# process's forwards, ``models.layers.whole_batch``): flag → whether it is set
WHOLE_SPLIT_DISPATCHES = {
    "corrupted_data": lambda a: a.corrupted_data,
    "perturbed_data": lambda a: a.perturbed_data,
    "laplace": lambda a: a.laplace,
    "temp_scaling": lambda a: a.temp_scaling,
    "visualize_embedding": lambda a: a.visualize_embedding,
}

# what a model that draws Gumbel noise in every forward does not run yet:
# their forwards take no generator (ROADMAP.md item 20's rest)
NOT_PORTED_WITH_GUMBEL = {
    "laplace": "the last-layer Laplace posterior",
    "visualize_embedding": "the embedding dump",
}

DIST_MODELS = ("dist_beit_base_patch16_224",)

# what the dist model (--stochastic) does not read, or the dispatches that
# would run another model on its weights, beside builders.DIST_UNREAD: flag
# → whether it is set. The JAX driver ignores each under --stochastic
# (ROADMAP.md §3); here each raises
DIST_UNREAD = {
    **B.DIST_UNREAD,
    "model_ema": lambda a: a.model_ema,
    "masked_position_prob": lambda a: a.masked_position_prob > 0,
    "gp_layer": lambda a: a.gp_layer,
    "learn_layer_weights": lambda a: a.learn_layer_weights,
    "layernorm_before_combine": lambda a: a.layernorm_before_combine,
    "remove_final_norm": lambda a: a.remove_final_norm,
    "init_scale": lambda a: a.init_scale != B.INIT_SCALE,
    "mc_dropout": lambda a: a.mc_dropout,
    "ensembles": lambda a: a.ensembles,
    "visualize_embedding": lambda a: a.visualize_embedding,
    "laplace": lambda a: a.laplace,
    "temp_scaling": lambda a: a.temp_scaling,
}


def get_args_parser():
    p = argparse.ArgumentParser("finetuning / evaluation", add_help=True)
    B.add_model_args(p, DIST_MODELS)
    B.add_opt_args(p, lr=4e-3)
    B.add_data_args(p)
    B.add_io_args(p)
    g = p.add_argument_group("finetune")
    g.add_argument("--nb_classes", type=int, default=0, help="0 = infer from dataset")
    g.add_argument("--seq_parallel", type=int, default=1,
                   help="context-parallel factor: split the tokens of each "
                        "image over that many ranks (384/512 scaling): the "
                        "seq axis of a launcher's ranks, or without a "
                        "launcher that many gloo ranks sharing the one card")
    g.add_argument("--mixup", type=float, default=0.8)
    g.add_argument("--cutmix", type=float, default=1.0)
    g.add_argument("--mixup_prob", type=float, default=1.0)
    g.add_argument("--mixup_switch_prob", type=float, default=0.5)
    g.add_argument("--smoothing", type=float, default=0.1)
    g.add_argument("--model_ema", action="store_true")
    g.add_argument("--model_ema_decay", type=float, default=0.9999)
    g.add_argument("--masked_position_prob", type=float, default=0.0)
    g.add_argument("--target_layer", type=int, default=-1,
                   help="truncate blocks to [:N+1] (run_class_finetuning.py:520-522)")
    g.add_argument("--remove_final_norm", action="store_true")
    g.add_argument("--disable_eval_during_finetuning", action="store_true")
    g.add_argument("--dual_finetune", action="store_true",
                   help="keep the checkpoint head/norms verbatim on import "
                        "(run_class_finetuning.py:408-418 skips the "
                        "shape-mismatch head drop)")
    g.add_argument("--reinit_final_norm", action="store_true",
                   help="drop norm/fc_norm from the imported checkpoint "
                        "(run_class_finetuning.py:413-417)")
    g.add_argument("--laplace", action="store_true",
                   help="last-layer KFAC Laplace on the linear head, fit on "
                        "the train split with marginal-likelihood prior "
                        "tuning (the reference's intended dispatch, "
                        "run_class_finetuning.py:651-656, is dead there — "
                        "its laplace import is commented out at :40; this "
                        "is a native implementation, evals/laplace.py)")
    g.add_argument("--laplace_link", choices=["probit", "mc"], default="probit",
                   help="Laplace predictive link approximation")
    g.add_argument("--temp_scaling", action="store_true",
                   help="post-hoc temperature scaling (Guo et al. 2017) — a "
                        "calibration baseline the reference's metric suite "
                        "measures against but never provides "
                        "(evals/calibration.py)")
    g.add_argument("--temp_scaling_split", choices=["eval", "train", "heldout"],
                   default="eval",
                   help="where to fit T*: 'eval' fits the one scalar on the "
                        "reported split (standard when no held-out "
                        "calibration set exists; negligible leak), 'heldout' "
                        "carves --temp_scaling_heldout_frac of eval for the "
                        "fit and reports on the remainder (Guo et al. "
                        "protocol, leak-free), 'train' matches the Laplace "
                        "protocol (sound only for underfit models — "
                        "near-zero train NLL gives T*~1)")
    g.add_argument("--temp_scaling_heldout_frac", type=float, default=0.1,
                   help="fraction of the eval split carved out as the T* fit "
                        "set under --temp_scaling_split heldout")
    g.add_argument("--lambda_finetuning", type=float, default=1e-4)
    g.add_argument("--lambda_pvn", type=float, default=1e-4)
    e = p.add_argument_group("evaluation")
    e.add_argument("--eval", action="store_true")
    e.add_argument("--mc_dropout", action="store_true")
    e.add_argument("--mc_dropout_forwards", type=int, default=8)
    e.add_argument("--mc_dropout_split_at", type=int, default=0,
                   help="share blocks [0, s) across the K samples (one "
                        "deterministic trunk pass). EXACT MC-dropout when "
                        "--dropout_from_block >= s; otherwise a documented "
                        "last-layers approximation. Meets the K=8 <= 4x "
                        "cost target at s >= 8 (depth 12)")
    e.add_argument("--visualize_embedding", action="store_true",
                   help="dump val-set pooled features as TensorBoard-"
                        "projector TSVs + a PCA scatter, then exit "
                        "(run_class_finetuning.py:634-637)")
    e.add_argument("--ensembles", action="store_true")
    e.add_argument("--ensemble_checkpoints", type=str, nargs="*", default=[])
    e.add_argument("--corrupted_data", action="store_true")
    e.add_argument("--perturbed_data", action="store_true")
    e.add_argument("--corruption_data_path", type=str, default=None)
    e.add_argument("--perturbation_data_path", type=str, default=None)
    e.add_argument("--wnids_path", type=str, default=None,
                   help="wnids.txt for TinyImageNet-C class ids (defaults: "
                        "corruption root, then a sibling clean TinyImageNet dir)")
    return p


def _aa_kwargs(args) -> Dict:
    """Parse a 'rand-mM-mstdS[-inc1]' --aa policy (run_class_finetuning.py's
    default) into finetune_train_augment_batch's keywords; {} when off.

    Unknown or unsupported tokens raise: a recipe's typo ('n3', 'p0.5')
    must not become a silent change of the augmentation. The on-device
    RandAugment has timm's two increasing-severity rounds built in, so 'n2'
    and 'inc1' are accepted and change nothing, and every other timm knob
    is refused."""
    aa = getattr(args, "aa", None)
    if not aa or aa in ("None", "none"):
        return {}
    parts = aa.split("-")
    if parts[0] != "rand":
        raise ValueError(
            f"--aa policy {aa!r} not supported: only timm 'rand-...' "
            "configs map onto the on-device RandAugment "
            "(ops/randaugment.py); 'original'/'augmix' policies are not "
            "carried"
        )

    def bad(part):
        return ValueError(
            f"unsupported --aa token {part!r} in {aa!r}: the on-device "
            "RandAugment supports m<mag>, mstd<std>, inc1, n2 "
            "(two rounds and increasing severity are baked in)"
        )

    mag, mstd = 9.0, 0.5
    for part in parts[1:]:
        if part.startswith("mstd"):
            try:
                mstd = float(part[4:])
            except ValueError:
                raise bad(part) from None
        elif part in ("inc1", "n2"):
            pass
        elif part.startswith("m") and part[1:].replace(".", "").isdigit():
            try:
                mag = float(part[1:])
            except ValueError:  # 'm1.2.3' passes the isdigit gate
                raise bad(part) from None
        else:
            raise bad(part)
    return {"auto_augment": True, "aa_magnitude": mag, "aa_magnitude_std": mstd}


def build_model(args, nb_classes: int, device=None, mesh: Optional[meshlib.Mesh] = None):
    """(model, config) of the flags, its parameters drawn from a generator
    seeded with ``--seed`` on ``device`` (the card by default); on the
    driver's ``mesh`` this rank's share of the tokens (its seq axis,
    ``--seq_parallel``) and of the batch (its data axis).
    --stochastic: the ``DistVisionTransformer`` of the same config."""
    cfg = B.model_config_from_args(args, nb_classes)
    if getattr(args, "masked_position_prob", 0.0) > 0:
        cfg = cfg.replace(has_masking=True)
    if getattr(args, "target_layer", -1) != -1 and not args.learn_layer_weights:
        cfg = cfg.replace(depth=args.target_layer + 1)
    if getattr(args, "remove_final_norm", False):
        cfg = cfg.replace(remove_final_norm=True)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.stochastic:
        return DistVisionTransformer(cfg, B.compute_dtype(args), device=device,
                                     generator=gen, mesh=mesh), cfg
    model = VisionTransformer(cfg, B.compute_dtype(args), device=device, generator=gen,
                              mesh=mesh)
    return model, cfg


def _eval_prep(images_u8, args, device: torch.device) -> torch.Tensor:
    """One uint8 batch on ``device``, through the eval transform: resize and
    centre crop when its size is not --input_size, else normalize only."""
    x = torch.as_tensor(images_u8).to(device)
    crop_pct = args.crop_pct or (224 / 256 if args.input_size < 384 else 1.0)
    if x.shape[1] != args.input_size:
        return eval_transform_batch(x, args.input_size, crop_pct,
                                    args.imagenet_default_mean_and_std)
    mean = IMAGENET_DEFAULT_MEAN if args.imagenet_default_mean_and_std else IMAGENET_INCEPTION_MEAN
    std = IMAGENET_DEFAULT_STD if args.imagenet_default_mean_and_std else IMAGENET_INCEPTION_STD
    return normalize(to_float(x), mean, std)


def _eval_batches(loader, args, device: torch.device):
    """Yield (normalized images, labels) on ``device``, each batch copied
    there ahead of its use (``device_prefetch``)."""
    for batch in device_prefetch(loader, device):
        yield _eval_prep(batch[0], args, device), batch[-1]


def _require_pth(path: str, what: str) -> None:
    """A train state to resume from must be the port's own ``.pth``: the
    JAX package's orbax train state holds an optax state, which does not
    cross packages (ROADMAP.md item 23 carries its weights only, through
    --finetune)."""
    if not path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{what} {path!r}: the port resumes from its own checkpoint-N.pth files only; an "
            "orbax train state of the JAX package holds an optax state that does not cross "
            "packages (ROADMAP.md item 23 carries its weights: pass the directory to "
            "--finetune)")


def load_variables(args, model: VisionTransformer) -> List[str]:
    """Load --finetune into ``model`` (the surgery of run_class_finetuning.py:
    400-540, ``utils.checkpoint.import_torch_state_dict``). A ``.pth`` is
    imported after stripping --model_prefix and, with --reinit_final_norm,
    dropping the final norms (:413-417). Returns the model's parameters the
    checkpoint did not fill (its buffers, such as the SNGP head's random
    features and precision matrix, are counted apart, as the JAX driver
    counts its params alone; a checkpoint's ``fc_norm.weight_u`` /
    ``weight_v`` fill the spectral fc_norm's, as JAX
    ``import_torch_spectral_stats`` does).

    Any other path is an orbax checkpoint directory of the JAX package
    (``utils.checkpoint.read_weights``: its ``params`` and SNGP
    buffers), taken as the JAX driver's orbax branch takes it
    (cli/finetune.py:259-263): --model_prefix and --reinit_final_norm are
    not applied, and the head counts as missing even where the checkpoint
    filled it, so that --linear_classifier trains it. Where the JAX driver
    cannot apply the tree (no ``head``, a head of another class count) the
    surgery's rules hold, as for a ``.pth`` (ROADMAP.md §3)."""
    missing: List[str] = []
    if args.finetune:
        orbax = not args.finetune.endswith((".pth", ".pt"))
        sd = C.read_weights(args.finetune)
        if not orbax:
            prefix = getattr(args, "model_prefix", "")
            if prefix:
                sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
            if getattr(args, "reinit_final_norm", False):
                sd = {k: v for k, v in sd.items()
                      if k not in ("norm.weight", "norm.bias", "fc_norm.weight", "fc_norm.bias")}
        state, missing, unused = C.import_torch_state_dict(
            sd, model.state_dict(), keep_mismatched_head=getattr(args, "dual_finetune", False))
        model.load_state_dict(state, strict=True)
        params = dict(model.named_parameters())
        missing = [k for k in missing if k in params]
        if orbax:
            missing = sorted(set(missing) | {"head.weight", "head.bias"})
        print(f"imported {args.finetune}: {len(missing)} missing, {len(unused)} unused",
              flush=True)
    return missing


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _mc_eval_model(model: VisionTransformer) -> VisionTransformer:
    """The eval model with stochastic depth off for MC-dropout: the
    reference's enable_dropout turns only the dropouts on
    (uncertainty_evaluations.py:35-39), so the evaluation must not inherit
    the training --drop_path rate. Same weights and mesh (or seq group), a
    second module."""
    place = ({"mesh": model.mesh} if model.mesh is not None
             else {"seq_group": model.seq_group})
    mc = VisionTransformer(model.cfg.replace(drop_path_rate=0.0), model.dtype,
                           device=_device_of(model), **place)
    mc.load_state_dict(model.state_dict(), strict=True)
    return mc


def _load_ensemble_members(args, model: VisionTransformer) -> List[Dict[str, torch.Tensor]]:
    """--ensemble_checkpoints → one state dict per member, each imported over
    the model's state (replaces the reference's path templates,
    engine_for_finetuning.py:234-242): a ``.pth``, or an orbax checkpoint
    directory of the JAX package (``utils.checkpoint.read_weights``)."""
    members = []
    for path in args.ensemble_checkpoints:
        state, _, _ = C.import_torch_state_dict(C.read_weights(path), model.state_dict())
        members.append(state)
    return members


def _mc_mean_forward(args, model: VisionTransformer) -> Callable[[torch.Tensor], torch.Tensor]:
    """images → the MC-dropout mean logits, each call's masks from a fresh
    generator of the stream --seed starts (the reference redraws the masks
    on every forward, uncertainty_evaluations.py:479-534). For the -C / -P
    dispatches."""
    mc = make_mc_dropout_mean_forward(_mc_eval_model(model), args.mc_dropout_forwards,
                                      split_at=args.mc_dropout_split_at)
    fresh = per_call_generator(args.seed, _device_of(model))
    return lambda imgs: mc(imgs, fresh())


def _default_eval_forward(args, model: VisionTransformer) -> Callable[[torch.Tensor], torch.Tensor]:
    """The deterministic eval forward for the -C / -P and temperature
    dispatches; with --het_layer, or a gumbel / dual_sto attention, each
    call draws the noise from a fresh generator of the --seed stream (JAX
    :311-321)."""
    if E.draws_in_eval(model, args.het_layer):
        fwd = E.make_eval_forward(model, het=args.het_layer)
        fresh = per_call_generator(args.seed, _device_of(model))
        return lambda imgs: fwd(imgs, fresh())
    return E.make_eval_forward(model)


def _ensemble_mean_forward(args, model: VisionTransformer) -> Callable[[torch.Tensor], torch.Tensor]:
    """images → the members' mean logits (ensembles_c_evaluate /
    ensembles_p_evaluate, uncertainty_evaluations.py:393-476, 724-737)."""
    stacked = stack_params(_load_ensemble_members(args, model))
    efwd = make_ensemble_forward(model)
    if draws_gumbel(model.cfg):
        fresh = per_call_generator(args.seed, _device_of(model))
        return lambda imgs: ensemble_mean_logits(efwd(stacked, imgs, fresh()))
    return lambda imgs: ensemble_mean_logits(efwd(stacked, imgs))


def _fit_loader(args, model: VisionTransformer):
    """The train split for the post-hoc fits (Laplace, temperature): the
    whole split through the eval transform, unshuffled, no tail dropped,
    unpadded; the letterboxed decode is a train-augmentation matter, so it
    is off (JAX :324-336). The ranks of the driver's mesh read the whole
    split, each the same batches (inside ``whole_batch``): every sample
    counts once, no padded duplicate among them."""
    fit_args = argparse.Namespace(**{**vars(args), "decode_letterbox": False})
    one_process = model.mesh is None and model.seq_group is None
    loader, _ = B.build_loaders(fit_args, is_train=True, shuffle=False, drop_last=False,
                                pad_shards=False, host=None if one_process else (0, 1))
    return loader


def _fit_laplace(args, model: VisionTransformer):
    """Fit the last-layer KFAC Laplace posterior on the train split and tune
    its prior (JAX :338-371). Returns (posterior, images → (logits,
    features), (logits, features) → predictive log-probabilities, the mc
    link drawing from a fresh generator of the --seed stream a call)."""
    if model.cfg.head_type != "linear":
        raise ValueError("--laplace needs the linear head (last-layer Laplace); "
                         f"head_type={model.cfg.head_type!r} is itself an uncertainty method")
    device = _device_of(model)
    ffwd = LA.make_feature_forward(model)
    la = LA.fit_last_layer_laplace(
        ffwd, {"weight": model.head.weight.detach(), "bias": model.head.bias.detach()},
        _eval_batches(_fit_loader(args, model), args, device))
    la = LA.optimize_prior_precision(la)
    print(f"laplace: fit on {la.n} samples, prior precision {la.prior_precision:g}", flush=True)
    fresh = per_call_generator(args.seed, device)

    def pred(logits: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return LA.predictive_log_probs(la, logits, feats, link=args.laplace_link,
                                           generator=fresh())

    return la, ffwd, pred


def _check_eval_flags(args) -> None:
    """The combinations the JAX driver refuses, with its words (JAX
    :380-400)."""
    if args.laplace and (args.perturbed_data or args.ensembles or args.stochastic
                         or args.mc_dropout):
        raise ValueError("--laplace composes with the clean eval and --corrupted_data "
                         "only; mc/ensembles/stochastic/-P combinations are not carried")
    if args.temp_scaling and (args.laplace or args.corrupted_data or args.perturbed_data
                              or args.ensembles or args.stochastic or args.mc_dropout):
        raise ValueError("--temp_scaling supports the clean eval path only (and is "
                         "itself a calibrator — combining with --laplace is ambiguous)")


def _corruption_eval(args, model: VisionTransformer) -> Dict:
    """--corrupted_data (JAX :402-464): per distortion and severity, the
    corrupted images through the eval transform and the chosen forward;
    distortions without data are skipped."""
    device = _device_of(model)
    if args.stochastic:
        # the logits of the dist model's deterministic forward (JAX :403-404)
        fwd = E.make_dist_eval_forward(model)
    elif args.mc_dropout:
        fwd = _mc_mean_forward(args, model)
    elif args.laplace:
        # the Laplace predictive's log-probabilities serve as logits
        _, ffwd, pred = _fit_laplace(args, model)
        fwd = lambda imgs: pred(*ffwd(imgs))  # noqa: E731
    elif args.ensembles:
        fwd = _ensemble_mean_forward(args, model)
    else:
        fwd = _default_eval_forward(args, model)
    croot = args.corruption_data_path or args.data_path
    cifar = args.data_set.startswith("CIFAR")
    available = tuple(
        d for d in R.DISTORTIONS
        if (os.path.exists(os.path.join(croot, f"{d}.npy")) if cifar
            else os.path.isdir(os.path.join(croot, d))))
    skipped = set(R.DISTORTIONS) - set(available)
    if skipped:
        print(f"skipping distortions with no data: {sorted(skipped)}", flush=True)
    crop_pct = args.crop_pct or (224 / 256 if args.input_size < 384 else 1.0)

    def loader_factory(name: str):
        for severity in range(1, 6):
            if cifar:
                ds = D.load_cifar_c(croot, name, severity)
                for i in range(0, len(ds), args.batch_size):
                    imgs = torch.from_numpy(ds.images[i:i + args.batch_size]).to(device)
                    # the clean evaluation's transform (datasets.py:251-260)
                    yield (eval_transform_batch(imgs, args.input_size, crop_pct,
                                                args.imagenet_default_mean_and_std),
                           ds.labels[i:i + args.batch_size])
            else:  # the TinyImageNet-C layout
                ds = D.TinyImageNetC(croot, name, severity, wnids_path=args.wnids_path,
                                     decode_size=args.input_size)
                yield from _eval_batches(
                    BatchLoader(ds, args.batch_size, shuffle=False,
                                num_workers=args.num_workers, drop_last=False), args, device)

    return R.evaluate_corruption(fwd, loader_factory, distortions=available)


def _perturbation_eval(args, model: VisionTransformer, nb_classes: int) -> Dict:
    """--perturbed_data (JAX :466-497): CIFAR-P videos, as many whole videos
    a batch as fit in --batch_size frames, through the chosen forward."""
    if args.stochastic:
        fwd = E.make_dist_eval_forward(model)
    elif args.mc_dropout:
        fwd = _mc_mean_forward(args, model)
    elif args.ensembles:
        fwd = _ensemble_mean_forward(args, model)
    else:
        fwd = _default_eval_forward(args, model)
    proot = args.perturbation_data_path or args.data_path

    def video_loader(name: str):
        vids = D.load_cifar_p(proot, name)
        per = max(args.batch_size // max(vids.shape[1], 1), 1)
        for i in range(0, len(vids), per):
            yield vids[i:i + per]

    return R.evaluate_perturbation(fwd, video_loader, nb_classes, perturbations=R.PERTURBATIONS,
                                   frame_size=args.input_size, device=_device_of(model))


def run_eval_dispatch(args, model: VisionTransformer, val_loader, nb_classes: int) -> Dict:
    """--eval dispatch (run_class_finetuning.py:638-677, JAX :374-548): -C,
    -P, MC-dropout, the ensemble, the dist model's evaluation, the Laplace
    posterior, temperature scaling or the plain evaluation; prints and
    returns the results.

    On a mesh's data axis the plain evaluation, MC-dropout, the ensemble
    and the heads take this rank's shard of ``val_loader`` and their
    metrics the union of the ranks' logits (``evals.collect.DataShards``);
    the other dispatches (``WHOLE_SPLIT_DISPATCHES``) run the whole split on
    every rank as one process does (``models.layers.whole_batch``), so that
    their fits and per-sample draws are one process's."""
    _check_eval_flags(args)
    mesh = getattr(model, "mesh", None)
    if meshlib.active(mesh, meshlib.DATA_AXIS) and any(
            on(args) for on in WHOLE_SPLIT_DISPATCHES.values()):
        whole, _ = B.build_loaders(args, is_train=False, host=(0, 1))
        with whole_batch():
            return _dispatch(args, model, whole, nb_classes, None)
    return _dispatch(args, model, val_loader, nb_classes, DataShards.of(mesh, val_loader))


def _dispatch(args, model: VisionTransformer, val_loader, nb_classes: int,
              shards: Optional[DataShards]) -> Dict:
    device = _device_of(model)
    batches = lambda: _eval_batches(val_loader, args, device)  # noqa: E731
    results = {}
    if args.corrupted_data:
        results["corruption"] = _corruption_eval(args, model)
        print(json.dumps(results["corruption"], indent=2), flush=True)
        return results
    if args.perturbed_data:
        results["perturbation"] = _perturbation_eval(args, model, nb_classes)
        print(json.dumps(results["perturbation"], indent=2), flush=True)
        return results
    if args.mc_dropout:
        results["mc_dropout"] = E.evaluate_mc_dropout(
            _mc_eval_model(model), batches(), num_samples=args.mc_dropout_forwards,
            split_at=args.mc_dropout_split_at, shards=shards,
        )
    elif args.ensembles:
        results["ensembles"] = E.evaluate_ensemble(
            model, stack_params(_load_ensemble_members(args, model)), batches(), seed=args.seed,
            shards=shards)
    elif args.stochastic:
        results["dist_eval"] = E.evaluate_dist(model, batches(), shards=shards)
    elif args.laplace:
        la, ffwd, _ = _fit_laplace(args, model)
        results["laplace"] = LA.evaluate_laplace(la, ffwd, batches(), link=args.laplace_link,
                                                 seed=args.seed)
    elif args.temp_scaling:
        fit_batches = (_eval_batches(_fit_loader(args, model), args, device)
                       if args.temp_scaling_split == "train" else None)
        results["temp_scaling"] = CAL.evaluate_temperature_scaled(
            _default_eval_forward(args, model), batches(), fit_batches=fit_batches,
            heldout_frac=(args.temp_scaling_heldout_frac
                          if args.temp_scaling_split == "heldout" else None),
            heldout_seed=args.seed, device=device)
        print(f"temperature scaling: T* = {results['temp_scaling']['temperature']:.4f}",
              flush=True)
    else:
        results["eval"] = E.evaluate(model, batches(), het=args.het_layer, seed=args.seed,
                                     shards=shards)
    print(json.dumps(results, indent=2, default=float), flush=True)
    return results


def _check_seq_flags(args, shape: Optional[Tuple[int, int, int]] = None) -> None:
    """What the driver's mesh of ``shape`` (data, seq, model; by default
    (1, --seq_parallel, 1)) does not run raises before the ranks start: the
    Gumbel-drawing attention variants on any mesh (ROADMAP.md item 20's
    rest); under --seq_parallel the dist model and attention dropout where
    a forward draws, as the JAX package refuses them (cli/finetune.py:193-195,
    models/layers.py:353-358). A data axis refuses nothing of its own."""
    _, seq_size, _ = shape or (1, args.seq_parallel, 1)
    for flag, what in NOT_PORTED_UNDER_SEQ.items():
        if getattr(args, flag, False):
            raise B.not_ported(flag, f"{what} on the driver's mesh (--seq_parallel or a "
                               "launcher's ranks)", "item 20's rest")
    draws_attention = (not args.eval or args.mc_dropout) and args.attn_drop_rate > 0
    if seq_size > 1:
        if args.stochastic:
            raise ValueError("--seq_parallel is not wired for --stochastic")
        if draws_attention:
            raise ValueError("sequence-parallel attention requires attn_drop=0 (in-kernel "
                             "dropout seeds are not defined across re-sharded grids)")


def _start_metrics_readback(metrics: Dict[str, object]):
    """Queue the copy of a step's tensor metrics to the host behind the step
    (one stacked tensor); returns what ``_finish_metrics`` reads."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    values = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    return metrics, keys, _start_readback(values)


def _finish_metrics(pending) -> Dict[str, float]:
    """Wait for a step's metrics (only for that step, not the ones queued
    after it); float values in the step's key order."""
    metrics, keys, readback = pending
    values = dict(zip(keys, _finish(readback).tolist()))
    return {k: values[k] if k in values else float(v) for k, v in metrics.items()}


def train(args, device: torch.device, val_loader, nb_classes: int,
          mesh: Optional[meshlib.Mesh] = None):
    """The train loop (JAX cli/finetune.py:580-790): epochs of augmented
    steps from the train split, each followed by an evaluation, log.txt and
    checkpoints. Returns the train state. On the driver's ``mesh`` each data
    rank reads its shard of the train split (padded: every rank takes the
    same steps) and the ranks of its seq axis the same batches; every draw
    is the global batch's, this rank's rows kept, so the run is one
    process's with a batch of data · --batch_size. Rank 0 alone writes the
    files, and every rank's parameters are held equal after each epoch.
    Under --stochastic the batches are triplets and the step the dist
    model's."""
    model, cfg = build_model(args, nb_classes, device, mesh)
    writes = mesh is None or mesh.rank == 0
    triplet = args.stochastic
    train_loader, _ = B.build_loaders(args, is_train=True, triplet=triplet,
                                      letterbox_ok=not triplet, mesh=mesh)
    steps_per_epoch = args.steps_per_epoch or len(train_loader)
    lr_schedule, wd_schedule, _ = B.build_lr_schedules(args, steps_per_epoch)
    missing = load_variables(args, model)
    optimizer = B.build_optimizer(args, model, cfg.depth)
    if args.linear_classifier and args.finetune:
        # linear-probe freezing (run_class_finetuning.py:529-538): train only
        # what the checkpoint did not provide (the fresh head)
        trainable = missing or ["head"]
        print(f"linear probe: trainable params = {trainable}", flush=True)
        freeze_all_except(optimizer, trainable)
    # the EMA starts from the imported weights, as the reference creates its
    # ModelEma after the checkpoint surgery (run_class_finetuning.py:545-553)
    state = init_finetune_state(model, optimizer, use_model_ema=args.model_ema)
    aug_fn = make_finetune_train_augment(
        args.input_size, mesh=mesh, color_jitter_strength=args.color_jitter, reprob=args.reprob,
        imagenet_default_mean_and_std=args.imagenet_default_mean_and_std,
        interpolation=B.interp_method(args.train_interpolation), re_mode=args.remode,
        re_count=args.recount, **_aa_kwargs(args))
    # the AdaHessian pass (JAX :632, 655) and the Gumbel stream of the steps
    use_hessian, gumbel = needs_hessian(args.opt), draws_gumbel(cfg)
    mix = dict(num_classes=nb_classes, mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
               mixup_prob=args.mixup_prob, mixup_switch_prob=args.mixup_switch_prob,
               label_smoothing=args.smoothing, mixup_active=B.mixup_active(args),
               mixup_mode=args.mixup_mode,
               cutmix_minmax=tuple(args.cutmix_minmax) if args.cutmix_minmax else None,
               update_freq=max(1, args.update_freq))
    if triplet:
        # the anchor's train transform and the pos / neg eval transform run
        # inside the step, on the device (JAX :612-631)
        hp = DistFinetuneHParams(**mix, lambda_finetuning=args.lambda_finetuning,
                                 lambda_pvn=args.lambda_pvn)
        train_step = make_dist_finetune_train_step(
            model, optimizer, hp, lr_schedule, wd_schedule, aug_fn=aug_fn,
            prep_fn=lambda x: _eval_prep(x, args, device), use_hessian=use_hessian)
        eval_forward = E.make_dist_eval_forward(model)
    else:
        hp = FinetuneHParams(**mix, masked_position_prob=args.masked_position_prob,
                             model_ema_decay=args.model_ema_decay, head_type=cfg.head_type)
        train_step = make_finetune_train_step(model, optimizer, hp, lr_schedule, wd_schedule,
                                              aug_fn=aug_fn, use_hessian=use_hessian)
        eval_forward = E.make_eval_forward(model, het=args.het_layer)

    start_epoch = args.start_epoch
    if args.auto_resume and not args.resume:
        # the reference's auto_load moves start_epoch only when it found a
        # checkpoint (utils.py:487-545); --start_epoch wins otherwise
        state, resumed_epoch = C.auto_load(args.output_dir, state)
        start_epoch = max(start_epoch, resumed_epoch)
    elif args.resume:
        _require_pth(args.resume, "--resume")
        C.restore_checkpoint(args.resume, state)
    if start_epoch and state.step == 0:
        # a fresh start at a later epoch: the schedules go on from the
        # reference's it = epoch * steps_per_epoch
        state.step = start_epoch * steps_per_epoch

    save_ckpt = args.save_ckpt and args.output_dir and writes
    tb = TensorboardLogger(args.log_dir or args.output_dir if writes else None)
    jsonl = JsonlLogger(args.output_dir) if writes else None
    best_acc = -1.0

    for epoch in range(start_epoch, args.epochs):
        train_loader.set_epoch(epoch)
        if cfg.head_type == "sngp" and cfg.sngp_momentum <= 0:
            # exact accumulation: the precision matrix restarts each epoch
            # (SNGP.reset_cov, modeling_finetune.py:596-616; JAX :686-698)
            sngp_reset_cov(model, cfg.sngp_ridge_penalty)
        logger = MetricLogger()
        # the host reads step i's metrics back after it has queued steps
        # i + 1 and i + 2 (the JAX driver's 2-deep window): the card is not
        # left idle behind a readback, and a NaN stops the run within two
        # steps (engine_for_finetuning.py:101-103), reported at its global
        # step
        pending: "collections.deque" = collections.deque()
        step_base = state.step

        def drain_one():
            m, global_step = pending.popleft()
            m = _finish_metrics(m)
            B.check_finite_or_die(m["loss"], global_step)
            logger.update(**m)
            tb.update(head="loss", loss=m["loss"])
            tb.set_step()

        for step, batch in enumerate(logger.log_every(device_prefetch(train_loader, device), 10,
                                                      f"Epoch: [{epoch}]")):
            if step >= steps_per_epoch:
                break
            gens = step_generators(args.seed, state.step, device, het=cfg.head_type == "het",
                                   gumbel=gumbel, hessian=use_hessian)
            extra = optional_streams(gens)  # the Gumbel and Hessian streams, where drawn
            if triplet:
                images_u8, pos_u8, neg_u8, labels = batch
                metrics = train_step(state, images_u8, pos_u8, neg_u8, labels, gens.model,
                                     gens.mix, gens.augment, **extra)
            else:
                images_u8, labels = batch[0], batch[-1]
                # letterboxed batches carry each image's valid extent
                # (--decode_letterbox), so that the crop covers the whole image
                valid_hw = batch[1] if len(batch) == 3 else None
                metrics = train_step(state, images_u8, labels, gens.model, gens.mix,
                                     gens.augment, valid_hw, gens.mc, **extra)
            pending.append((_start_metrics_readback(metrics), step_base + step))
            while len(pending) > 2:
                drain_one()
        while pending:
            drain_one()

        if mesh is not None:
            seq.check_equal_on_ranks(model.parameters(), mesh.world_group, "the parameters")
        test = None
        if args.disable_eval_during_finetuning:
            pass
        elif triplet:
            test = E.evaluate_dist(model, _eval_batches(val_loader, args, device),
                                   forward=eval_forward, shards=DataShards.of(mesh, val_loader))
        else:
            test = E.evaluate(model, _eval_batches(val_loader, args, device), forward=eval_forward,
                              het=args.het_layer, seed=args.seed + epoch,
                              shards=DataShards.of(mesh, val_loader))
        record = {"epoch": epoch, **{f"train_{k}": v for k, v in logger.epoch_summary().items()}}
        if test is not None:
            print(f"epoch {epoch}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in sorted(test.items())), flush=True)
            if test["acc1"] > best_acc:
                best_acc = test["acc1"]
                if save_ckpt:
                    C.save_checkpoint(args.output_dir, "best", state, epoch)
            record.update({f"test_{k}": v for k, v in test.items()})
            record["best_acc1"] = best_acc
        if jsonl is not None:
            jsonl.write(record)
        if save_ckpt and ((epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs):
            C.save_checkpoint(args.output_dir, epoch, state, epoch)
        tb.flush()
    print(f"done. best acc1 {best_acc:.3f}", flush=True)
    return state


def _check_dist_flags(args) -> None:
    """--stochastic: each set flag of ``DIST_UNREAD`` raises ValueError; a
    dist_* --model without the flag raises too (it names the dist
    architecture, which the flag selects)."""
    if not args.stochastic:
        if args.model in DIST_MODELS:
            raise ValueError(f"--model {args.model} is the dist (mean+covariance) model: "
                             "pass --stochastic")
        return
    B.refuse_unread(args, DIST_UNREAD)


def _run(args, device: torch.device, mesh: Optional[meshlib.Mesh] = None):
    """The driver's body on one process (one rank of the driver's ``mesh``)."""
    print(f"device: {device}", flush=True)
    val_loader, nb_classes = B.build_loaders(args, is_train=False, mesh=mesh)
    nb_classes = args.nb_classes or nb_classes
    if args.visualize_embedding:
        # the reference's dispatch: dump the embeddings and exit (:634-637)
        model, _ = build_model(args, nb_classes, device, mesh)
        load_variables(args, model)
        # every rank runs the forwards of the whole split (their
        # collectives); rank 0 alone writes
        if mesh is not None:
            val_loader, _ = B.build_loaders(args, is_train=False, host=(0, 1))
        with whole_batch():
            out = EMB.visualize_embedding(model, _eval_batches(val_loader, args, device),
                                          args.output_dir or ".",
                                          write=mesh is None or mesh.rank == 0)
        if out is not None:
            print(f"embeddings written to {out}", flush=True)
        return out
    if not args.eval:
        return train(args, device, val_loader, nb_classes, mesh)
    model, _ = build_model(args, nb_classes, device, mesh)
    load_variables(args, model)
    return run_eval_dispatch(args, model, val_loader, nb_classes)


def run_rank(mesh, args, device: str):
    """One rank of the driver's mesh (``parallel.seq.run_ranks`` calls it in
    each process it starts, ``main`` under a launcher): the driver's body on
    ``device`` with this rank's share of the tokens and of the batch.
    ``mesh`` is a ``parallel.mesh.Mesh``, or a ``parallel.seq.SeqGroup`` of
    the whole world (a mesh of one data index). Rank 0 prints and returns
    its result; the others print nothing and return None."""
    setup(bounded_scores_default=True)
    if isinstance(mesh, seq.SeqGroup):
        mesh = meshlib.Mesh((1, mesh.size, 1), mesh.rank, (None, mesh.group, None), mesh.group)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if mesh.rank == 0:
        return _run(args, device, mesh)
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        _run(args, device, mesh)
    return None


def _launched(args, device: torch.device):
    """The driver under a launcher (``parallel.distributed.probe_cluster``
    finds its world W): this process is one rank of a mesh of data = W /
    --seq_parallel, seq = --seq_parallel and model = 1, as JAX
    ``create_mesh(seq_parallel=S)`` lays out every device
    (uncertainty_vit_tpu/parallel/mesh.py:21-44; without --seq_parallel the
    JAX driver builds no mesh, ROADMAP.md §3). Each rank takes the card of
    its local rank; the backend is ``choose_backend``'s. Returns rank 0's
    result, None on the others."""
    cluster = dist_boot.probe_cluster()
    s = args.seq_parallel
    if cluster.world_size % s:
        raise ValueError(f"a launcher's world of {cluster.world_size} ranks does not split into "
                         f"--seq_parallel {s}")
    shape = (cluster.world_size // s, s, 1)
    _check_seq_flags(args, shape)
    if device.type == "cuda":
        device = torch.device("cuda", cluster.local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist_boot.init_distributed_mode(device=device.type)
    try:
        return run_rank(meshlib.Mesh.create(*shape), args, str(device))
    finally:
        torch.distributed.destroy_process_group()


def main(args, device=None, mesh: Optional[Tuple[int, int, int]] = None):
    """Run the driver on ``device`` (the card unless the caller asks for the
    CPU): with --eval the evaluation, returning its results dict; else the
    train loop, returning the train state.

    Under a launcher the process is one rank of the launcher's mesh
    (``_launched``). Without one, --seq_parallel S runs S ranks sharing
    ``device`` (a mesh of one data index), and ``mesh`` = (data, seq,
    model), with seq = --seq_parallel and model = 1, lays out data · seq
    gloo ranks sharing it (the tests and the card's smoke: a mesh of D data
    ranks is one process given a batch of D · --batch_size). Either returns
    rank 0's result."""
    # bounded-scores attention by default: finetuning starts from a trained
    # backbone (cli/common.py)
    setup(bounded_scores_default=True)
    B.validate_aug_args(args)
    if args.device != "cuda":
        raise NotImplementedError(
            f"--device {args.device}: the driver runs on the one card ('cuda'); the CPU is "
            "main(args, device='cpu'), for tests")
    _check_dist_flags(args)
    gumbel = B.attn_variant(args) in GUMBEL_VARIANTS
    for flag, what in NOT_PORTED_WITH_GUMBEL.items():
        if gumbel and getattr(args, flag):
            raise B.not_ported(flag, f"{what} of a model that draws Gumbel noise",
                               "item 20's rest")
    device = resolve_device(device)
    if mesh is None and dist_boot.probe_cluster().world_size > 1:
        return _launched(args, device)
    if mesh is None and args.seq_parallel > 1:
        mesh = (1, args.seq_parallel, 1)
    if mesh is None:
        return _run(args, device)
    mesh = tuple(mesh)
    if mesh[1] != args.seq_parallel or mesh[2] != 1:
        raise ValueError(f"a driver mesh of {mesh} for --seq_parallel {args.seq_parallel}: "
                         "its seq axis is --seq_parallel and its model axis 1")
    _check_seq_flags(args, mesh)
    size = mesh[0] * mesh[1] * mesh[2]
    return seq.run_ranks(run_rank, size, args, str(device), mesh=mesh)[0]


if __name__ == "__main__":
    main(get_args_parser().parse_args())
