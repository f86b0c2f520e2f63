"""Shared CLI plumbing: argparse groups, the model config and the loaders.

Counterpart of uncertainty_vit_tpu/cli/builders.py: the argument groups
(:25-213, ``add_mask_args`` :184-191) with every flag name of the JAX package (which keeps the
reference's names, run_class_finetuning.py:49-259), so that a recipe parses
unchanged; ``model_config_from_args`` (:216-254), ``build_lr_schedules`` and
``build_optimizer`` (:257-301), ``build_loaders`` (:304-361),
``interp_method``, ``mixup_active``, ``validate_aug_args``, ``compute_dtype``,
``build_discrete_vae`` (:414-458) and ``check_finite_or_die``.

A parsed flag whose feature the port does not have yet raises
``NotImplementedError`` where it is read, with the ROADMAP item that ports
it; none is ignored.
"""

from __future__ import annotations

import argparse
import ast
from typing import Optional, Tuple

import torch

from uncertainty_vit_tpu_torch.core.config import PRESETS, ViTConfig, get_preset
from uncertainty_vit_tpu_torch.data.pipeline import BatchLoader, host_shard
from uncertainty_vit_tpu_torch.data.registry import build_dataset
from uncertainty_vit_tpu_torch.train import schedules
from uncertainty_vit_tpu_torch.train.optim import Optimizer, make_optimizer


INIT_SCALE = 0.001  # --init_scale's default (run_class_finetuning.py:357)

# the model flags the dist (mean+covariance) model does not read: flag →
# whether it is set. The JAX drivers ignore each under --stochastic
# (ROADMAP.md §3); ``refuse_unread`` raises for them
DIST_UNREAD = {
    "quant": lambda a: a.quant != "none",
    "abs_pos_emb": lambda a: a.abs_pos_emb,
    "per_block_rel_pos_bias": lambda a: a.per_block_rel_pos_bias,
    "dropout_from_block": lambda a: a.dropout_from_block != 0,
    "sngp": lambda a: a.sngp,
    "het_layer": lambda a: a.het_layer,
    "sinkformer": lambda a: a.sinkformer,
    "gumbel_softmax": lambda a: a.gumbel_softmax,
    "h_sto_trans": lambda a: a.h_sto_trans,
}


def not_ported(flag: str, what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"--{flag}: {what} is not ported yet (ROADMAP.md {where})")


def refuse_unread(args, unread) -> None:
    """Under --stochastic: ValueError for the first set flag of ``unread``
    (flag → whether it is set), which the dist model does not read."""
    for flag, is_set in unread.items():
        if is_set(args):
            raise ValueError(f"--{flag} with --stochastic: the dist (mean+covariance) model "
                             "does not read it (the JAX driver ignores it there)")


def add_model_args(p: argparse.ArgumentParser, extra_models: Tuple[str, ...] = ()):
    """The model flags; ``extra_models``: registry names (``models.registry.
    MODEL_NAMES``) --model also takes, each the architecture of its preset
    (``registry.preset_name``)."""
    g = p.add_argument_group("model")
    g.add_argument("--model", default="beit_base_patch16_224",
                   choices=sorted(PRESETS) + list(extra_models))
    g.add_argument("--input_size", default=224, type=int)
    g.add_argument("--drop", type=float, default=0.0)
    g.add_argument("--attn_drop_rate", type=float, default=0.0)
    g.add_argument("--dropout_from_block", type=int, default=0,
                   help="first block index where --drop/--attn_drop_rate are "
                        "active (blocks below carry no dropout); with "
                        "--mc_dropout_split_at == this value, split-trunk "
                        "MC-dropout is exact")
    g.add_argument("--drop_path", type=float, default=0.1)
    g.add_argument("--layer_scale_init_value", default=0.1, type=float)
    # boolean literals (True/False) so every combination is expressible
    # (the reference's store_true/store_false pairs). REFERENCE SEMANTICS:
    # --rel_pos_bias toggles the SHARED table (run_class_finetuning.py:359 /
    # run_cyclical.py:294 pass it as use_shared_rel_pos_bias and hard-code
    # per-block use_rel_pos_bias=False), default True; --abs_pos_emb
    # defaults False (run_cyclical.py:54-55). Per-block tables are exposed
    # as an extension under their own name.
    g.add_argument("--rel_pos_bias", default=True, type=ast.literal_eval,
                   help="shared rel-pos-bias table (reference --rel_pos_bias)")
    g.add_argument("--per_block_rel_pos_bias", default=False, type=ast.literal_eval,
                   help="per-block rel-pos tables (the reference hard-codes "
                        "this False; extension)")
    g.add_argument("--disable_rel_pos_bias", action="store_false",
                   dest="rel_pos_bias",
                   help="reference-style negative of --rel_pos_bias")
    g.add_argument("--abs_pos_emb", default=False, type=ast.literal_eval)
    g.add_argument("--init_scale", type=float, default=INIT_SCALE,
                   help="head init multiplier (run_class_finetuning.py:357)")
    g.add_argument("--use_mean_pooling", default=True, type=ast.literal_eval)
    g.add_argument("--use_cls", action="store_true",
                   help="cls-token head instead of mean pooling "
                        "(run_class_finetuning.py:157-159)")
    g.add_argument("--sinkformer", action="store_true")
    g.add_argument("--gumbel_softmax", action="store_true")
    g.add_argument("--h_sto_trans", action="store_true")
    g.add_argument("--sngp", action="store_true")
    g.add_argument("--gp_layer", action="store_true")
    g.add_argument("--sngp_cov_momentum", type=float, default=0.999,
                   help="GP precision-matrix momentum (modeling_finetune.py:536); "
                        "<= 0 switches to exact accumulation with a per-epoch "
                        "reset (reset_cov, modeling_finetune.py:596-616)")
    g.add_argument("--het_layer", action="store_true")
    g.add_argument("--stochastic", action="store_true",
                   help="use the dist (mean+covariance) model family (the finetune and "
                        "cyclical drivers)")
    g.add_argument("--learn_layer_weights", action="store_true")
    g.add_argument("--layernorm_before_combine", action="store_true")
    g.add_argument("--linear_classifier", action="store_true")
    g.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    g.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8 trunk matmuls (qkv/proj/fc1/fc2, fwd+dgrad+"
                        "wgrad on the int8 tensor cores; ops/quant.py, "
                        "kernels K6 and K7), in place of the reference's "
                        "DeepSpeed fp16 speed mode")
    return g


def add_opt_args(p: argparse.ArgumentParser, lr: float = 2e-3):
    g = p.add_argument_group("optimization")
    g.add_argument("--opt", default="adamw")
    g.add_argument("--lr", type=float, default=lr)
    g.add_argument("--min_lr", type=float, default=1e-5)
    g.add_argument("--warmup_lr", type=float, default=0.0)
    g.add_argument("--warmup_epochs", type=int, default=5)
    g.add_argument("--warmup_steps", type=int, default=-1)
    g.add_argument("--weight_decay", type=float, default=0.05)
    g.add_argument("--weight_decay_end", type=float, default=None)
    g.add_argument("--clip_grad", type=float, default=None)
    g.add_argument("--layer_decay", type=float, default=1.0)
    g.add_argument("--opt_betas", type=float, nargs=2, default=(0.9, 0.999))
    g.add_argument("--opt_eps", type=float, default=1e-8)
    g.add_argument("--momentum", type=float, default=0.9)
    g.add_argument("--update_freq", type=int, default=1)
    g.add_argument("--tri_phase_schedule", type=str, default=None,
                   help="'(warmup_perc, decay_perc)' literal, e.g. '(0.05,0.15)'")
    g.add_argument("--disable_weight_decay_on_rel_pos_bias", action="store_true",
                   help="add rel-pos tables to the no-decay set "
                        "(run_class_finetuning.py:578-581)")
    return g


def add_data_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("data")
    g.add_argument("--data_path", default="/datasets/imagenet", type=str)
    g.add_argument("--data_set", default="IMNET", type=str)
    g.add_argument("--batch_size", type=int, default=64)
    g.add_argument("--epochs", type=int, default=100)
    g.add_argument("--num_workers", type=int, default=8)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--imagenet_default_mean_and_std", default=True, type=ast.literal_eval)
    g.add_argument("--color_jitter", type=float, default=0.4)
    # RandAugment ON by default, matching run_class_finetuning.py:117
    g.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1",
                   help="'rand-m9-mstd0.5-inc1'-style RandAugment policy "
                        "(on-device; disables color jitter like timm); "
                        "pass 'None' to turn off")
    g.add_argument("--aug_level", type=int, default=-1)
    g.add_argument("--reprob", type=float, default=0.25)
    g.add_argument("--crop_pct", type=float, default=None)
    g.add_argument("--decode_size", type=int, default=None,
                   help="host decode canvas size (defaults to input_size*8/7)")
    g.add_argument("--decode_letterbox", default=False, type=ast.literal_eval,
                   help="aspect-preserving decode with per-sample valid "
                        "extents: the device RandomResizedCrop then samples "
                        "the FULL image like torchvision's (the default "
                        "square canvas center-crops the long side first)")
    g.add_argument("--semi_supervised_ratio", type=float, default=0.0)
    g.add_argument("--data_set_filter_file", type=str, default=None)
    g.add_argument("--eval_data_path", type=str, default=None,
                   help="separate root for the eval split (defaults to "
                        "--data_path)")
    g.add_argument("--train_interpolation", type=str, default="bicubic",
                   choices=["bicubic", "bilinear", "random", "lanczos"],
                   help="RRC resampler; 'random'/'lanczos' map to bicubic "
                        "on device (documented approximation)")
    g.add_argument("--second_interpolation", type=str, default="lanczos",
                   choices=["bicubic", "bilinear", "lanczos"],
                   help="tokenizer-view resampler (datasets.py:75); lanczos "
                        "maps to bicubic on device")
    g.add_argument("--mixup_mode", type=str, default="batch",
                   choices=["batch", "elem", "pair"],
                   help="timm Mixup mode: one draw per batch, per sample, "
                        "or per mirrored pair (run_class_finetuning.py:344)")
    g.add_argument("--cutmix_minmax", type=float, nargs="+", default=None,
                   help="cutmix box min/max size ratio; overrides the "
                        "lambda-based box and forces cutmix_alpha=1.0 "
                        "(timm rand_bbox_minmax semantics)")
    g.add_argument("--remode", type=str, default="pixel",
                   choices=["pixel", "const"],
                   help="random-erasing fill: per-pixel noise or zeros")
    g.add_argument("--recount", type=int, default=1,
                   help="number of random-erasing rectangles")
    g.add_argument("--resplit", action="store_true",
                   help="accepted no-op: the reference parses this flag "
                        "(run_class_finetuning.py:134) but never wires it "
                        "into build_transform, so it is dead there too")
    # accepted for reference-script copy-paste compatibility, and no-ops as
    # in the JAX package: the loaders pin their copies. The driver runs on
    # the card, so --device takes the reference's "cuda" only (another value
    # raises in main(); the CPU is main()'s device argument, for tests)
    noop = p.add_argument_group("reference-compat (no-op)")
    noop.add_argument("--device", default="cuda",
                      help="the reference's device; only 'cuda' (the one card) is accepted")
    noop.add_argument("--world_size", type=int, default=1)
    noop.add_argument("--dist_url", default="env://")
    noop.add_argument("--local_rank", type=int, default=0)
    noop.add_argument("--dist_on_itp", action="store_true")
    noop.add_argument("--pin_mem", action="store_true")
    noop.add_argument("--no_pin_mem", action="store_false", dest="pin_mem")
    noop.add_argument("--dist_eval", action="store_true",
                      help="eval is already sharded by the host loader")
    noop.add_argument("--enable_deepspeed", action="store_true",
                      help="bf16 compute on f32 params replaces DeepSpeed "
                           "fp16 (no loss scaling)")
    noop.add_argument("--model_ema_force_cpu", action="store_true",
                      help="the EMA lives beside the model")
    return g


def add_mask_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("masking")
    g.add_argument("--num_mask_patches", type=int, default=120)
    g.add_argument("--min_mask_patches_per_block", type=int, default=16)
    g.add_argument("--max_mask_patches_per_block", type=int, default=None)
    g.add_argument("--mask_dropout_prob", type=float, default=-1.0)
    return g


def add_io_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("io")
    g.add_argument("--output_dir", default="./output", type=str)
    g.add_argument("--log_dir", default=None, type=str)
    g.add_argument("--save_ckpt_freq", type=int, default=20)
    g.add_argument("--auto_resume", default=True, type=ast.literal_eval)
    g.add_argument("--no_auto_resume", action="store_false", dest="auto_resume")
    g.add_argument("--start_epoch", type=int, default=0)
    g.add_argument("--save_ckpt", default=True, type=ast.literal_eval)
    g.add_argument("--no_save_ckpt", action="store_false", dest="save_ckpt")
    g.add_argument("--model_key", default="model|module",
                   help="checkpoint container keys (the importer probes "
                        "these automatically; flag kept for recipe parity)")
    g.add_argument("--model_prefix", default="",
                   help="strip this prefix from checkpoint keys on import")
    g.add_argument("--resume", default="", type=str)
    g.add_argument("--finetune", default="", type=str,
                   help="torch .pth to initialize from (the port reads "
                        ".pth only)")
    g.add_argument("--steps_per_epoch", type=int, default=None,
                   help="override for smoke runs")
    return g


def attn_variant(args) -> str:
    """The attention variant of the parsed flags (JAX :223-229):
    --sinkformer, else --gumbel_softmax, else --h_sto_trans (dual_sto),
    else softmax."""
    if args.sinkformer:
        return "sinkformer"
    if args.gumbel_softmax:
        return "gumbel"
    if args.h_sto_trans:
        return "dual_sto"
    return "softmax"


def model_config_from_args(args, num_classes: int) -> ViTConfig:
    """The ViTConfig of the parsed flags. The head (JAX :216-249):
    --het_layer the heteroscedastic head; --gp_layer or --sngp the SNGP head
    (the reference's intended head, which its linear head overwrites),
    --sngp also with the spectral-norm fc_norm; --sngp_cov_momentum the
    precision matrix's momentum; the attention variant ``attn_variant``."""
    head_type = "linear"
    if args.het_layer:
        head_type = "het"
    elif args.gp_layer or args.sngp:
        head_type = "sngp"
    from uncertainty_vit_tpu_torch.models.registry import preset_name

    return get_preset(
        preset_name(args.model),
        img_size=args.input_size,
        num_classes=num_classes,
        drop_rate=args.drop,
        attn_drop_rate=args.attn_drop_rate,
        dropout_from_block=args.dropout_from_block,
        drop_path_rate=args.drop_path,
        init_values=args.layer_scale_init_value or None,
        # 1:1 flag mapping, no coupling: the reference allows abs_pos_emb and
        # rel-pos bias simultaneously (run_class_finetuning.py:358-360)
        use_abs_pos_emb=args.abs_pos_emb,
        use_rel_pos_bias=args.per_block_rel_pos_bias,
        use_shared_rel_pos_bias=args.rel_pos_bias,
        quant=getattr(args, "quant", "none"),
        attn_variant=attn_variant(args),
        head_type=head_type,
        sngp_fc_norm=args.sngp,
        sngp_momentum=getattr(args, "sngp_cov_momentum", 0.999),
        use_mean_pooling=args.use_mean_pooling and not args.use_cls,
        init_scale=args.init_scale,
        learn_layer_weights=args.learn_layer_weights,
        layernorm_before_combine=args.layernorm_before_combine,
        linear_classifier=args.linear_classifier,
    )


def build_lr_schedules(args, steps_per_epoch: int
                       ) -> Tuple[schedules.Schedule, Optional[schedules.Schedule], int]:
    """(lr schedule, weight-decay schedule or None, total updates). The
    schedules count optimizer updates, not mini-batches, as the reference
    steps its schedule arrays per update (run_class_finetuning.py:556-562):
    --warmup_steps, else --warmup_epochs of updates; --tri_phase_schedule
    '(warmup_perc, decay_perc)' in place of the cosine; a cosine weight
    decay to --weight_decay_end when that differs from --weight_decay."""
    update_freq = max(1, getattr(args, "update_freq", 1))
    total = args.epochs * steps_per_epoch // update_freq
    warmup = (args.warmup_steps if args.warmup_steps > 0
              else args.warmup_epochs * steps_per_epoch // update_freq)
    if args.tri_phase_schedule:
        w, d = ast.literal_eval(args.tri_phase_schedule)
        lr = schedules.tri_phase_schedule(args.lr, args.min_lr, total, w, d,
                                          start_warmup_value=args.warmup_lr)
    else:
        lr = schedules.cosine_schedule(args.lr, args.min_lr, total, warmup,
                                       start_warmup_value=args.warmup_lr)
    wd_end = args.weight_decay_end
    wd = None
    if wd_end is not None and wd_end != args.weight_decay:
        wd = schedules.cosine_schedule(args.weight_decay, wd_end, total, 0)
    return lr, wd, total


def build_optimizer(args, model: torch.nn.Module, depth: int) -> Optimizer:
    """The --opt optimizer (``train.optim.make_optimizer``: every name of
    the JAX make_optimizer, ``fused*`` and ``lookahead_*`` too) over the
    model's parameters with the flags' weight decay (not on pos_embed,
    cls_token, ≤ 1-D parameters, nor, with
    --disable_weight_decay_on_rel_pos_bias, the rel-pos tables), clip,
    betas, eps, --momentum, --layer_decay (below 1: per-layer lr scales)
    and --update_freq (the mini-steps accumulated per update). An unknown
    name raises ValueError."""
    skip = ["pos_embed", "cls_token"]
    if getattr(args, "disable_weight_decay_on_rel_pos_bias", False):
        skip.append("relative_position_bias_table")
    return make_optimizer(
        model, opt_name=args.opt, skip_names=tuple(skip), weight_decay=args.weight_decay,
        clip_grad=args.clip_grad, betas=tuple(args.opt_betas), eps=args.opt_eps,
        layer_decay=args.layer_decay if args.layer_decay < 1.0 else None, depth=depth,
        update_freq=max(1, args.update_freq), momentum=args.momentum,
    )


def build_loaders(
    args, is_train: bool, triplet: bool = False, letterbox_ok: bool = False,
    pad_shards: bool | None = None, shuffle: bool | None = None,
    drop_last: bool | None = None, host: Optional[Tuple[int, int]] = None, mesh=None,
) -> Tuple[BatchLoader, int]:
    """(loader, class count) of a split. letterbox_ok: only callers whose
    augmentation consumes the per-sample valid extents may enable
    --decode_letterbox; everywhere else the letterboxed canvas would be
    treated as fully valid, so the flag raises there. Each process loads
    its shard: ``host`` = (host_id, num_hosts), by default
    ``host_shard(mesh)``'s: on a ``parallel.mesh.Mesh`` the data index and
    the data axis's size (the seq ranks of one data index split the tokens
    of the same batches); a caller that wants the whole split on every rank
    passes (0, 1).

    Where the shards span data ranks (num_hosts > 1), shards that would be
    unpadded are padded, with the JAX package's message and its rule
    (JAX cli/builders.py:336-352, which forces an explicit
    ``pad_shards=False`` under --seq_parallel across processes): every data
    rank then takes the same number of batches of the same sizes, so that
    a batch of the global batch is the ranks' batches together and the
    collectives over the data axis stay in lockstep. The port applies it to
    every unpadded loader on a data axis, the evaluation's too (whose
    padded duplicates ``evals.collect.DataShards`` leaves out of the
    metrics)."""
    letterbox_requested = getattr(args, "decode_letterbox", False)
    if letterbox_requested and is_train and not letterbox_ok:
        raise ValueError(
            "--decode_letterbox is only supported by the (non-triplet) "
            "finetune trainer, whose augmentation consumes the per-sample "
            "valid extents; this entry point would silently sample the "
            "zero-filled canvas margins"
        )
    decode = args.decode_size or (args.input_size * 8 // 7 if args.input_size > 64 else None)
    data_path = args.data_path
    if not is_train and getattr(args, "eval_data_path", None):
        data_path = args.eval_data_path
    dataset, nb_classes = build_dataset(
        is_train, args.data_set, data_path,
        semi_supervised_ratio=getattr(args, "semi_supervised_ratio", 0.0) if is_train else 0.0,
        triplet=triplet,
        decode_size=decode,
        letterbox=is_train and letterbox_ok and letterbox_requested,
        data_set_filter_file=getattr(args, "data_set_filter_file", None) if is_train else None,
        seed=args.seed,
    )
    host_id, num_hosts = host or host_shard(mesh)
    shuffle = is_train if shuffle is None else shuffle
    drop_last = is_train if drop_last is None else drop_last
    if num_hosts > 1 and not (shuffle or drop_last if pad_shards is None else pad_shards):
        print("build_loaders: forcing pad_shards=True — unpadded shards would break "
              "multi-host lockstep under --seq_parallel", flush=True)
        pad_shards = True
    loader = BatchLoader(
        dataset, args.batch_size,
        shuffle=shuffle, seed=args.seed, drop_last=drop_last,
        num_workers=args.num_workers,
        host_id=host_id, num_hosts=num_hosts,
        pad_shards=pad_shards,
    )
    return loader, nb_classes


def interp_method(name: str) -> str:
    """Map reference interpolation names onto the device resampler's
    supported kernels (bicubic/bilinear); 'random' and 'lanczos' use bicubic
    (documented approximation — the 4-tap cubic is the closest kernel)."""
    return "bilinear" if name == "bilinear" else "bicubic"


def mixup_active(args) -> bool:
    """timm/reference activation gate (run_class_finetuning.py:340):
    cutmix_minmax ALONE activates mixing — timm forces cutmix_alpha=1.0
    when the minmax mode is set, so alphas of 0 don't disable it."""
    return (
        args.mixup > 0
        or args.cutmix > 0
        or getattr(args, "cutmix_minmax", None) is not None
    )


def validate_aug_args(args) -> None:
    """Explicit errors for accepted-but-unimplemented reference knobs."""
    if getattr(args, "mixup_mode", "batch") not in ("batch", "elem", "pair"):
        raise ValueError("--mixup_mode must be one of batch/elem/pair")
    minmax = getattr(args, "cutmix_minmax", None)
    if minmax and len(minmax) != 2:
        raise ValueError("--cutmix_minmax takes exactly two floats (min max)")
    if minmax and not 0.0 <= minmax[0] < minmax[1] <= 1.0:
        # timm's np.random.randint(lo, hi) raises for lo >= hi; a silent
        # clamp here would train with a constant-size cut instead
        raise ValueError(
            "--cutmix_minmax must satisfy 0 <= min < max <= 1, got "
            f"{tuple(minmax)}"
        )
    if getattr(args, "resplit", False):
        # Dead flag in the reference itself: parsed at
        # run_class_finetuning.py:134 but never passed to build_transform /
        # create_transform, so setting it changes nothing there. Matching
        # behavior: accept and ignore (warn for visibility).
        import warnings

        warnings.warn(
            "--resplit is a no-op (dead flag in the reference too: parsed "
            "but never wired into the transform pipeline)",
            stacklevel=2,
        )


def compute_dtype(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def build_discrete_vae(args, generator: Optional[torch.Generator] = None, device=None
                       ) -> torch.nn.Module:
    """The pretrainers' frozen tokenizer, the reference's create_d_vae
    dispatch (utils.py:548-573), on ``device``, its parameters drawn from
    ``generator`` (a generator on that device) unless a file fills them.

    "dall-e": ``DalleVAE(second_input_size, vocab_size)``, filled from
    ``encoder.pkl`` and ``decoder.pkl`` in the --discrete_vae_weight_path
    directory (``utils.checkpoint.load_dalle_pickle_state_dict``); a
    parameter they leave uncovered raises. "customized" / "none": the in-repo
    ``DiscreteVAE`` (codebook 512, --dvae_num_layers, --dvae_hidden_dim),
    filled from --discrete_vae_weight_path strictly: the dVAE trainer's
    ``checkpoint-dvae-weights.pth``, a reference DiscreteVAE state dict (the
    same keys), or an orbax directory of the JAX package's dVAE trainer, its
    ``checkpoint-dvae-weights`` (the variables, as JAX cli/builders.py:457
    restores them) or a per-epoch ``checkpoint-N`` (its variables; the JAX
    restore refuses that layout, ROADMAP.md §3), read by
    ``utils.checkpoint.read_weights``. The tokenizer is frozen and in eval
    mode."""
    import os

    from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
    from uncertainty_vit_tpu_torch.models.dalle_vae import DalleVAE
    from uncertainty_vit_tpu_torch.models.dvae import DiscreteVAE
    from uncertainty_vit_tpu_torch.utils import checkpoint as C

    device = resolve_device(device)
    path = args.discrete_vae_weight_path
    if args.discrete_vae_type == "dall-e":
        vae = DalleVAE(image_size=args.second_input_size, vocab_size=args.vocab_size,
                       device=device, generator=generator)
        if path:
            for part in ("encoder", "decoder"):
                sd = C.load_dalle_pickle_state_dict(os.path.join(path, f"{part}.pkl"))
                getattr(vae, part).load_state_dict(sd, strict=True)
    else:
        vae = DiscreteVAE(image_size=args.second_input_size, num_tokens=args.vocab_size,
                          num_layers=args.dvae_num_layers, hidden_dim=args.dvae_hidden_dim,
                          device=device, generator=generator)
        if path:
            vae.load_state_dict(C.read_weights(path), strict=True)
    return vae.eval().requires_grad_(False)


def check_finite_or_die(loss_value: float, step) -> None:
    """NaN/Inf abort (engine_for_cyclical.py:166-168)."""
    import math
    import sys

    if not math.isfinite(loss_value):
        print(f"Loss is {loss_value} at step {step}, stopping training", flush=True)
        sys.exit(1)
