"""The JAX package's train states for the orbax tests: every state its
drivers write, from a narrow model, saved with its own ``save_checkpoint``.

Each builder returns the state the JAX package would hold in memory. The
parameters are the JAX init's at a seed (the driver's ``model.init``
keys), then redrawn with numpy where a value left at its init would hide a
fault (a head of zeros, a rel-pos table of zeros). The optimizer states are
the JAX drivers' own chains (``cli.builders.build_optimizer`` /
``train.optim.make_optimizer``), so their tuple nesting is the real one.
"""

from __future__ import annotations

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from uncertainty_vit_tpu.cli import builders as JB
from uncertainty_vit_tpu.cli import finetune as JFT
from uncertainty_vit_tpu.core.config import ViTConfig as JConfig
from uncertainty_vit_tpu.models.cyclical import CyclicalViT as JCyclical
from uncertainty_vit_tpu.models.dist_vit import DistVisionTransformer as JDist
from uncertainty_vit_tpu.models.dvae import DiscreteVAE as JDiscreteVAE
from uncertainty_vit_tpu.models.mim import MIMViT as JMIM
from uncertainty_vit_tpu.train import optim as JO
from uncertainty_vit_tpu.train import schedules as JS
from uncertainty_vit_tpu.train.engine_cyclical import CyclicalState
from uncertainty_vit_tpu.train.engine_finetune import FinetuneState
from uncertainty_vit_tpu.train.engine_finetune_dist import DistFinetuneState
from uncertainty_vit_tpu.train.engine_mim import MIMState
from uncertainty_vit_tpu.utils import checkpoint as JC

# the pretraining and dist models' narrow config (one head of 32)
SMALL = dict(img_size=32, patch_size=16, embed_dim=32, depth=2, num_heads=2, init_values=0.1,
             use_shared_rel_pos_bias=True, use_abs_pos_emb=False, use_flash_attention=False)
DVAE = dict(image_size=8, num_tokens=64, codebook_dim=8, num_layers=2, hidden_dim=8)
VOCAB = 64
NUM_CLASSES = 10


def driver_argv(data_path: str, out: str, *extra: str) -> list:
    """The finetune drivers' flags for the narrow preset at 32 pixels, in f32."""
    return ["--model", "beit_test_patch16_32", "--input_size", "32", "--data_set", "CIFAR100",
            "--data_path", data_path, "--batch_size", "16", "--num_workers", "0",
            "--output_dir", out, "--dtype", "float32", "--drop_path", "0", *extra]


def redraw(params, seed: int):
    """The tree with every head kernel and rel-pos table drawn from numpy
    (std 0.5 and 0.2), so that the logits stand apart and the bias is not
    zero, and the spectral fc_norm's kernel at std 1/sqrt(width) (its
    largest singular value near 2, above the 0.95 bound, as ViT-B's is at
    its init std 0.02; at width 32 that std would leave it below); the other
    leaves as they were."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-1] == "relative_position_bias_table":
            return jnp.asarray(0.2 * rs.randn(*leaf.shape), leaf.dtype)
        if names[0] in ("head", "lm_head") and names[-1] == "kernel":
            return jnp.asarray(0.5 * rs.randn(*leaf.shape) / math.sqrt(leaf.shape[0]), leaf.dtype)
        if names == ["fc_norm_sn", "kernel"]:
            return jnp.asarray(rs.randn(*leaf.shape) / math.sqrt(leaf.shape[0]), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, params)


def finetune_model(argv):
    args = JFT.get_args_parser().parse_args(argv)
    model, _ = JFT.build_model(args, NUM_CLASSES)
    return args, model


def finetune_state(argv, seed: int = 0, ema_dtype=None, sngp_batches: int = 0):
    """A FinetuneState of the driver's model for ``argv`` (``--sngp``,
    ``--het_layer`` or a linear head), initialised as the driver's
    ``load_variables`` initialises it at ``seed``, its optimizer the
    driver's chain. ``ema_dtype`` keeps an EMA of the params in that dtype
    (bf16 leaves in the tree). ``sngp_batches`` forwards of seeded images
    with the SNGP statistics updating, as training moves them: the
    power-iteration vectors and the precision matrix then differ from a
    fresh init's."""
    args, model = finetune_model(argv)
    rngs = {"params": jax.random.PRNGKey(seed)}
    if args.het_layer:
        rngs["mc"] = jax.random.PRNGKey(seed + 1)
    variables = dict(jax.jit(model.init)(rngs, jnp.zeros((2, 32, 32, 3))))
    variables["params"] = redraw(variables["params"], seed + 7)
    rs = np.random.RandomState(seed + 11)
    update = jax.jit(lambda v, x: model.apply(
        v, x, deterministic=False, update_sngp_cov=True, mutable=["spectral_stats", "sngp_state"],
        rngs={"dropout": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)})[1])
    for _ in range(sngp_batches):
        images = jnp.asarray(rs.randn(8, 32, 32, 3).astype(np.float32))
        variables.update(update(variables, images))
    params = variables["params"]
    tx = JB.build_optimizer(args, params, JS.constant_schedule(1e-3), JS.constant_schedule(0.05),
                            model.cfg.depth)
    ema = None if ema_dtype is None else jax.tree_util.tree_map(lambda p: p.astype(ema_dtype),
                                                                params)
    return FinetuneState(params=params, opt_state=tx.init(params),
                         step=jnp.asarray(3, jnp.int32), model_ema=ema,
                         sngp_state=variables.get("sngp_state"),
                         spectral_stats=variables.get("spectral_stats"),
                         sngp_frozen=variables.get("sngp_frozen"))


def _tx(params):
    return JO.make_optimizer(params, JS.constant_schedule(1e-3))


def dist_state(seed: int = 0):
    model = JDist(cfg=JConfig(**SMALL, num_classes=NUM_CLASSES))
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((2, 32, 32, 3)))["params"]
    params = redraw(params, seed + 7)
    return DistFinetuneState(params=params, opt_state=_tx(params).init(params),
                             step=jnp.asarray(5, jnp.int32))


def cyclical_state(seed: int = 0):
    """A CyclicalState of the --gp_layer cyclical model (its SNGP lm_head's
    collections in the state), the teacher a step behind the student."""
    model = JCyclical(cfg=JConfig(**SMALL, head_type="none"), gp_layer=True)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((2, 32, 32, 3)),
                                    jnp.zeros((2, 4)))
    params = redraw(variables["params"], seed + 7)
    return CyclicalState(params=params, opt_state=_tx(params).init(params),
                         ema_params=jax.tree_util.tree_map(lambda p: p * 0.5, params),
                         step=jnp.asarray(2, jnp.int32), sngp_state=variables["sngp_state"],
                         sngp_frozen=variables["sngp_frozen"])


def mim_state(seed: int = 0):
    model = JMIM(cfg=JConfig(**SMALL, head_type="none"), vocab_size=VOCAB)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((2, 32, 32, 3)),
                                 jnp.zeros((2, 4)))["params"]
    return MIMState(params=redraw(params, seed + 7), opt_state=_tx(params).init(params),
                    step=jnp.asarray(4, jnp.int32))


@functools.lru_cache(maxsize=None)
def dvae_variables(seed: int = 0):
    """The dVAE's variables at ``seed`` (built once a seed: the weights and
    the per-epoch state share them)."""
    return jax.jit(JDiscreteVAE(**DVAE).init)(jax.random.PRNGKey(seed), jnp.zeros((2, 8, 8, 3)))


def dvae_epoch_state(seed: int = 0):
    """The dVAE trainer's per-epoch state (cli/train_dvae.py:193-196)."""
    variables = dvae_variables(seed)
    return {"variables": variables, "opt_state": _tx(variables["params"]).init(
        variables["params"]), "step": jnp.asarray(6, jnp.int32)}


def save(root: str, name: str, state) -> str:
    """``state`` under root/name/checkpoint-0 by the JAX package's writer."""
    return JC.save_checkpoint(os.path.join(root, name), 0, state)


def as_numpy(tree):
    """A JAX tree with numpy leaves (None kept)."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))
