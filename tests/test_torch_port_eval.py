"""PyTorch port: metrics, logit collection, evaluate() and the package's
boundaries, against the JAX package.

Metrics are compared on seeded numpy logits at rtol 1e-5 / atol 1e-6 (both
f32; the port sums the bins in another order). evaluate() runs a 2-layer
ViT end to end on both sides (the JAX attention kernel in interpret mode)
at the model tolerance of tests/test_torch_parity.py:30.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import uncertainty_vit_tpu.ops.flash_attention as FA
from uncertainty_vit_tpu.core.config import ViTConfig
from uncertainty_vit_tpu.evals import classification as JE
from uncertainty_vit_tpu.evals import metrics as JM
from uncertainty_vit_tpu.models.vit import VisionTransformer as JViT
from uncertainty_vit_tpu.ops import augment as JA
from uncertainty_vit_tpu_torch.core.config import ViTConfig as TViTConfig
from uncertainty_vit_tpu_torch.evals import metrics as TM
from uncertainty_vit_tpu_torch.evals.classification import evaluate, make_eval_forward
from uncertainty_vit_tpu_torch.evals.collect import collect_logits
from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
from uncertainty_vit_tpu_torch.ops import augment as TA
from uncertainty_vit_tpu_torch.utils.checkpoint import load_flax_params

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def interpret_mode():
    prev = FA.INTERPRET
    FA.INTERPRET = True
    yield
    FA.INTERPRET = prev


def _logits(case):
    rs = np.random.RandomState({"512x10": 0, "512x100": 1, "ties": 2}[case])
    if case == "ties":
        # each row uniform over a random support (logit 0, else −30): the
        # probabilities 1/k tie within and across samples (AUROC average
        # ranks, adaptive-bin boundaries, top-k and argmax tie order). Two
        # levels keep every tie exact in both frameworks' f32 softmax, whose
        # sums otherwise differ by an ulp and move samples across a bin
        # boundary placed on a tied value.
        support = rs.rand(512, 10) < 0.4
        support[np.arange(512), rs.randint(0, 10, 512)] = True
        logits = np.where(support, 0.0, -30.0).astype(np.float32)
        labels = rs.randint(0, 10, 512)
    else:
        k = int(case.split("x")[1])
        labels = rs.randint(0, k, 512)
        logits = (rs.randn(512, k) * 2.0).astype(np.float32)
        logits[np.arange(512), labels] += 2.0  # some signal, so acc/AUROC are not at chance
    return logits, labels.astype(np.int32)


@pytest.mark.parametrize("case", ["512x10", "512x100", "ties"])
def test_classification_metrics_match_jax(case):
    logits, labels = _logits(case)
    ref = JM.classification_metrics(jnp.asarray(logits), jnp.asarray(labels))
    out = TM.classification_metrics(torch.from_numpy(logits), torch.from_numpy(labels))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_small_n_metrics_match_jax():
    """n < n_bins clamps the adaptive bin count (metrics.py:119-125 of the
    reference package); a single-class set leaves AUROC undefined (0.0)."""
    rs = np.random.RandomState(5)
    logits = rs.randn(7, 4).astype(np.float32)
    for labels in (rs.randint(0, 4, 7).astype(np.int32), np.zeros(7, np.int32)):
        ref = JM.classification_metrics(jnp.asarray(logits), jnp.asarray(labels))
        out = TM.classification_metrics(torch.from_numpy(logits), torch.from_numpy(labels))
        for k in ref:
            np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_to_float_and_normalize_match_jax():
    u8 = np.random.RandomState(3).randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    ref = JA.normalize(JA.to_float(jnp.asarray(u8)), JA.IMAGENET_DEFAULT_MEAN,
                       JA.IMAGENET_DEFAULT_STD)
    out = TA.normalize(TA.to_float(torch.from_numpy(u8)), TA.IMAGENET_DEFAULT_MEAN,
                       TA.IMAGENET_DEFAULT_STD)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_collect_logits_concatenates_and_rejects_empty():
    batches = [(torch.full((2, 3), float(i)), torch.tensor([i, i])) for i in range(3)]
    logits, labels = collect_logits(lambda x: x * 2, batches)
    assert logits.dtype == np.float32 and logits.shape == (6, 3)
    np.testing.assert_array_equal(labels, [0, 0, 1, 1, 2, 2])
    np.testing.assert_array_equal(logits[:, 0], [0, 0, 2, 2, 4, 4])
    with pytest.raises(ValueError):
        collect_logits(lambda x: x, [])
    empty_logits, empty_labels = collect_logits(lambda x: x, [], allow_empty=True)
    assert empty_logits.shape == (0, 0) and empty_labels.shape == (0,)


def test_evaluate_matches_jax():
    overrides = dict(img_size=64, patch_size=16, embed_dim=128, depth=2, num_heads=2,
                     num_classes=10, init_values=0.1, use_shared_rel_pos_bias=True)
    rs = np.random.RandomState(0)
    u8 = [rs.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8) for _ in range(2)]
    labels = [rs.randint(0, 10, 4).astype(np.int32) for _ in range(2)]

    jmodel = JViT(cfg=ViTConfig(**overrides))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    params = jax.tree_util.tree_map(
        lambda s: (0.05 * rs.randn(*s.shape)).astype(np.float32), shapes
    )
    mean, std = JA.IMAGENET_DEFAULT_MEAN, JA.IMAGENET_DEFAULT_STD
    ref = JE.evaluate(jmodel, {"params": params},
                      [(JA.normalize(JA.to_float(jnp.asarray(x)), mean, std), y)
                       for x, y in zip(u8, labels)])

    model = load_flax_params(VisionTransformer(TViTConfig(**overrides), device="cpu"), params)
    batches = ((TA.normalize(TA.to_float(torch.from_numpy(x)), mean, std), torch.from_numpy(y))
               for x, y in zip(u8, labels))
    out = evaluate(model, batches, forward=make_eval_forward(model))
    assert not model.training
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)


def _run(code_or_args, env=None):
    args = [sys.executable] + (["-c", code_or_args] if isinstance(code_or_args, str)
                               else code_or_args)
    return subprocess.run(args, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_port_never_imports_jax():
    proc = _run(
        "import sys\n"
        "import importlib, pkgutil\n"
        "import uncertainty_vit_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for wanted in ('core.device', 'ops.philox', 'ops.dropout', 'evals.mc_dropout',\n"
        "               'evals.ensembles', 'evals.collect', 'evals.classification',\n"
        "               'models.vit', 'ops.augment', 'utils.checkpoint', 'ops.flash_attention',\n"
        "               'ops._native', 'ops.quant', 'train.engine_finetune', 'train.optim'):\n"
        "    assert pkg.__name__ + '.' + wanted in names, wanted\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'uncertainty_vit_tpu')]\n"
        "assert not bad, bad\n"
    )
    assert proc.returncode == 0, proc.stderr
    # the scripts that drive the port on the card, and every source of the
    # package (the large-N route's included), name no module of JAX or of the
    # JAX package
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|uncertainty_vit_tpu)\b(?!_)",
                         re.MULTILINE)
    sources = [Path(REPO) / "chip_smoke.py", *sorted((Path(REPO) / "tools").glob("torch_port_*.py")),
               *sorted((Path(REPO) / "uncertainty_vit_tpu_torch").rglob("*.py"))]
    assert Path(REPO) / "uncertainty_vit_tpu_torch" / "ops" / "flash_attention.py" in sources
    assert Path(REPO) / "uncertainty_vit_tpu_torch" / "ops" / "quant.py" in sources
    for path in sources:
        assert not pattern.search(path.read_text()), path


def test_chip_smoke_fails_without_a_card():
    proc = _run(["chip_smoke.py"], env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
