"""PyTorch port: the golden-weights eval tool (tools/torch_port_golden_eval.py)
against the port's driver and the JAX package's tool (tools/golden_eval.py),
as tests/test_golden_eval.py holds the JAX tool.

The published weights are not in the repository, so a tiny model's JAX
params, exported to a torch .pth in the reference's ``{'model': sd}`` layout
(the JAX package's ``export_torch_state_dict``; the head drawn at std 0.5 so
that the logits stand apart and the accuracies do not hang on a last bit),
go through the tool over CIFAR-format pickles. Both tools run at
``--dtype float32``; the port on the CPU (``run(a, device="cpu")``).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from uncertainty_vit_tpu_torch.cli import finetune as TFT
from uncertainty_vit_tpu_torch.ops import flash_attention as TFA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import golden_eval as JGE  # noqa: E402
import torch_port_golden_eval as GE  # noqa: E402

# the two packages' losses: the same f32 model on the same images, summed in
# another order (tests/test_torch_port_cli_eval.py holds the drivers' metrics
# within 1e-4 likewise)
LOSS_ATOL = 1e-4
N_TEST = 48


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cifar")
    base = root / "cifar-100-python"
    base.mkdir()
    rs = np.random.RandomState(0)
    for name, n in (("train", 64), ("test", N_TEST)):
        data = rs.randint(0, 255, (n, 3072), dtype=np.uint8)
        with open(base / name, "wb") as f:
            pickle.dump({b"data": data, b"fine_labels": (np.arange(n) % 10).tolist()}, f)
    return str(root)


@pytest.fixture(scope="module")
def tiny_pth(tmp_path_factory):
    """The JAX exporter's .pth of a tiny model, {'model': state_dict}."""
    from uncertainty_vit_tpu.core.config import get_preset
    from uncertainty_vit_tpu.models.vit import VisionTransformer
    from uncertainty_vit_tpu.utils import checkpoint as C

    model = VisionTransformer(cfg=get_preset("beit_test_patch16_32", num_classes=100))
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 32, 32, 3))
    params = jax.device_get(model.init(jax.random.PRNGKey(0), x)["params"])
    head = params["head"]["kernel"]
    params["head"]["kernel"] = (np.random.RandomState(3).randn(*head.shape) * 0.5).astype(
        np.float32)
    sd = C.export_torch_state_dict(params)
    path = tmp_path_factory.mktemp("w") / "tiny_golden.pth"
    torch.save({"model": {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}}, str(path))
    return str(path)


@pytest.fixture(autouse=True)
def restore_softmax_mode(monkeypatch):
    """The drivers set the bounded-scores attention, a process global."""
    import uncertainty_vit_tpu.ops.flash_attention as JFA

    monkeypatch.setattr(JFA, "BOUNDED_SCORES", JFA.BOUNDED_SCORES)
    monkeypatch.setattr(TFA, "BOUNDED_SCORES", TFA.BOUNDED_SCORES)
    monkeypatch.delenv("UVIT_ATTN_BOUNDED_SCORES", raising=False)


def _argv(cifar_root, tiny_pth, *extra):
    return ["--pth", tiny_pth, "--model", "beit_test_patch16_32", "--data_path", cifar_root,
            "--data_set", "CIFAR100", "--input_size", "32", "--batch_size", "16",
            "--num_workers", "0", "--dtype", "float32", *extra]


def test_tool_builds_the_jax_tools_argv(cifar_root, tiny_pth):
    """The same flags give the same driver argv as the JAX tool, which the
    port's driver parses."""
    for extra in ([], ["--nb_classes", "100", "--crop_pct", "0.9", "--output_dir", "o"]):
        a = GE.get_args_parser().parse_args(_argv(cifar_root, tiny_pth, *extra))
        b = JGE.get_args_parser().parse_args(_argv(cifar_root, tiny_pth, *extra))
        assert GE.build_cli_argv(a) == JGE.build_cli_argv(b)
        args = TFT.get_args_parser().parse_args(GE.build_cli_argv(a))
        assert args.eval and args.finetune == tiny_pth and args.dtype == "float32"


def test_tool_equals_the_port_driver_and_matches_the_jax_tool(cifar_root, tiny_pth):
    """The tool's numbers equal the port driver's --eval result exactly;
    against the JAX tool on the same .pth the accuracies are equal and the
    loss within LOSS_ATOL; the line is the reference's format."""
    a = GE.get_args_parser().parse_args(_argv(cifar_root, tiny_pth))
    out = GE.run(a, device="cpu")
    assert out["ok"] and out["line"] == (f"* Acc@1 {out['acc1']:.3f} Acc@5 {out['acc5']:.3f} "
                                         f"loss {out['loss']:.3f}")
    direct = TFT.main(TFT.get_args_parser().parse_args(GE.build_cli_argv(a)), device="cpu")
    assert (out["acc1"], out["acc5"], out["loss"]) == (
        float(direct["eval"]["acc1"]), float(direct["eval"]["acc5"]),
        float(direct["eval"]["nll"]))
    ref = JGE.run(JGE.get_args_parser().parse_args(_argv(cifar_root, tiny_pth)))
    # equal as counts of the 48 images (the two packages round the f32
    # percentage differently: 10.416666 against 10.416668)
    for k in ("acc1", "acc5"):
        assert round(out[k] * N_TEST / 100) == round(ref[k] * N_TEST / 100), k
        assert abs(out[k] - ref[k]) <= 1e-4, k
    assert abs(out["loss"] - ref["loss"]) <= LOSS_ATOL, (out["loss"], ref["loss"])
    assert 0.0 < out["acc5"] < 100.0  # the numbers are not degenerate


def test_expect_gate(cifar_root, tiny_pth, capsys):
    """--expect passes on the measured triple and exits 1 outside --acc_tol /
    --loss_tol, naming the mismatch."""
    out = GE.run(GE.get_args_parser().parse_args(_argv(cifar_root, tiny_pth)), device="cpu")
    measured = f"{out['acc1']:.3f},{out['acc5']:.3f},{out['loss']:.3f}"
    assert GE.main(_argv(cifar_root, tiny_pth, "--expect", measured), device="cpu") == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == out["line"]
    off_loss = f"{out['acc1']:.3f},{out['acc5']:.3f},{out['loss'] + 0.02:.3f}"
    off_acc = f"{out['acc1'] + 0.2:.3f},{out['acc5']:.3f},{out['loss']:.3f}"
    for expect in (off_loss, off_acc, "99.9,99.9,0.001"):
        assert GE.main(_argv(cifar_root, tiny_pth, "--expect", expect), device="cpu") == 1
        assert "GOLDEN MISMATCH" in capsys.readouterr().err
    # a wider tolerance takes the loss that is 0.02 off
    assert GE.main(_argv(cifar_root, tiny_pth, "--expect", off_loss, "--loss_tol", "0.05"),
                   device="cpu") == 0


def test_tool_imports_neither_jax_nor_the_jax_package(cifar_root, tiny_pth):
    """A run of the tool in a fresh process, the driver's evaluation
    included, leaves no module of JAX or of the JAX package imported."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tools')!r})\n"
        "import torch_port_golden_eval as GE\n"
        f"assert GE.main({_argv(cifar_root, tiny_pth)!r}, device='cpu') == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'uncertainty_vit_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("* Acc@1 ")
