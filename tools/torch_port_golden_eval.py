"""Golden-weights eval of the PyTorch port on the card.

The port's counterpart of tools/golden_eval.py, with the same flags: it
builds the port's ``cli.finetune --eval`` argv from them, runs the driver
(``uncertainty_vit_tpu_torch.cli.finetune.main``) on the card, and prints the
reference's expected-result line ``* Acc@1 A Acc@5 B loss L``
(get_started_for_image_classification.md:74-117 of the reference
repository). With ``--expect acc1,acc5,loss`` it exits 1 when a number lies
outside ``--acc_tol`` (percentage points) or ``--loss_tol``:

    python3 tools/torch_port_golden_eval.py \\
        --pth beit_large_patch16_224_pt22k_ft22kto1k.pth \\
        --model beit_large_patch16_224 --data_path /path/to/imagenet \\
        --expect 87.396,98.282,0.515

The .pth goes through the driver's importer (``utils/checkpoint.py``:
``{'model' | 'module': state_dict}`` containers, the position-embedding and
rel-pos interpolation). The published weights of BASELINE.md's accuracy
table are not in the repository; tests/test_torch_port_golden_eval.py holds
the tool against the port's driver and the JAX package's tool on
exporter-made weights. ``run(a, device=...)`` takes the CPU for those tests
only. It imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def get_args_parser():
    p = argparse.ArgumentParser("golden-weights eval of the PyTorch port")
    p.add_argument("--pth", required=True,
                   help="reference checkpoint (.pth; model|module containers probed like "
                        "run_class_finetuning.py:400-406)")
    p.add_argument("--model", required=True, help="registry name, e.g. beit_large_patch16_224")
    p.add_argument("--data_path", required=True)
    p.add_argument("--data_set", default="IMNET")
    p.add_argument("--input_size", type=int, default=None,
                   help="eval resolution (the get_started 384/512 runs pass --input_size)")
    p.add_argument("--nb_classes", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--crop_pct", type=float, default=None)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--output_dir", default="")
    p.add_argument("--expect", default=None,
                   help="golden 'acc1,acc5,loss' triple from the get_started table; exits 1 "
                        "outside tolerance")
    p.add_argument("--acc_tol", type=float, default=0.15,
                   help="|acc - golden| tolerance in percentage points")
    p.add_argument("--loss_tol", type=float, default=0.01)
    p.add_argument("extra", nargs="*", default=[],
                   help="extra flags passed through to cli.finetune")
    return p


def build_cli_argv(a) -> list:
    """The port driver's argv for the evaluation ``a`` asks for."""
    argv = [
        "--eval", "--model", a.model, "--finetune", a.pth,
        "--data_set", a.data_set, "--data_path", a.data_path,
        "--batch_size", str(a.batch_size), "--num_workers", str(a.num_workers),
        "--output_dir", a.output_dir, "--dtype", a.dtype,
    ]
    if a.input_size is not None:
        argv += ["--input_size", str(a.input_size)]
    if a.nb_classes is not None:
        argv += ["--nb_classes", str(a.nb_classes)]
    if a.crop_pct is not None:
        argv += ["--crop_pct", str(a.crop_pct)]
    return argv + list(a.extra)


def run(a, device=None) -> dict:
    """Runs the evaluation and returns {'acc1', 'acc5', 'loss', 'line', 'ok'}
    (and 'golden' with ``--expect``). ``device`` None is the card."""
    from uncertainty_vit_tpu_torch.cli import finetune as FT

    ev = FT.main(FT.get_args_parser().parse_args(build_cli_argv(a)), device=device)["eval"]
    out = {"acc1": float(ev["acc1"]), "acc5": float(ev["acc5"]), "loss": float(ev["nll"])}
    out["line"] = f"* Acc@1 {out['acc1']:.3f} Acc@5 {out['acc5']:.3f} loss {out['loss']:.3f}"
    out["ok"] = True
    if a.expect:
        g1, g5, gl = (float(v) for v in a.expect.split(","))
        out["ok"] = (abs(out["acc1"] - g1) <= a.acc_tol and abs(out["acc5"] - g5) <= a.acc_tol
                     and abs(out["loss"] - gl) <= a.loss_tol)
        out["golden"] = {"acc1": g1, "acc5": g5, "loss": gl}
    return out


def main(argv=None, device=None) -> int:
    a = get_args_parser().parse_args(argv)
    out = run(a, device)
    print(out["line"])
    if a.expect and not out["ok"]:
        g = out["golden"]
        print(f"GOLDEN MISMATCH: got ({out['acc1']:.3f}, {out['acc5']:.3f}, {out['loss']:.3f}) "
              f"vs expected ({g['acc1']:.3f}, {g['acc5']:.3f}, {g['loss']:.3f}) "
              f"[tol acc {a.acc_tol}, loss {a.loss_tol}]", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
