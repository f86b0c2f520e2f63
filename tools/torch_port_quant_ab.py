#!/usr/bin/env python3
"""The int8 kernels K6 and K7 of two checkouts, in one process, on one card.

    python3 tools/torch_port_quant_ab.py OTHER_CHECKOUT

Loads ``ops/quant.py`` and ``ops/_native.py`` of OTHER_CHECKOUT beside this
checkout's package (the other's wrappers call the other's kernels, built
from its ``csrc/`` into its own ``build/kernels/``), then at the four
ViT-B/16 224 trunk shapes (qkv, proj, fc1, fc2; M = 31,520 tokens, the
train step at batch 160, bf16) times in turns (other, this, this, other):
K6 forward (``qmm``: nearest rounding, bias), K6 dgrad (stochastic, K and N
swapped, no bias) and K7 (``wgrad_acc``: both of its kernels, without
``wgrad()``'s plain column-scale and dequantizing passes). Beside them, timed
in the same turns: ``torch._int_mm`` alone on operands quantized beforehand
(one library call for the product; both operands with the contraction
contiguous, as the kernels read them), bf16 ``F.linear`` (the layer the int8
forward replaces) and bf16 ``x.T @ g`` (the wgrad it replaces). Each time is
the least of 3 runs of 20 calls after 3 warm-ups (CUDA events). A
torch.profiler window of 10 calls per case splits each checkout's call into
its kernels (``chip_smoke.kernel_split``: device time per call by kernel
name).

Both checkouts must give the same bits: K6's output and K7's int32 sums are
exact functions of the inputs and the seed, equal to the plain versions'.
Prints one JSON line per case and a summary; exits non-zero if the bits
differ. Needs one CUDA card and nvcc. The last line names the card and its
power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRUNK = {"qkv": (768, 2304), "proj": (768, 768), "fc1": (768, 3072), "fc2": (3072, 768)}
M = 160 * 197
HBM_BYTES_PER_S, INT8_OPS_PER_S = 3.35e12, 1979e12


def _load(name: str, path: str, **globals_):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for key, value in globals_.items():
        setattr(module, key, value)
    return module


def _least_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    runs = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / 20)
    return min(runs)


def _k6_case(torch, this, other, gen, seed, k, n, sr) -> dict:
    """K6 at [M, K] x [K, N] of both checkouts, and its yardsticks."""
    dev = seed.device
    x = torch.randn(M, k, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(n, k, generator=gen, device=dev) * 0.05
    wq, ws = this.quantize_cols(w.t())
    bias = None if sr else torch.randn(n, generator=gen, device=dev) * 0.1
    xq = this.quantize_rows(x, seed, sr)[0]
    wb, bias_b = w.to(torch.bfloat16), None if bias is None else bias.to(torch.bfloat16)
    same = torch.equal(this.qmm(x, wq, ws, bias, seed, sr, torch.bfloat16),
                       other.qmm(x, wq, ws, bias, seed, sr, torch.bfloat16))
    return {"fns": {"other": lambda: other.qmm(x, wq, ws, bias, seed, sr, torch.bfloat16),
                    "this": lambda: this.qmm(x, wq, ws, bias, seed, sr, torch.bfloat16),
                    "torch._int_mm alone": lambda: torch._int_mm(xq, wq),
                    "bf16 F.linear": lambda: torch.nn.functional.linear(x, wb, bias_b)},
            "same_bits": same, "k": k, "n": n,
            "bytes": 2 * x.numel() + wq.numel() + 4 * n * (1 if bias is None else 2) + 2 * M * n}


def _k7_case(torch, this, other, gen, seed, k, n) -> dict:
    """K7 at x [M, K], g [M, N] of both checkouts, and its yardsticks."""
    dev = seed.device
    x = torch.randn(M, k, generator=gen, device=dev).to(torch.bfloat16)
    g = (torch.randn(M, n, generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    inv_x, inv_g = this._col_scales(x).reciprocal(), this._col_scales(g).reciprocal()
    # both copies with the tokens contiguous, as K7's product reads them
    xq_t = torch.round(x.float() * inv_x).to(torch.int8).t().contiguous()
    gq = torch.round(g.float() * inv_g).to(torch.int8).t().contiguous().t()
    same = torch.equal(this.wgrad_acc(x, g, inv_x, inv_g, seed),
                       other.wgrad_acc(x, g, inv_x, inv_g, seed))
    return {"fns": {"other": lambda: other.wgrad_acc(x, g, inv_x, inv_g, seed),
                    "this": lambda: this.wgrad_acc(x, g, inv_x, inv_g, seed),
                    "torch._int_mm alone": lambda: torch._int_mm(xq_t, gq),
                    "bf16 x.T @ g": lambda: x.t() @ g},
            "same_bits": same, "k": k, "n": n,
            "bytes": 2 * (x.numel() + g.numel()) + 4 * (k + n) + 4 * k * n}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from uncertainty_vit_tpu_torch.ops import quant as this

    other_root = os.path.abspath(sys.argv[1])
    ops_dir = os.path.join(other_root, "uncertainty_vit_tpu_torch", "ops")
    other_native = _load("other_native", os.path.join(ops_dir, "_native.py"))
    other = _load("other_quant", os.path.join(ops_dir, "quant.py"), _native=other_native)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(10)
    seed = torch.tensor([0x0123456789ABCDEF], dtype=torch.int64, device=dev)
    ok, summary = True, {}
    for layer, (k_in, n_out) in TRUNK.items():
        cases = {"K6 forward": _k6_case(torch, this, other, gen, seed, k_in, n_out, False),
                 "K6 dgrad": _k6_case(torch, this, other, gen, seed, n_out, k_in, True),
                 "K7": _k7_case(torch, this, other, gen, seed, k_in, n_out)}
        for name, case in cases.items():
            fns = case["fns"]
            order = list(fns)
            runs = {key: [] for key in order}
            for key in ["other", "this"] + [k_ for k_ in order if k_ not in ("other", "this")] \
                    + ["this", "other"]:
                runs[key].append(_least_ms(torch, fns[key]))
            bound_ms = max(case["bytes"] / HBM_BYTES_PER_S,
                           2.0 * M * case["k"] * case["n"] / INT8_OPS_PER_S) * 1e3
            split = {key: cs.kernel_split(torch, fns[key]) for key in ("other", "this")}
            row = {"case": f"{name} {layer}", "M": M, "K": case["k"], "N": case["n"],
                   "ms": runs, "least_ms": {key: min(v) for key, v in runs.items()},
                   "bound_ms": bound_ms, "kernels_ms_per_call": split,
                   "same_bits": case["same_bits"]}
            ok &= case["same_bits"]
            summary[row["case"]] = row["least_ms"]
            print(json.dumps(row), flush=True)
        del cases
    print(json.dumps({"least_ms": summary, "ok": ok}), flush=True)
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
