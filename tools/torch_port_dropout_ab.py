#!/usr/bin/env python3
"""The dropout kernel K8 of two checkouts, in one process, on one card.

    python3 tools/torch_port_dropout_ab.py OTHER_CHECKOUT

Loads ``ops/dropout.py`` and ``ops/_native.py`` of OTHER_CHECKOUT beside this
checkout's package (the other's wrapper calls the other's kernel, built from
its ``csrc/`` into its own ``build/kernels/``). Holds both against the plain
version to the bit, flat ([8*197, 768], a ragged [1001], a misaligned view)
and as row windows (each rank's rows of [64, 577, 768], phase 25's MC-dropout
fold at ViT-B/16 384, and of a ragged [1, 7, 6] and [3, 7, 6]), in bf16
and f32. Then times in turns (other, this, this, other) at the MC-dropout
shape of ViT-B/16 224, [1024*197, 768] bf16 rate 0.1: the flat call, and the
same bytes as the window [1024, 197 of 394, 768]; beside them ``F.dropout``
on the same input. Each time is the least of 3 runs of 20 calls after 3
warm-ups (CUDA events).

Prints one JSON line per timed case and a summary; exits non-zero if any
bits differ. Needs one CUDA card and nvcc. The first and last lines name the
card and its power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12


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


def _bit_cases(torch, gen, dev):
    """(name, x, window) over the flat and windowed shapes, bf16 and f32."""
    base = torch.randn(8 * 197 * 768 + 8, generator=gen, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        b = base.to(dtype)
        yield f"{dtype} [8*197, 768]", b[:8 * 197 * 768].view(8 * 197, 768), None
        yield f"{dtype} [1001]", b[:1001], None
        mis = torch.cat([b[:1], b[:1001]])[1:]
        assert mis.data_ptr() % 16 != 0 and mis.is_contiguous()
        yield f"{dtype} [1001] misaligned", mis, None
        for n, rows_of, c, g in ((577, ((0, 289), (289, 577)), 768, 64),
                                 (7, ((0, 4), (4, 7)), 6, 1), (7, ((0, 4), (4, 7)), 6, 3)):
            x = torch.randn(g, n, c, generator=gen, device=dev).to(dtype)
            for start, stop in rows_of:
                yield (f"{dtype} window [{g}, {start}:{stop} of {n}, {c}]",
                       x[:, start:stop].contiguous(), (start, n))


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from uncertainty_vit_tpu_torch.ops import dropout as this

    ops_dir = os.path.join(os.path.abspath(sys.argv[1]), "uncertainty_vit_tpu_torch", "ops")
    other_native = _load("other_native", os.path.join(ops_dir, "_native.py"))
    other = _load("other_dropout", os.path.join(ops_dir, "dropout.py"), _native=other_native)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    seed = torch.tensor([0x00C0FFEE12345678], dtype=torch.int64, device=dev)
    ok = True
    for name, x, window in _bit_cases(torch, gen, dev):
        for rate in (0.1, 0.5):
            ref = this.fused_dropout_plain(x, rate, seed, window)
            same = {"this": torch.equal(this.fused_dropout(x, rate, seed, window), ref),
                    "other": torch.equal(other.fused_dropout(x, rate, seed, window), ref)}
            ok &= all(same.values())
            print(f"{name} rate {rate}: equal to the plain version {same}", flush=True)

    x = torch.randn(1024 * 197, 768, generator=gen, device=dev).to(torch.bfloat16)
    xw = x.view(1024, 197, 768)
    same = torch.equal(this.fused_dropout(x, 0.1, seed), other.fused_dropout(x, 0.1, seed))
    same &= torch.equal(this.fused_dropout(xw, 0.1, seed, (197, 394)),
                        other.fused_dropout(xw, 0.1, seed, (197, 394)))
    ok &= same
    bound_ms = 2 * 2 * x.numel() / HBM_BYTES_PER_S * 1e3
    summary = {}
    for case, fns in {
            "flat [1024*197, 768]": {"other": lambda: other.fused_dropout(x, 0.1, seed),
                                     "this": lambda: this.fused_dropout(x, 0.1, seed),
                                     "F.dropout": lambda: torch.nn.functional.dropout(
                                         x, 0.1, training=True)},
            "window [1024, 197 of 394, 768]": {
                "other": lambda: other.fused_dropout(xw, 0.1, seed, (197, 394)),
                "this": lambda: this.fused_dropout(xw, 0.1, seed, (197, 394))}}.items():
        runs = {key: [] for key in fns}
        for key in ["other", "this"] + [k for k in fns if k not in ("other", "this")] \
                + ["this", "other"]:
            runs[key].append(_least_ms(torch, fns[key]))
        row = {"case": case, "dtype": "bfloat16", "rate": 0.1, "ms": runs,
               "least_ms": {key: min(v) for key, v in runs.items()}, "bound_ms": bound_ms,
               "same_bits": same}
        summary[case] = row["least_ms"]
        print(json.dumps(row), flush=True)
    for tag, native in (("this", this._native), ("other", other_native)):
        for entry, used in re.findall(r"Function properties for (\S*dropout\S*)\n.*?\n"
                                      r"ptxas info\s*: (Used \d+ registers)",
                                      native.BUILD_LOG.get("dropout", (0, ""))[1]):
            print(f"{tag} {entry}: {used}", flush=True)
    print(json.dumps({"least_ms": summary, "bound_ms": bound_ms, "ok": ok}), flush=True)
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
