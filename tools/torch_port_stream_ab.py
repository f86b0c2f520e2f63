#!/usr/bin/env python3
"""K3 and K4 (the streaming attention kernels) of two checkouts, on one card.

    python3 tools/torch_port_stream_ab.py OTHER_CHECKOUT

Runs the kernels of OTHER_CHECKOUT and of this checkout in turns (other,
this, this, other), each turn a process of its own that imports
``uncertainty_vit_tpu_torch`` from its checkout and builds its kernels there,
at the ViT-L/16 512 shapes of ``chip_smoke.py`` phases 7 and 8 (N = 1025, H =
16, bf16, bias, bounded softmax): K3 at B = 16, K3 with the lse at B = 8 and
K4 at B = 8. Each turn prints its ms per call (CUDA events, the least of 3
runs of 20 calls after 3 warm-ups) and a digest of K3's output and lse and
K4's dqkv on the same seeded inputs; the digests of all turns must be equal
(dbias, summed by atomics in a run-dependent order, is not digested). Needs
one CUDA card and nvcc; exits non-zero on a difference or a failed turn.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys


def _digest(torch, *tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _time_here(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from uncertainty_vit_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    h, c, n, scale = 16, 1024, 1025, 64**-0.5
    qkv = torch.randn(16, n, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
    g = torch.randn(8, n, c, generator=gen, device=dev).to(torch.bfloat16)
    train = qkv[:8].contiguous()
    out, lse = FA.fused_qkv_attention(train, bias, None, None, scale, h, bounded_scores=True,
                                      want_lse=True)
    dqkv = FA.fused_qkv_attention_bwd(train, bias, None, lse, g, scale, h)[0]
    fns = {
        "K3 B=16": lambda: FA.fused_qkv_attention(qkv, bias, None, None, scale, h,
                                                  bounded_scores=True),
        "K3 B=8 with lse": lambda: FA.fused_qkv_attention(train, bias, None, None, scale, h,
                                                          bounded_scores=True, want_lse=True),
        "K4 B=8": lambda: FA.fused_qkv_attention_bwd(train, bias, None, lse, g, scale, h),
    }
    ms = {}
    for name, fn in fns.items():
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
        ms[name] = min(runs)
    return {"ms": ms, "digest": _digest(torch, out, lse, dqkv),
            "launches": [FA.fused_qkv_attention.stream_launches,
                         FA.fused_qkv_attention_bwd.stream_launches]}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time-in":
        print(json.dumps(_time_here(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(sys.argv[1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    turns = []
    for label, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-in", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append((label, res))
        print(json.dumps({"checkout": label, "root": root, **res}), flush=True)
    digests = {res["digest"] for _, res in turns}
    best = {label: {k: min(r["ms"][k] for lb, r in turns if lb == label)
                    for k in turns[0][1]["ms"]} for label in ("other", "this")}
    print(json.dumps({"least_ms": best, "same_results": len(digests) == 1}), flush=True)
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
