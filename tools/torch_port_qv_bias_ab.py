#!/usr/bin/env python3
"""Where the q/v bias of the bf16 streaming attention kernels is added, timed on one card.

    python3 tools/torch_port_qv_bias_ab.py

At the ViT-L/16 512 shapes of ``chip_smoke.py`` phases 7 and 8 (N = 1025,
H = 16, bf16, bias, bounded softmax) it times K3 at B = 16 and K4 at B = 8
given a q/v bias, which the kernels add in shared memory, against the same
kernels given a copy of qkv that already holds it: the three-kernel copy
(split, ``_qv_biased``, cat) and a one-add copy (``qkv + [b_q, -0, b_v]``;
adding -0 leaves k exact). The K4 calls with a copy also form d(q/v bias)
(``reduce_qv_bias_grad``), as the routed call does, so that both sides do
the same work; each copy, the sum alone and both kernels without a q/v bias
are timed beside them. Checks that the kernel's add and the copies give the
same bits (dbias, summed by atomics in a run-dependent order, within 1e-6).
ms per call: CUDA events, the least of two turns of 10 calls. Needs one
CUDA card and nvcc; exits non-zero on a failed check. The last line names
the card and its power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from uncertainty_vit_tpu_torch.ops import _native
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA

    if not torch.cuda.is_available():
        print("torch_port_qv_bias_ab: no CUDA device is available", file=sys.stderr)
        return 2
    cs.build_kernels(_native)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    h, c, scale, n = 16, 1024, 64**-0.5, 1025
    qkv = torch.randn(16, n, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
    qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
    qvb[1] = 0.0
    row3 = torch.cat([qvb[0], torch.full_like(qvb[0], -0.0), qvb[2]]).to(torch.bfloat16)

    def three_kernel_copy(x):
        q, k, v = x.split(c, dim=-1)
        q, v = FA._qv_biased(q, v, qvb)
        return torch.cat([q, k, v], dim=-1)

    def one_add_copy(x):
        return x + row3

    def fwd(x, qv_bias):
        return FA.fused_qkv_attention(x, bias, qv_bias, None, scale, h, bounded_scores=True)

    x = qkv[:8].contiguous()
    g = torch.randn(8, n, c, generator=gen, device=dev).to(torch.bfloat16)
    out, lse = FA.fused_qkv_attention(x, bias, qvb, None, scale, h, bounded_scores=True,
                                      want_lse=True)
    out0, lse0 = FA.fused_qkv_attention(x, bias, None, None, scale, h, bounded_scores=True,
                                        want_lse=True)

    def bwd_on_copy(copy):
        dqkv, dbias, _ = FA.fused_qkv_attention_bwd(copy(x), bias, None, lse, g, scale, h, out=out)
        return dqkv, dbias, FA.reduce_qv_bias_grad(dqkv)

    fns = {
        "K3 q/v bias in the kernel": lambda: fwd(qkv, qvb),
        "K3 on the three-kernel copy": lambda: fwd(three_kernel_copy(qkv), None),
        "K3 on the one-add copy": lambda: fwd(one_add_copy(qkv), None),
        "K3 no q/v bias": lambda: fwd(qkv, None),
        "K4 q/v bias in the kernel": lambda: FA.fused_qkv_attention_bwd(x, bias, qvb, lse, g,
                                                                        scale, h, out=out),
        "K4 on the three-kernel copy, + d(q/v bias)": lambda: bwd_on_copy(three_kernel_copy),
        "K4 on the one-add copy, + d(q/v bias)": lambda: bwd_on_copy(one_add_copy),
        "K4 no q/v bias": lambda: FA.fused_qkv_attention_bwd(x, bias, None, lse0, g, scale, h,
                                                             out=out0),
        "three-kernel copy alone B=16": lambda: three_kernel_copy(qkv),
        "one-add copy alone B=16": lambda: one_add_copy(qkv),
        "one-add copy alone B=8": lambda: one_add_copy(x),
    }
    ok = torch.equal(three_kernel_copy(qkv), one_add_copy(qkv))
    ok &= torch.equal(fns["K3 q/v bias in the kernel"](), fns["K3 on the one-add copy"]())
    got, ref = fns["K4 q/v bias in the kernel"](), fns["K4 on the one-add copy, + d(q/v bias)"]()
    ok &= torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])
    ok &= (got[1] - ref[1]).abs().max().item() <= 1e-6
    fns["d(q/v bias) alone B=8"] = lambda: FA.reduce_qv_bias_grad(got[0])
    best, runs = cs.in_turns(fns, 10)
    print(json.dumps({"ms": runs}), flush=True)
    print(json.dumps({"least_ms": best, "same_bits": ok}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
