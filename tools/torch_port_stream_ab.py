#!/usr/bin/env python3
"""The attention kernels K1 to K5 of two checkouts, on one card.

    python3 tools/torch_port_stream_ab.py OTHER_CHECKOUT [PAIRS]

Runs the kernels of OTHER_CHECKOUT and of this checkout in turns (other,
this, this, other; PAIRS times, 1 if not given), each turn a process of its
own that imports ``uncertainty_vit_tpu_torch`` from its checkout and builds
its kernels there. Each turn first builds the two attention sources at once
(one nvcc each, as ``_native.build_all`` does) and reports the wall seconds
and each nvcc's where it compiled them (the checkout's first turn, with no
library of the same sources in its build/kernels: a fresh build).
At the ViT-B/16 224 shapes of ``chip_smoke.py`` phases 1 and 3 (N = 197,
H = 12, bf16, bias, bounded softmax): the fused forward K1 at B = 128, at
B = 160 with the lse (the train step's), at B = 1024 (the folded MC-dropout
batch) with dropout 0 and 0.1; the fused backward K2 at B = 160 with dropout
0 and 0.05; and beside them, as the yardstick a design for N <= 256 must
beat, the streaming kernels' entries called at the same shapes ("stream at
...": ``_packed_fwd`` and ``_packed_bwd``, uncounted, or in a checkout from
before K1 and K2 ran them, ``_launch_stream`` and ``_launch_stream_bwd``). At the
ViT-L/16 512 shapes of phases 7, 8 and 14 (N = 1025, H = 16): the streaming
forward K3 at B = 16, K3 with the lse at B = 8, the streaming backward K4 at
B = 8, and one K5 shard of B = 8 at S = 2 (Nq = 513) and S = 4 (Nq = 257),
forward with the lse plus backward, beside the library call for the S = 2
shard (scaled_dot_product_attention with the bias as a bf16 mask, and
autograd's backward of it). At head width 80 (16 heads, phase 13's shapes):
K1 at B = 128 and at B = 32 with the lse, K2 at B = 32 (N = 197), K3 at B =
16 and with the lse at B = 8, K4 at B = 8 (N = 1025). With a q/v bias
(the q and v rows added in the kernels, dqkv's reduction giving its
gradient), at head widths 64 and 80: K3 at B = 16 and K4 at B = 8. Each turn
prints its ms per call (CUDA events, the least of 3 runs of 20 calls after 3
warm-ups) and a digest of K1's output and lse, K2's dqkv, K3's output and
lse, K4's dqkv, the q/v-bias K3 output and K4 dqkv and the S = 2 shard's
out, dq and dkv on the same seeded inputs (dbias, summed by atomics in a
run-dependent order, is not digested), and saves those tensors under
build/stream_ab/. For the calls of PROFILED it also gives each kernel's mean
device microseconds a call (torch.profiler over 20 calls; K2 and K4 are two
kernels each).

The digests of one checkout's two turns must be equal (each checkout is
deterministic); the two checkouts may differ in their bits (a redesign sums
in another order) and are held to each other at chip_smoke.py's bounds: the
outputs within 1e-2 (atol = rtol), the lse within 1e-3, dqkv, dq and dkv
within 2e-2 of max|other|; the summary says whether every digested tensor
is equal to the other checkout's to the bit, this checkout's least time
over the other's for each call, the spread of each checkout's per-turn times
(its largest over its least) and each checkout's fresh build. Needs one CUDA
card and nvcc; exits non-zero on a failed turn or check. The last line names
the card and its power limit.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

OUT_TOL, LSE_ATOL, GRAD_REL = 1e-2, 1e-3, 2e-2
PROFILED = ("K2 B=160", "K4 B=8", "D=80 K4 B=8", "D=64 K4 B=8 q/v bias")
ATTENTION_SOURCES = ("flash_attention_stream_fwd", "flash_attention_stream_bwd")
SAVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
                        "stream_ab")


def _digest(torch, tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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


def _kernel_us(torch, fns) -> dict:
    """{call: {kernel: mean device microseconds a call}} over 20 calls of
    each function under torch.profiler ({} where it records no device
    time)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    res = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        res[name] = {}
        for e in prof.key_averages():
            m = (re.search(r"(stream_\w+)<(\d+), (\w+)>", e.key)
                 or re.search(r"(stream_\w+?)ILi(\d+)ELb(\d)E", e.key))
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = getattr(e, "cuda_time_total", 0.0)
            if m and total:
                res[name][f"{m.group(1)}<{m.group(2)},{m.group(3)}>"] = total / 20
    return res


def _build(native) -> dict:
    """Builds the attention sources at once; the wall seconds, and each
    nvcc's where it compiled (no library of the same sources existed)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(ATTENTION_SOURCES)) as pool:
        list(pool.map(native.build, ATTENTION_SOURCES))
    wall = time.perf_counter() - t0
    nvcc = {name: native.BUILD_LOG[name][0] for name in ATTENTION_SOURCES
            if name in native.BUILD_LOG}
    return {"fresh": len(nvcc) == len(ATTENTION_SOURCES), "wall_s": wall, "nvcc_s": nvcc}


def _time_here(root: str, save_as: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from uncertainty_vit_tpu_torch.ops import _native
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA

    build = _build(_native)

    # a checkout from before the backward took the forward's output
    takes_out = "out" in inspect.signature(FA.fused_qkv_attention_bwd).parameters

    def bwd(qkv, bias, lse, out, g):
        extra = {"out": out} if takes_out else {}
        return FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, **extra)

    def cross_bwd(q, kv, bias, lse, out, g):
        extra = {"out": out} if takes_out else {}
        return FA.cross_qkv_attention_bwd(q, kv, bias, None, lse, g, scale, h, **extra)

    dev = torch.device("cuda", 0)
    fns, saved = _vit_b_224(torch, FA, dev)
    d80_fns, d80_saved = _head_width_80(torch, FA, dev, takes_out)
    fns.update(d80_fns)
    saved.update(d80_saved)
    gen = torch.Generator(device=dev).manual_seed(7)
    h, c, n, scale = 16, 1024, 1025, 64**-0.5
    qkv = torch.randn(16, n, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
    g = torch.randn(8, n, c, generator=gen, device=dev).to(torch.bfloat16)
    train = qkv[:8].contiguous()
    kv = train[..., c:].contiguous()
    out16 = FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=True)
    out, lse = FA.fused_qkv_attention(train, bias, None, None, scale, h, bounded_scores=True,
                                      want_lse=True)
    dqkv = bwd(train, bias, lse, out, g)[0]
    fns.update({
        "K3 B=16": lambda: FA.fused_qkv_attention(qkv, bias, None, None, scale, h,
                                                  bounded_scores=True),
        "K3 B=8 with lse": lambda: FA.fused_qkv_attention(train, bias, None, None, scale, h,
                                                          bounded_scores=True, want_lse=True),
        "K4 B=8": lambda: bwd(train, bias, lse, out, g),
    })
    saved.update({"K3 out": out16, "K3 lse": lse, "K4 dqkv": dqkv})
    qvb_fns, qvb_saved = _qv_bias(torch, FA, dev, takes_out)
    fns.update(qvb_fns)
    saved.update(qvb_saved)
    for s in (2, 4):
        nq = -(-n // s)
        q, b_r, g_r = train[:, :nq, :c].contiguous(), bias[:, :nq].contiguous(), g[:, :nq]
        g_r = g_r.contiguous()
        o_r, l_r = FA.cross_qkv_attention(q, kv, b_r, None, scale, h, bounded_scores=True,
                                          want_lse=True)
        fns[f"K5 S={s} forward"] = (lambda q=q, b_r=b_r: FA.cross_qkv_attention(
            q, kv, b_r, None, scale, h, bounded_scores=True, want_lse=True))
        fns[f"K5 S={s} backward"] = (lambda q=q, b_r=b_r, l_r=l_r, o_r=o_r, g_r=g_r: cross_bwd(
            q, kv, b_r, l_r, o_r, g_r))
        if s == 2:
            dq, dkv = cross_bwd(q, kv, b_r, l_r, o_r, g_r)[:2]
            saved.update({"K5 S=2 out": o_r, "K5 S=2 dq": dq, "K5 S=2 dkv": dkv})
            heads = lambda t: t.view(8, -1, h, 64).transpose(1, 2)  # noqa: E731
            q_leaf = heads(q).detach().requires_grad_()
            kv_leaves = (heads(kv[..., :c]).detach().requires_grad_(),
                         heads(kv[..., c:]).detach().requires_grad_())
            mask_leaf = b_r.to(torch.bfloat16).requires_grad_()
            lib_out = torch.nn.functional.scaled_dot_product_attention(
                q_leaf, *kv_leaves, attn_mask=mask_leaf, scale=scale)
            fns["library S=2 forward"] = (
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q_leaf.detach(), *(t.detach() for t in kv_leaves), attn_mask=mask_leaf.detach(),
                    scale=scale))
            fns["library S=2 backward"] = (lambda g_h=heads(g_r): torch.autograd.grad(
                lib_out, (q_leaf, *kv_leaves, mask_leaf), g_h, retain_graph=True))
    ms = {name: _least_ms(torch, fn) for name, fn in fns.items()}
    kernel_us = _kernel_us(torch, {k: fns[k] for k in PROFILED})
    for s in (2, 4):
        ms[f"K5 S={s} forward + backward"] = ms[f"K5 S={s} forward"] + ms[f"K5 S={s} backward"]
    ms["library S=2 forward + backward"] = ms["library S=2 forward"] + ms["library S=2 backward"]
    os.makedirs(SAVE_DIR, exist_ok=True)
    torch.save({k: v.cpu() for k, v in saved.items()}, os.path.join(SAVE_DIR, save_as))
    return {"ms": ms, "kernel_us": kernel_us, "build": build, "digest": _digest(torch, saved.values()), "saved": save_as,
            "launches": [FA.fused_qkv_attention.launches, FA.fused_qkv_attention_bwd.launches,
                         FA.fused_qkv_attention.stream_launches,
                         FA.fused_qkv_attention_bwd.stream_launches,
                         FA.cross_qkv_attention.launches, FA.cross_qkv_attention_bwd.launches]}


def _head_width_80(torch, FA, dev, takes_out):
    """K1 to K4 at head width 80 (16 heads, chip_smoke.py phase 13's shapes):
    K1 at ViT-H/16 224's B = 128 and B = 32 with the lse, K2 at B = 32, K3
    at B = 16 and K4 at B = 8, N = 1025 (the functions to time, the tensors
    to digest)."""
    gen = torch.Generator(device=dev).manual_seed(80)
    h, d = 16, 80
    c, scale = h * d, d**-0.5
    fns, saved = {}, {}
    for n, b_fwd, b_bwd, k_fwd, k_bwd in ((197, 128, 32, "K1", "K2"), (1025, 16, 8, "K3", "K4")):
        qkv = torch.randn(b_fwd, n, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        g = torch.randn(b_bwd, n, c, generator=gen, device=dev).to(torch.bfloat16)
        train = qkv[:b_bwd].contiguous()
        out, lse = FA.fused_qkv_attention(train, bias, None, None, scale, h, bounded_scores=True,
                                          want_lse=True)
        fns[f"D=80 {k_fwd} B={b_fwd}"] = (lambda qkv=qkv, bias=bias: FA.fused_qkv_attention(
            qkv, bias, None, None, scale, h, bounded_scores=True))
        fns[f"D=80 {k_fwd} B={b_bwd} with lse"] = (
            lambda train=train, bias=bias: FA.fused_qkv_attention(
                train, bias, None, None, scale, h, bounded_scores=True, want_lse=True))
        extra = {"out": out} if takes_out else {}
        fns[f"D=80 {k_bwd} B={b_bwd}"] = (
            lambda train=train, bias=bias, lse=lse, g=g, extra=extra: FA.fused_qkv_attention_bwd(
                train, bias, None, lse, g, scale, h, **extra))
        saved.update({f"D=80 {k_fwd} out": fns[f"D=80 {k_fwd} B={b_fwd}"](),
                      f"D=80 {k_fwd} lse": lse,
                      f"D=80 {k_bwd} dqkv": fns[f"D=80 {k_bwd} B={b_bwd}"]()[0]})
    return fns, saved


def _qv_bias(torch, FA, dev, takes_out):
    """K3 at B = 16 and K4 at B = 8 (N = 1025, 16 heads, bias, bounded) with
    a q/v bias (its k row zero), at head widths 64 and 80 (the functions to
    time, the tensors to digest)."""
    fns, saved = {}, {}
    h, n = 16, 1025
    for d in (64, 80):
        gen = torch.Generator(device=dev).manual_seed(1000 + d)
        c, scale = h * d, d**-0.5
        qkv = torch.randn(16, n, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        g = torch.randn(8, n, c, generator=gen, device=dev).to(torch.bfloat16)
        train = qkv[:8].contiguous()
        out, lse = FA.fused_qkv_attention(train, bias, qvb, None, scale, h, bounded_scores=True,
                                          want_lse=True)
        extra = {"out": out} if takes_out else {}
        fns[f"D={d} K3 B=16 q/v bias"] = (lambda qkv=qkv, bias=bias, qvb=qvb:
                                          FA.fused_qkv_attention(qkv, bias, qvb, None, scale, h,
                                                                 bounded_scores=True))
        fns[f"D={d} K4 B=8 q/v bias"] = (
            lambda train=train, bias=bias, qvb=qvb, lse=lse, g=g, extra=extra:
            FA.fused_qkv_attention_bwd(train, bias, qvb, lse, g, scale, h, **extra))
        saved.update({f"D={d} K3 q/v bias out": fns[f"D={d} K3 B=16 q/v bias"](),
                      f"D={d} K3 q/v bias lse": lse,
                      f"D={d} K4 q/v bias dqkv": fns[f"D={d} K4 B=8 q/v bias"]()[0]})
    return fns, saved


def _vit_b_224(torch, FA, dev):
    """K1 and K2 at the ViT-B/16 224 shapes, and the streaming entries at the
    same shapes: (the functions to time, the tensors to digest)."""
    gen = torch.Generator(device=dev).manual_seed(224)
    h, c, n, scale = 12, 768, 197, 64**-0.5
    seed = torch.tensor([0x0123456789ABCDEF], dtype=torch.int64, device=dev)
    big = torch.randn(1024, n, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
    g = torch.randn(160, n, c, generator=gen, device=dev).to(torch.bfloat16)
    ev, train = big[:128], big[:160]
    out, lse = FA.fused_qkv_attention(train, bias, None, None, scale, h, bounded_scores=True,
                                      want_lse=True)
    out_d = FA.fused_qkv_attention(train, bias, None, seed, scale, h, 0.05, bounded_scores=True)
    fwd = lambda x, **kw: (lambda: FA.fused_qkv_attention(  # noqa: E731
        x, bias, None, kw.get("seed"), scale, h, kw.get("rate", 0.0), bounded_scores=True,
        want_lse=kw.get("lse", False)))
    if hasattr(FA, "_packed_bwd"):  # the streaming entries, uncounted
        # a checkout whose entries take the batch fold: none here
        fold = ("fold",) if "fold" in inspect.signature(FA._packed_fwd).parameters else ()
        stream_fwd = lambda *args: FA._packed_fwd(*args, *(None,) * len(fold),  # noqa: E731
                                                  "stream")
        stream_bwd = lambda *args: FA._packed_bwd(*args, *(None,) * len(fold),  # noqa: E731
                                                  "stream")
    else:  # a checkout from before K1 and K2 ran the streaming kernels
        stream_fwd, stream_bwd = FA._launch_stream, FA._launch_stream_bwd
    stream = lambda x, **kw: (lambda: stream_fwd(  # noqa: E731
        x, bias, None, scale, h, True, kw.get("lse", False), kw.get("seed"), kw.get("rate", 0.0)))
    fns = {}
    for what, x, kw in (("B=128", ev, {}), ("B=160 with lse", train, {"lse": True}),
                        ("B=1024", big, {}),
                        ("B=1024 dropout 0.1", big, {"seed": seed, "rate": 0.1})):
        fns[f"K1 {what}"] = fwd(x, **kw)
        fns[f"stream at K1 {what}"] = stream(x, **kw)
    bwd = lambda **kw: (lambda: FA.fused_qkv_attention_bwd(  # noqa: E731
        train, bias, None, lse, g, scale, h, out=kw.get("out", out), seed=kw.get("seed"),
        dropout_rate=kw.get("rate", 0.0)))
    fns["K2 B=160"] = bwd()
    fns["K2 B=160 dropout 0.05"] = bwd(out=out_d, seed=seed, rate=0.05)
    fns["stream at K2 B=160"] = lambda: stream_bwd(train, bias, None, lse, out, g, scale, h,
                                                   True, None, 0.0)
    fns["stream at K2 B=160 dropout 0.05"] = lambda: stream_bwd(
        train, bias, None, lse, out_d, g, scale, h, True, seed, 0.05)
    saved = {"K1 out": fwd(ev)(), "K1 lse": lse, "K2 dqkv": bwd()()[0]}
    return fns, saved


def _compare(this_file: str, other_file: str) -> dict:
    """max|Δ| of each saved tensor between the checkouts, and whether it is
    within its bound."""
    import torch

    a = torch.load(os.path.join(SAVE_DIR, this_file))
    b = torch.load(os.path.join(SAVE_DIR, other_file))
    res = {}
    for name in b:
        x, y = a[name].float(), b[name].float()
        err = (x - y).abs().max().item()
        if "lse" in name:
            ok = err <= LSE_ATOL
        elif "out" in name:
            ok = bool(torch.allclose(x, y, atol=OUT_TOL, rtol=OUT_TOL))
        else:
            ok = err <= GRAD_REL * y.abs().max().item()
        res[name] = {"max_abs_diff": err, "within_bound": ok, "equal": bool(torch.equal(x, y))}
    return res


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--time-in":
        print(json.dumps(_time_here(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    pairs = int(sys.argv[2]) if len(sys.argv) == 3 else 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    other = os.path.abspath(sys.argv[1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    turns = []
    order = (("other", other), ("this", here), ("this", here), ("other", other)) * pairs
    for i, (label, root) in enumerate(order):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-in", root,
                               f"{label}_{i}.pt"], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        turns.append((label, res))
        print(json.dumps({"checkout": label, "root": root, **res}), flush=True)
    same = {label: len({r["digest"] for lb, r in turns if lb == label}) == 1
            for label in ("other", "this")}
    diff = _compare(turns[1][1]["saved"], turns[0][1]["saved"])
    best = {label: {k: min(r["ms"][k] for lb, r in turns if lb == label)
                    for k in turns[0][1]["ms"] if all(k in r["ms"] for _, r in turns)}
            for label in ("other", "this")}
    ok = all(same.values()) and all(d["within_bound"] for d in diff.values())
    ratio = {k: best["this"][k] / best["other"][k] for k in best["this"]}
    spread = {label: {k: max(r["ms"][k] for lb, r in turns if lb == label) / best[label][k]
                      for k in best[label]}
              for label in ("other", "this")}
    builds = {label: [r["build"] for lb, r in turns if lb == label and r["build"]["fresh"]]
              for label in ("other", "this")}
    kernels = {label: {call: {k: min(r["kernel_us"][call].get(k, float("inf"))
                                     for lb, r in turns if lb == label)
                              for k in turns[0][1]["kernel_us"][call]}
                       for call in PROFILED}
               for label in ("other", "this")}
    print(json.dumps({"least_ms": best, "this_over_other": ratio, "spread": spread,
                      "fresh_build": builds, "least_kernel_us": kernels,
                      "same_bits_within_each_checkout": same,
                      "bits_equal_to_other": all(d["equal"] for d in diff.values()),
                      "this_against_other": diff, "ok": ok}), flush=True)
    print(json.dumps({"card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
