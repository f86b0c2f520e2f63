#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (uncertainty_vit_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc; it builds the port's CUDA
kernels from the sources in this checkout, then:

  phase 1  holds the attention forward kernel (K1) against its plain PyTorch
           version at B=8, N in {197, 50}, H=12, D=64, in bf16 (the model's
           compute dtype) and f32, over bias / no bias, q/v bias / none,
           bounded / exact softmax and with / without the row log-sum-exp;
           then holds its in-kernel dropout (rates 0.1 and 0.3) against the
           plain version's, which draws the same mask from the same seed, and
           checks that the lse is the undropped softmax's and that with zero
           scores and v = 1 the kernel's output is the plain version's to the
           bit (each row's kept count); then times the kernel at the ViT-B/16
           224 eval shape (B=128, N=197, bf16, bias, bounded) and at the
           MC-dropout shape (B=1024), with rate 0 and rate 0.1, beside the
           plain version and one scaled_dot_product_attention call at B=128,
           after holding each of those four launches against the plain version
           too (at B=1024 computed 128 images at a time). K1's own launcher is
           also held at N=577 and N=1025 (B=2, bf16 and f32, bias, both softmax
           modes, dropout 0 and 0.1), whatever kernel the route picks there.
  phase 2  runs evaluate() of a full-width ViT-B/16 224 (beit_base_patch16_224,
           shared rel-pos bias, layer scale 0.1, 1000 classes, seeded random
           weights, bf16 compute on f32 params) over 4 batches of 128
           synthetic uint8 images, checks that every block launched K1, checks
           the logits against the same weights on the plain attention path and
           the metrics against a CPU recomputation, and measures the eval
           forward rate of both models.
  phase 3  holds the attention backward kernel (K2) against its plain PyTorch
           version at B=8, N in {197, 50}, bf16 and f32, over bias / none,
           q/v bias / none and an lse from a bounded and from an exact K1
           forward (dqkv, dbias, dqvb); checks that the autograd Function's
           gradient (K1 + K2) equals autograd through the plain forward in
           f32; holds its dropout-mask replay against the plain version's;
           checks the Euler identity <df/dv, v> = 2f of f = sum(out^2) through
           the Function at rate 0.3, and that it fails when the backward is
           given another seed than the forward; then holds K2 with rate 0 and
           0.05 against the plain backward at the ViT-B/16 224 train shape
           (B=160, N=197, bf16, bias) and times them there beside autograd's
           backward of scaled_dot_product_attention, and with the padded bias
           copies built anew in every call.
  phase 4  runs full-width ViT-B/16 224 finetune train steps as bench.py
           configures them (batch 160, drop-path 0.1, layer decay 0.65, AdamW
           with weight decay 0.05 on a cosine LR, batch mixup, bounded-scores
           softmax, bf16 compute on f32 params), checks that every step
           launched K1 and K2 once per block and that loss, grad norm and
           parameters are finite and the parameters moved, holds one step
           against the same step on the plain attention path, measures the
           train-step rate of both, and takes one step with attention dropout
           0.05 (the mask drawn in K1 and replayed in K2), held against the
           same step with the attention on its plain versions, which draw the
           same masks from the same seeds. K2's own launcher must raise at
           N=577, where the routed call goes to K4.
  phase 5  holds the fused dropout kernel (K8) against its plain PyTorch
           version to the bit, in bf16 and f32, at rates 0.1 and 0.5, on
           [8*197, 768], [3, 50, 64], a ragged [1001] and a misaligned view;
           then times it at the MC-dropout shape [1024*197, 768] bf16 beside
           the plain version and F.dropout.
  phase 6  runs evaluate_mc_dropout() of the full-width ViT-B/16 224 with
           drop_rate 0.1 over 2 batches of 128 synthetic images, K=8 samples:
           (a) folded into one batch of 1024 at full depth and (b) with the
           trunk split at block 9 on a model whose dropout starts there.
           Checks per forward K1 12 launches, K8 24 in (a) and 6 in (b), K2
           none; that the [K, B, C] logits are finite, differ between
           samples, and are bit-identical from the same generator seed; that
           (a)'s forward agrees with the same forward on the plain attention
           and (b) with the folded forward of the same model and seed; that
           the metrics equal a CPU recomputation from the mean logits; then
           one forward with attention dropout 0.1, held against the plain
           attention with the same masks, and a 2-member evaluate_ensemble().
           Prints ms per K*B pass and its ratio to the deterministic forward
           ("pass-equivalents"). After it no ViT-B path may have launched a
           streaming kernel.
  phase 7  holds the streaming attention forward (K3), through the routed
           call, against its plain version at B=2, N in {257, 577, 1025}, H=16,
           in bf16 and f32, over bias / none, q/v bias / none, bounded / exact
           softmax, dropout 0 / 0.1 and with / without the lse (K1's
           tolerances; the lse with dropout bit-equal to the rate-0 lse); then
           holds and times it at the ViT-L/16 512 eval shape (B=16, N=1025,
           bf16, bias, bounded) and, with the lse, at the train step's B=8;
           also timed without bias, with the lse and with dropout 0.1, in turns
           with K1 at the same shape, one scaled_dot_product_attention call
           and the plain version (4 images at a time).
  phase 8  holds the split streaming backward (K4: two kernels behind one
           call), through the routed call, against its two plain versions over
           the same grid of cases (dq, dk, dv, dbias and dqvb each against
           K2's bound relative to max|plain|; dqkv bit-identical between two
           runs); plants NaN right before and behind qkv, g and the lse at
           N=577 and 1025 and checks that no bit of out, lse or dqkv changes;
           checks the Function's gradient (K3 + K4, f32) against autograd of
           the plain forward, and the Euler identity at rate 0.3 and its
           failure from another seed; then holds and times K4 at the ViT-L/16
           512 train shape (B=8, N=1025, bf16, bias) with rate 0 and 0.05,
           without dbias and with the padded bias copies built anew in every
           call, beside autograd's backward of scaled_dot_product_attention
           and the plain versions.
  phase 9  the large-N slice: a full-width, full-depth ViT-L/16 512
           (beit_large_patch16_512: width 1024, depth 24, 16 heads, N=1025,
           shared rel-pos bias, layer scale 0.1, bf16 compute on f32 params)
           whose seeded weights are first carried across from the 224 model of
           the same width by resize_state_dict (rel-pos table from the 14 x 14
           to the 32 x 32 window). evaluate() over 2 batches of 16 uint8
           images (K3 24 launches per forward, K1 none; logits against the
           plain attention; metrics against a CPU recomputation); 3 finetune
           train steps at batch 8 (K3 and K4 24 per step, K1/K2 none; every
           parameter finite and moved); one step at batch 2 and one with
           attention dropout 0.05 held against the same steps with the
           attention on its plain versions; one K=2 MC forward of batch 4 with
           attention dropout 0.1 likewise. Prints img/s and peak memory as
           information.

Prints the card's name and power limit first, a JSON line describing each
kernel second to last, and {"ok": true, "device": {...}} last. Any failed
check ends the run with a non-zero exit. There is no CPU path.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

# Phase-1 tolerances on the output, per input dtype: bf16 output against the
# plain version's bf16 output (both round once to bf16 from f32 arithmetic;
# the kernel's online softmax rounds e against a running max), f32 against
# f32 (sums in another order); and on the f32 lse.
OUT_TOL = {"bfloat16": 1e-2, "float32": 1e-4}  # atol = rtol
LSE_ATOL = 1e-3
# Phase-2 bound on |logits(kernel) − logits(plain attention)|, relative to
# max |logits(plain)|: both models run 12 bf16 blocks on the same weights and
# differ only in where the attention rounds to bf16.
LOGIT_REL_BOUND = 5e-2
# Metrics on the card against the same metrics on the CPU (f32 sums in
# another order).
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-5
# Phase-3 bounds on max|kernel − plain| relative to max|plain|, per input
# dtype. dqkv: bf16 rounds ds and p to bf16 before the products, and an ulp
# of difference in p flips some of those roundings (about K1's 1e-2); f32
# sums in another order. dbias: the kernel adds the batch's ds with f32
# atomics in a run-dependent order, so it is held looser in f32. dqvb sums
# dqkv in f32, so it inherits dqkv's bound.
BWD_TOL = {"bfloat16": {"dqkv": 2e-2, "dbias": 2e-2, "dqvb": 2e-2},
           "float32": {"dqkv": 1e-5, "dbias": 1e-4, "dqvb": 1e-5}}
# The Function's gradient (K1 + K2, f32) against autograd through the plain
# forward, relative to the largest gradient entry.
GRAD_REL_BOUND = 1e-4
# Phase 4: one train step on the kernel path against the same step on the
# plain attention path (same weights, same generator seeds). Both run 12
# bf16 blocks and differ only in where the attention rounds to bf16.
LOSS_REL_BOUND = 1e-2
GRAD_NORM_REL_BOUND = 5e-2
# The Euler identity <df/dv, v> = 2f of f = sum(out^2) holds to f32 rounding
# when the backward replays the forward's dropout mask and breaks at the
# percent level when it does not (tests/test_flash_attention.py:102-123).
EULER_RTOL = 1e-3
# Published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds: the
# least time the card could take is the larger of bytes / memory rate and
# operations / peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# The streaming kernels' token counts: right above K2's limit, and the 384 and
# 512 presets' (both 1 mod 64: one valid row in the last q tile and one valid
# column in the last k/v tile).
BIG_N = (257, 577, 1025)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound(n_bytes: float, flops: float, dtype: str) -> tuple:
    """(bound_ms, bound_by) of work that moves n_bytes (each input read once,
    each output written once) and does flops operations in dtype."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def in_turns(fns: dict, iters: int) -> tuple:
    """Times the named functions in turns a, b, ..., b, a; returns (the
    least ms of each, both times of each)."""
    names = list(fns)
    runs = {k: [] for k in names}
    for name in names + names[::-1]:
        runs[name].append(cuda_ms(fns[name], iters))
    return {k: min(v) for k, v in runs.items()}, runs


def sdpa_packed(torch, qkv, bias_cast, scale, h):
    """One library call that computes what K1 computes (exact softmax): the
    head split, scaled_dot_product_attention with the bias as its mask, and
    the merge back to [B, N, C]. Timed as a yardstick; the port never calls
    it."""
    b, n, c3 = qkv.shape
    q, k, v = qkv.view(b, n, 3, h, c3 // (3 * h)).permute(2, 0, 3, 1, 4)
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias_cast,
                                                         scale=scale)
    return o.transpose(1, 2).reshape(b, n, c3 // 3)


@contextlib.contextmanager
def attention_on_plain(torch, FA):
    """Inside, the attention wrappers compute with their plain versions on the
    card too (128 images at a time, 4 above N=256; same seeds and so same
    dropout masks) and launch none of K1 to K4: the reference that a run of
    a whole model on the kernels is held against. Only this script does so;
    the package never takes a plain version for a CUDA tensor."""
    fwd, bwd = FA._forward, FA.fused_qkv_attention_bwd

    def plain_fwd(qkv, bias, qv_bias, scale, h, bounded, want_lse, seed, rate):
        step = 128 if qkv.shape[1] <= 256 else 4
        parts = [FA.fused_qkv_attention_plain(qkv[i:i + step], bias, qv_bias, scale, h,
                                              bounded_scores=bounded, seed=seed,
                                              dropout_rate=rate, image0=i)
                 for i in range(0, qkv.shape[0], step)]
        return torch.cat([o for o, _ in parts]), torch.cat([l for _, l in parts])

    def plain_bwd(qkv, bias, qv_bias, lse, g, scale, h, *, want_dbias=True, seed=None,
                  dropout_rate=0.0):
        dqkv, dbias, dqvb = FA.fused_qkv_attention_bwd_plain(
            qkv, bias, qv_bias, lse, g, scale, h, seed=seed, dropout_rate=dropout_rate)
        return dqkv, dbias if want_dbias else None, dqvb

    FA._forward, FA.fused_qkv_attention_bwd = plain_fwd, plain_bwd
    try:
        yield
    finally:
        FA._forward, FA.fused_qkv_attention_bwd = fwd, bwd


def bias_copies_rebuilt(FA, fn):
    """fn as a backward runs it the first time it meets a bias: with the
    padded bias copies of ``FA._padded_bias`` forgotten, so that the call
    builds them again."""
    def run():
        FA._padded_bias_cache = None
        return fn()
    return run


def cuda_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_kernels(_native) -> None:
    """Builds every csrc/*.cu at once and prints nvcc's seconds and ptxas's
    registers and spills per kernel instantiation (<..., kDrop or kVector>)."""
    t0 = time.perf_counter()
    libs = _native.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (secs, log) in _native.BUILD_LOG.items():
        print(f"  nvcc {name}: {secs:.1f} s", flush=True)
        for entry, spills, used in re.findall(
                r"Function properties for (\S+)\n\s*(.*?)\nptxas info\s*: (Used \d+ registers)", log):
            short = re.search(r"\d+((?:attention|dropout|stream)_\w+?E)E*v", entry)
            print(f"    {short.group(1) if short else entry}: {used}, {spills}", flush=True)


def phase1(torch, FA, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    h, c, scale = 12, 768, 64**-0.5
    worst_out = 0.0
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), (197, 50)):
        tol = OUT_TOL[str(dtype).split(".")[1]]
        qkv = torch.randn(8, n, 3 * c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        for has_bias, has_qvb, bounded in itertools.product((True, False), repeat=3):
            b_ = bias if has_bias else None
            q_ = qvb if has_qvb else None
            out, lse = FA.fused_qkv_attention(qkv, b_, q_, None, scale, h,
                                              bounded_scores=bounded, want_lse=True)
            out_only = FA.fused_qkv_attention(qkv, b_, q_, None, scale, h, bounded_scores=bounded)
            ref, ref_lse = FA.fused_qkv_attention_plain(qkv, b_, q_, scale, h,
                                                        bounded_scores=bounded)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            worst_out = max(worst_out, err)
            print(f"  K1 {str(dtype)[6:]} N={n} bias={has_bias:d} qv_bias={has_qvb:d} "
                  f"bounded={bounded:d}: max|out-plain|={err:.3e} max|lse-plain|={lse_err:.3e}",
                  flush=True)
            check(torch.isfinite(out.float()).all().item(), "K1 output is not finite")
            check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
                  f"K1 output disagrees with the plain version (max abs {err:.3e})")
            check(lse_err <= LSE_ATOL, f"K1 lse disagrees with the plain version ({lse_err:.3e})")
            check(torch.equal(out, out_only), "K1 output depends on want_lse")

    # in-kernel dropout: kernel and plain version draw one mask from one seed
    from uncertainty_vit_tpu_torch.ops import philox

    seed = torch.tensor([0x0123456789ABCDEF], dtype=torch.int64, device=dev)
    worst_drop = 0.0
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), (197, 50)):
        tol = OUT_TOL[str(dtype).split(".")[1]]
        qkv = torch.randn(8, n, 3 * c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        for has_bias, bounded, rate in itertools.product((True, False), (True, False),
                                                         (0.1, 0.3)):
            b_ = bias if has_bias else None
            out, lse = FA.fused_qkv_attention(qkv, b_, None, seed, scale, h, rate,
                                              bounded_scores=bounded, want_lse=True)
            out_only = FA.fused_qkv_attention(qkv, b_, None, seed, scale, h, rate,
                                              bounded_scores=bounded)
            _, lse0 = FA.fused_qkv_attention(qkv, b_, None, None, scale, h, 0.0,
                                             bounded_scores=bounded, want_lse=True)
            ref, _ = FA.fused_qkv_attention_plain(qkv, b_, None, scale, h, bounded_scores=bounded,
                                                  seed=seed, dropout_rate=rate)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - lse0).abs().max().item()
            worst_drop = max(worst_drop, err)
            print(f"  K1 dropout {rate} {str(dtype)[6:]} N={n} bias={has_bias:d} "
                  f"bounded={bounded:d}: max|out-plain|={err:.3e} "
                  f"max|lse-lse(rate 0)|={lse_err:.3e}", flush=True)
            check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
                  f"K1 with dropout disagrees with the plain version (max abs {err:.3e})")
            check(lse_err <= LSE_ATOL, f"K1's lse changes with dropout ({lse_err:.3e})")
            check(torch.equal(out, out_only), "K1 output with dropout depends on want_lse")
        # zero scores and v = 1: a row's output is its kept count times
        # 1/(1 - rate) over N, so the kernel's mask is the plain mask's
        ones = torch.zeros(8, n, 3 * c, device=dev, dtype=dtype)
        ones[..., 2 * c:] = 1.0
        for rate in (0.1, 0.3):
            out = FA.fused_qkv_attention(ones, None, None, seed, scale, h, rate,
                                         bounded_scores=False)
            ref, _ = FA.fused_qkv_attention_plain(ones, None, None, scale, h,
                                                  bounded_scores=False, seed=seed,
                                                  dropout_rate=rate)
            if dtype == torch.bfloat16:
                # sums of one bf16 value are exact in f32 in any order
                check(torch.equal(out, ref), f"K1's dropout mask is not the plain version's "
                      f"(bfloat16 N={n} rate {rate})")
            else:
                kept = (philox.attention_bits(seed, 8, h, n, n) >= philox.threshold(rate)).sum(-1)
                got = (out.reshape(8, n, h, 64)[..., 0] * n * (1.0 - rate)).round().long()
                check(torch.equal(got.transpose(1, 2), kept), "K1's kept count per row differs")
                frac = kept.sum().item() / (8 * h * n * n)
                print(f"  K1 dropout {rate} N={n}: kept counts per row equal the plain mask's; "
                      f"kept fraction {frac:.4f}", flush=True)
    try:
        FA.fused_qkv_attention(qkv, None, None, None, scale, h, 0.1)
        check(False, "K1 took a dropout rate without a seed")
    except ValueError:
        pass

    # K1 itself above N=197 (its launcher, whatever kernel the route picks
    # there): its k/v tiling at 10 and 17 tiles, with one valid row in the
    # last q tile and one valid column in the last k/v tile
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), (577, 1025)):
        tol = OUT_TOL[str(dtype).split(".")[1]]
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        for bounded, rate in itertools.product((True, False), (0.0, 0.1)):
            sd = seed if rate > 0.0 else None
            out, lse = FA._launch(qkv, bias, None, scale, h, bounded, True, sd, rate)
            _, lse0 = FA._launch(qkv, bias, None, scale, h, bounded, True)
            ref, ref_lse = FA.fused_qkv_attention_plain(qkv, bias, None, scale, h,
                                                        bounded_scores=bounded, seed=sd,
                                                        dropout_rate=rate)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            if rate > 0.0:
                worst_drop = max(worst_drop, err)
            else:
                worst_out = max(worst_out, err)
            print(f"  K1 {str(dtype)[6:]} N={n} bias=1 bounded={bounded:d} dropout {rate}: "
                  f"max|out-plain|={err:.3e} max|lse-plain|={lse_err:.3e}", flush=True)
            check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
                  f"K1 at N={n} disagrees with the plain version (max abs {err:.3e})")
            check(lse_err <= LSE_ATOL, f"K1 lse at N={n} disagrees with the plain version")
            check(torch.equal(lse, lse0), f"K1's lse at N={n} changes with dropout")
        del qkv, bias, out, lse, lse0, ref, ref_lse

    # eval shape of ViT-B/16 224: B=128, N=197, bias, bounded scores, and the
    # MC-dropout shape B=1024 (K=8 samples of batch 128 folded)
    qkv = torch.randn(128, 197, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, 197, 197, generator=gen, device=dev) * 0.5
    bias_cast = bias.to(torch.bfloat16)
    kern = lambda: FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=True)
    drop = lambda: FA.fused_qkv_attention(qkv, bias, None, seed, scale, h, 0.1,
                                          bounded_scores=True)
    plain = lambda: FA.fused_qkv_attention_plain(qkv, bias, None, scale, h, bounded_scores=True)
    lib = lambda: sdpa_packed(torch, qkv, bias_cast, scale, h)

    def plain_sliced(x, rate):
        """The plain version 128 images at a time, each slice with the mask
        of its place in the batch."""
        return torch.cat([FA.fused_qkv_attention_plain(
            x[i:i + 128], bias, None, scale, h, bounded_scores=True, seed=seed,
            dropout_rate=rate, image0=i)[0] for i in range(0, x.shape[0], 128)])

    def held_k1(what, got, want):
        got, tol = got.float(), OUT_TOL["bfloat16"]
        err = (got - want.float()).abs().max().item()
        print(f"  K1 bfloat16 {what} N=197 bias=1 bounded=1: max|out-plain|={err:.3e}",
              flush=True)
        check(torch.allclose(got, want.float(), atol=tol, rtol=tol),
              f"K1 at {what} disagrees with the plain version (max abs {err:.3e})")
        return err

    out, ref = kern().float(), plain()[0].float()
    err = (out - ref).abs().max().item()
    worst_out = max(worst_out, err)
    lib_err = (out - lib().float()).abs().max().item()
    print(f"  K1 bfloat16 B=128 N=197 bias=1 qv_bias=0 bounded=1: max|out-plain|={err:.3e}, "
          f"max|out-library call|={lib_err:.3e}", flush=True)
    check(torch.allclose(out, ref, atol=OUT_TOL["bfloat16"], rtol=OUT_TOL["bfloat16"]),
          f"K1 output disagrees with the plain version at the eval shape (max abs {err:.3e})")
    worst_drop = max(worst_drop, held_k1("B=128 dropout 0.1", drop(), plain_sliced(qkv, 0.1)))
    best, runs = in_turns({"plain": plain, "kernel": kern, "dropout 0.1": drop,
                           "library": lib}, 20)
    print(f"  K1 at B=128 N=197 H=12 D=64 bf16 (bias, bounded), ms per call: {runs}", flush=True)
    bound_ms, bound_by = bound(nbytes(qkv, bias) + qkv.numel() // 3 * 2,
                               4.0 * 128 * h * 197 * 197 * 64, "bfloat16")
    del out, ref
    big = torch.randn(1024, 197, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    kern_big = lambda: FA.fused_qkv_attention(big, bias, None, None, scale, h,
                                              bounded_scores=True)
    drop_big = lambda: FA.fused_qkv_attention(big, bias, None, seed, scale, h, 0.1,
                                              bounded_scores=True)
    # the shape the MC-dropout path gives K1 (12,288 (image, head) pairs)
    worst_out = max(worst_out, held_k1("B=1024", kern_big(), plain_sliced(big, 0.0)))
    worst_drop = max(worst_drop, held_k1("B=1024 dropout 0.1", drop_big(),
                                         plain_sliced(big, 0.1)))
    best_big, runs_big = in_turns({"kernel": kern_big, "dropout 0.1": drop_big}, 10)
    big_bound, _ = bound(nbytes(big, bias) + big.numel() // 3 * 2,
                         4.0 * 1024 * h * 197 * 197 * 64, "bfloat16")
    print(f"  K1 at B=1024 (the MC-dropout shape), ms per call: {runs_big}; bound "
          f"{big_bound:.4f} ms", flush=True)
    return {"max_abs_err": max(worst_out, worst_drop), "ms": best["kernel"],
            "plain_ms": best["plain"], "library_ms": best["library"], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "other_ms": {"B=128 dropout 0.1": best["dropout 0.1"],
                         "B=1024": best_big["kernel"],
                         "B=1024 dropout 0.1": best_big["dropout 0.1"],
                         "B=1024 bound": big_bound}}


def phase2(torch, FA, dev):
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals.classification import evaluate, make_eval_forward
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )

    # the finetune driver's eval runs the bounded-scores softmax
    FA.BOUNDED_SCORES = True
    cfg = get_preset("beit_base_patch16_224", use_shared_rel_pos_bias=True, init_values=0.1)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    # the reference zero-initializes the rel-pos table; draw it so the bias
    # the kernel adds is not all zeros
    trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
    plain_model = VisionTransformer(cfg.replace(use_flash_attention=False), dtype=torch.bfloat16,
                                    device=dev, generator=gen)
    plain_model.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  ViT-B/16 224: {n_params} params, depth {cfg.depth}, {cfg.num_classes} classes",
          flush=True)

    bs, nb = 128, 4
    images = [torch.randint(0, 256, (bs, 224, 224, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(nb)]
    labels = [torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
              for _ in range(nb)]

    def batches():
        for u8, lbl in zip(images, labels):
            yield normalize(to_float(u8), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD), lbl

    FA.fused_qkv_attention.launches = 0
    metrics = evaluate(model, batches())
    torch.cuda.synchronize()
    launches = FA.fused_qkv_attention.launches
    print(f"  evaluate(): {json.dumps(metrics)}", flush=True)
    check(launches == cfg.depth * nb, f"K1 launched {launches} times, expected {cfg.depth * nb}")
    check(all(math.isfinite(v) for v in metrics.values()), "non-finite metric")

    fwd, plain_fwd = make_eval_forward(model), make_eval_forward(plain_model)
    x0 = next(batches())[0]
    logits, ref = fwd(x0), plain_fwd(x0)
    torch.cuda.synchronize()
    check(tuple(logits.shape) == (bs, cfg.num_classes) and logits.dtype == torch.float32,
          f"logits {tuple(logits.shape)} {logits.dtype}")
    check(torch.isfinite(logits).all().item(), "non-finite logits")
    diff = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"  logits kernel vs plain attention: max|diff|={diff:.3e}, max|logit|={scale:.3e}, "
          f"ratio {diff / scale:.3e} (bound {LOGIT_REL_BOUND})", flush=True)
    check(diff <= LOGIT_REL_BOUND * scale, "logits disagree with the plain-attention model")

    # metrics on the card against the same computation on the CPU, on
    # well-separated seeded logits (the random model's logits are all within
    # ~1e-3 of each other, where an ulp of softmax reorders AUROC ranks)
    lab = torch.randint(0, cfg.num_classes, (bs * nb,), generator=gen, device=dev)
    syn = torch.randn(bs * nb, cfg.num_classes, generator=gen, device=dev) * 2.0
    syn[torch.arange(bs * nb, device=dev), lab] += 2.0
    on_card = M.classification_metrics(syn, lab)
    on_cpu = M.classification_metrics(syn.cpu(), lab.cpu())
    for k in on_card:
        a, b = float(on_card[k]), float(on_cpu[k])
        check(abs(a - b) <= METRIC_ATOL + METRIC_RTOL * abs(b), f"metric {k}: card {a} vs cpu {b}")

    best, runs = in_turns({"plain": lambda: plain_fwd(x0), "kernel": lambda: fwd(x0)}, 5)
    rates = {name: [bs * 1000.0 / ms for ms in v] for name, v in runs.items()}
    print(f"  eval forward img/s at batch {bs}: kernel {rates['kernel']}, "
          f"plain attention {rates['plain']}", flush=True)
    return launches, best["kernel"]


def _rel_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)


def phase3(torch, FA, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    h, c, scale = 12, 768, 64**-0.5
    worst = 0.0
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), (197, 50)):
        tol = BWD_TOL[str(dtype).split(".")[1]]
        qkv = torch.randn(8, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(8, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        for has_bias, has_qvb, bounded in itertools.product((True, False), repeat=3):
            b_ = bias if has_bias else None
            q_ = qvb if has_qvb else None
            _, lse = FA.fused_qkv_attention(qkv, b_, q_, None, scale, h,
                                            bounded_scores=bounded, want_lse=True)
            got = FA.fused_qkv_attention_bwd(qkv, b_, q_, lse, g, scale, h)
            ref = FA.fused_qkv_attention_bwd_plain(qkv, b_, q_, lse, g, scale, h)
            torch.cuda.synchronize()
            check(got[0].dtype == dtype and got[0].shape == qkv.shape, "K2 dqkv dtype/shape")
            msg = []
            for name, a, r in zip(("dqkv", "dbias", "dqvb"), got, ref):
                check((a is None) == (r is None), f"K2 {name} presence differs from plain")
                if a is None:
                    continue
                check(torch.isfinite(a.float()).all().item(), f"K2 {name} is not finite")
                rel = _rel_err(a, r)
                abs_err = (a.float() - r.float()).abs().max().item()
                if name == "dqkv":
                    worst = max(worst, abs_err)
                msg.append(f"{name} max|d|={abs_err:.3e} rel={rel:.3e}")
                check(rel <= tol[name], f"K2 {name} disagrees with the plain version "
                      f"({str(dtype)[6:]} N={n} bias={has_bias:d} qv_bias={has_qvb:d} "
                      f"bounded={bounded:d}: rel {rel:.3e} > {tol[name]})")
            if has_qvb:
                check(torch.all(got[2][1] == 0).item(), "K2 dqvb has a nonzero k row")
            print(f"  K2 {str(dtype)[6:]} N={n} bias={has_bias:d} qv_bias={has_qvb:d} "
                  f"bounded={bounded:d}: " + ", ".join(msg), flush=True)

    # the Function (K1 fwd with lse + K2 bwd) against autograd through the
    # plain forward, f32, small N
    for n in (13, 50):
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        g = torch.randn(2, n, c, generator=gen, device=dev)
        leaves = [t.clone().requires_grad_() for t in (qkv, bias, qvb)]
        plain_leaves = [t.clone().requires_grad_() for t in (qkv, bias, qvb)]
        f0, b0 = FA.fused_qkv_attention.launches, FA.fused_qkv_attention_bwd.launches
        FA.fused_qkv_attention(*leaves, None, scale, h, bounded_scores=False).backward(g)
        check(FA.fused_qkv_attention.launches == f0 + 1
              and FA.fused_qkv_attention_bwd.launches == b0 + 1,
              "the autograd Function did not launch K1 and K2 once each")
        out, _ = FA.fused_qkv_attention_plain(*plain_leaves, scale, h, bounded_scores=False)
        out.backward(g)
        for name, a, r in zip(("qkv", "bias", "qv_bias"), leaves, plain_leaves):
            rel = _rel_err(a.grad, r.grad)
            print(f"  grad of {name} N={n}: Function vs autograd of plain rel={rel:.3e}",
                  flush=True)
            check(rel <= GRAD_REL_BOUND, f"Function grad of {name} disagrees ({rel:.3e})")
    # the dropout-mask replay: K2 and its plain version from the forward's seed
    seed = torch.tensor([0x0FEDCBA987654321], dtype=torch.int64, device=dev)
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), (197, 50)):
        tol = BWD_TOL[str(dtype).split(".")[1]]
        qkv = torch.randn(8, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(8, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        for has_bias, rate in itertools.product((True, False), (0.1, 0.3)):
            b_ = bias if has_bias else None
            _, lse = FA.fused_qkv_attention(qkv, b_, qvb, seed, scale, h, rate,
                                            bounded_scores=False, want_lse=True)
            got = FA.fused_qkv_attention_bwd(qkv, b_, qvb, lse, g, scale, h, seed=seed,
                                             dropout_rate=rate)
            ref = FA.fused_qkv_attention_bwd_plain(qkv, b_, qvb, lse, g, scale, h, seed=seed,
                                                   dropout_rate=rate)
            torch.cuda.synchronize()
            msg = []
            for name, a, r in zip(("dqkv", "dbias", "dqvb"), got, ref):
                check((a is None) == (r is None), f"K2 {name} presence differs from plain")
                if a is None:
                    continue
                check(torch.isfinite(a.float()).all().item(), f"K2 {name} is not finite")
                rel = _rel_err(a, r)
                if name == "dqkv":
                    worst = max(worst, (a.float() - r.float()).abs().max().item())
                msg.append(f"{name} rel={rel:.3e}")
                check(rel <= tol[name], f"K2 {name} with dropout {rate} disagrees with the plain "
                      f"version ({str(dtype)[6:]} N={n} bias={has_bias:d}: rel {rel:.3e} > "
                      f"{tol[name]})")
            print(f"  K2 dropout {rate} {str(dtype)[6:]} N={n} bias={has_bias:d}: "
                  + ", ".join(msg), flush=True)

    # Euler identity through the Function at rate 0.3 (f32): out is linear in
    # v through the dropped probabilities, so <df/dv, v> = 2f for f =
    # sum(out^2) exactly when K2 replays K1's mask
    for n in (50, 197):
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).requires_grad_()
        f0, b0 = FA.fused_qkv_attention.launches, FA.fused_qkv_attention_bwd.launches
        out = FA.fused_qkv_attention(qkv, None, None, seed, scale, h, 0.3, bounded_scores=False)
        f = (out.double() ** 2).sum()
        f.backward()
        check(FA.fused_qkv_attention.launches == f0 + 1
              and FA.fused_qkv_attention_bwd.launches == b0 + 1,
              "the autograd Function with dropout did not launch K1 and K2 once each")
        data = qkv.detach()
        inner = (qkv.grad[..., 2 * c:].double() * data[..., 2 * c:].double()).sum().item()
        rel = abs(inner - 2.0 * f.item()) / (2.0 * f.item())
        # the same backward from another seed than the forward's
        out2, lse = FA.fused_qkv_attention(data, None, None, seed, scale, h, 0.3,
                                           bounded_scores=False, want_lse=True)
        wrong = FA.fused_qkv_attention_bwd(data, None, None, lse, 2.0 * out2, scale, h,
                                           seed=seed + 1, dropout_rate=0.3)[0]
        inner_wrong = (wrong[..., 2 * c:].double() * data[..., 2 * c:].double()).sum().item()
        rel_wrong = abs(inner_wrong - 2.0 * f.item()) / (2.0 * f.item())
        print(f"  Euler identity N={n} rate 0.3: |<df/dv, v> - 2f| / 2f = {rel:.3e} with the "
              f"replayed mask, {rel_wrong:.3e} with another seed (bound {EULER_RTOL})", flush=True)
        check(rel <= EULER_RTOL, "K2 does not replay K1's dropout mask")
        check(rel_wrong > EULER_RTOL, "the Euler identity does not tell a wrong mask")

    # K2's own launcher stops at its limit; the routed call goes to K4 there
    # (phase 8 holds it against the plain version at N=577)
    try:
        big = torch.zeros(1, 577, 3 * c, device=dev, dtype=torch.bfloat16)
        FA._launch_bwd(big, None, None, torch.zeros(1, h, 577, device=dev),
                       big[..., :c].contiguous(), scale, h, True)
        check(False, "K2 took N=577, above its limit")
    except ValueError:
        pass
    check(FA.route(BIG_N[0] - 1) == "fused" and FA.route(BIG_N[0]) == "stream",
          "the route does not change kernels right above K2's limit")

    # train shape of ViT-B/16 224: B=160, N=197, bf16, bias, lse of a bounded
    # forward; turns plain, kernel, kernel, plain
    qkv = torch.randn(160, 197, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(160, 197, c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, 197, 197, generator=gen, device=dev) * 0.5
    _, lse = FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=True,
                                    want_lse=True)
    kern = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h)
    drop = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, seed=seed,
                                              dropout_rate=0.05)
    plain = lambda: FA.fused_qkv_attention_bwd_plain(qkv, bias, None, lse, g, scale, h)
    plain_drop = lambda: FA.fused_qkv_attention_bwd_plain(qkv, bias, None, lse, g, scale, h,
                                                          seed=seed, dropout_rate=0.05)
    for what, k_fn, p_fn in (("", kern, plain), (" dropout 0.05", drop, plain_drop)):
        got, ref = k_fn(), p_fn()
        for name, a, r in zip(("dqkv", "dbias"), got, ref):
            rel = _rel_err(a, r)
            if name == "dqkv":
                worst = max(worst, (a.float() - r.float()).abs().max().item())
            print(f"  K2 bfloat16 B=160 N=197 bias=1{what}: {name} rel={rel:.3e}", flush=True)
            check(rel <= BWD_TOL["bfloat16"][name],
                  f"K2 {name} disagrees at the train shape{what}")
    bound_ms, bound_by = bound(nbytes(qkv, g, lse, bias) + nbytes(qkv, bias),
                               10.0 * 160 * h * 197 * 197 * 64, "bfloat16")
    del got, ref
    # the library yardstick: autograd's backward of one
    # scaled_dot_product_attention call on the same inputs (dqkv and dbias)
    leaf = qkv.clone().requires_grad_()
    bias_leaf = bias.to(torch.bfloat16).requires_grad_()
    lib_out = sdpa_packed(torch, leaf, bias_leaf, scale, h)
    lib = lambda: torch.autograd.grad(lib_out, (leaf, bias_leaf), g, retain_graph=True)
    best, runs = in_turns({"plain": plain, "kernel": kern, "dropout 0.05": drop,
                           "bias copies rebuilt": bias_copies_rebuilt(FA, kern),
                           "library": lib}, 10)
    print(f"  K2 at B=160 N=197 H=12 D=64 bf16 (bias; \"kernel\" reuses the padded bias copies "
          f"of the call before, as every layer after a step's first does), ms per call: {runs}",
          flush=True)
    return {"max_abs_err": worst, "ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["library"], "bound_ms": bound_ms, "bound_by": bound_by,
            "other_ms": {"B=160 dropout 0.05": best["dropout 0.05"],
                         "B=160 bias copies rebuilt": best["bias copies rebuilt"]}}


def phase4(torch, FA, dev):
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.train.engine_finetune import (
        FinetuneHParams, init_finetune_state, make_finetune_train_step,
    )
    from uncertainty_vit_tpu_torch.train.optim import make_optimizer
    from uncertainty_vit_tpu_torch.train.schedules import cosine_schedule

    FA.BOUNDED_SCORES = True  # bench.py:187, as cli/finetune.py trains
    cfg = get_preset("beit_base_patch16_224", use_shared_rel_pos_bias=True,
                     drop_path_rate=0.1, init_values=0.1)
    gen = torch.Generator(device=dev).manual_seed(2)
    bs = 160
    images = torch.randn(bs, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
    hp = FinetuneHParams(num_classes=cfg.num_classes)
    lr = cosine_schedule(4e-3, 1e-6, 10_000, warmup_steps=500)

    def build(flash: bool, state_dict=None, **overrides):
        c = cfg.replace(use_flash_attention=flash, **overrides)
        model = VisionTransformer(c, dtype=torch.bfloat16, device=dev, generator=gen)
        if state_dict is None:
            # the reference zero-initializes the rel-pos table; draw it so the
            # bias the kernels add and differentiate is not all zeros
            trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
        else:
            model.load_state_dict(state_dict)
        opt = make_optimizer(model, weight_decay=0.05, layer_decay=0.65, depth=c.depth)
        step = make_finetune_train_step(model, opt, hp, lr)
        return model, init_finetune_state(model, opt), step

    model, state, step = build(True)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    plain_model, plain_state, plain_step = build(False, init)
    print(f"  ViT-B/16 224: {sum(p.numel() for p in model.parameters())} params, "
          f"batch {bs}", flush=True)

    def gens(seed):
        return (torch.Generator(device=dev).manual_seed(seed),
                torch.Generator().manual_seed(seed))

    # one step from the same weights and seeds on both attention paths
    m_k = step(state, images, labels, *gens(10))
    m_p = plain_step(plain_state, images, labels, *gens(10))
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
    print(f"  step 0 kernel vs plain attention: loss {loss_k:.6f} / {loss_p:.6f}, "
          f"grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
    check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p), "loss disagrees with plain path")
    check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
          "grad norm disagrees with the plain path")

    # the main path: 3 steps, counts set to 0 just before and read just after
    n_steps = 3
    FA.fused_qkv_attention.launches = 0
    FA.fused_qkv_attention_bwd.launches = 0
    metrics = [step(state, images, labels, *gens(11 + i)) for i in range(n_steps)]
    torch.cuda.synchronize()
    launches = {"fwd": FA.fused_qkv_attention.launches, "bwd": FA.fused_qkv_attention_bwd.launches}
    print(f"  {n_steps} steps: launches {launches}; " + "; ".join(
        f"loss {float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f} "
        f"acc {float(m['class_acc']):.4f} lr {m['lr']:.3e}" for m in metrics), flush=True)
    for k in ("fwd", "bwd"):
        check(launches[k] == cfg.depth * n_steps,
              f"K{1 if k == 'fwd' else 2} launched {launches[k]} times in {n_steps} steps, "
              f"expected {cfg.depth * n_steps}")
    check(all(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))
              for m in metrics), "non-finite loss or grad norm")
    moved = 0
    for k, v in model.state_dict().items():
        check(torch.isfinite(v).all().item(), f"non-finite parameter {k}")
        moved += int(not torch.equal(v, init[k]))
    print(f"  parameters changed: {moved} of {len(init)} tensors", flush=True)
    check(moved == len(init), "some parameters did not change")

    rates = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        st, fn = (state, step) if name == "kernel" else (plain_state, plain_step)
        g = gens(20)
        ms = cuda_ms(lambda: fn(st, images, labels, *g), 5)
        rates[name].append(bs * 1000.0 / ms)
    print(f"  train step img/s at batch {bs} (information only): kernel {rates['kernel']}, "
          f"plain attention {rates['plain']}", flush=True)
    del plain_model, plain_state, plain_step

    # one step with attention dropout 0.05 (the cyclical pretraining recipe's
    # rate): K1 draws the mask in the forward, K2 replays it
    drop_model, drop_state, drop_step = build(True, init, attn_drop_rate=0.05)
    drop_state.step = 1  # the warm-up's learning rate is 0 at update 0
    FA.fused_qkv_attention.launches = 0
    FA.fused_qkv_attention_bwd.launches = 0
    m = drop_step(drop_state, images, labels, *gens(30))
    torch.cuda.synchronize()
    drop_launches = {"fwd": FA.fused_qkv_attention.launches,
                     "bwd": FA.fused_qkv_attention_bwd.launches}
    print(f"  1 step with attn_drop_rate=0.05: launches {drop_launches}; loss "
          f"{float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f}", flush=True)
    check(drop_launches == {"fwd": cfg.depth, "bwd": cfg.depth},
          f"the attention-dropout step launched {drop_launches}, expected {cfg.depth} each")
    check(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"])),
          "non-finite loss or grad norm with attention dropout")
    moved = sum(int(not torch.equal(v, init[k])) for k, v in drop_model.state_dict().items())
    check(moved == len(init), "some parameters did not change in the attention-dropout step")
    # the same step from the same weights and seeds with the attention on its
    # plain versions, which draw the masks K1 drew and K2 replayed
    _, ref_state, ref_step = build(True, init, attn_drop_rate=0.05)
    ref_state.step = 1
    with attention_on_plain(torch, FA):
        m_ref = ref_step(ref_state, images, labels, *gens(30))
    torch.cuda.synchronize()
    check(FA.fused_qkv_attention.launches == cfg.depth
          and FA.fused_qkv_attention_bwd.launches == cfg.depth,
          "the plain-attention reference step launched a kernel")
    loss_k, loss_p = float(m["loss"]), float(m_ref["loss"])
    gn_k, gn_p = float(m["grad_norm"]), float(m_ref["grad_norm"])
    print(f"  attention-dropout step, kernels vs plain versions with the same masks: loss "
          f"{loss_k:.6f} / {loss_p:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
    check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
          "the attention-dropout step's loss disagrees with the plain versions'")
    check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
          "the attention-dropout step's grad norm disagrees with the plain versions'")
    return launches, drop_launches


def phase5(torch, dev):
    from uncertainty_vit_tpu_torch.ops import dropout as DO

    gen = torch.Generator(device=dev).manual_seed(3)
    seed = torch.tensor([0x00C0FFEE12345678], dtype=torch.int64, device=dev)
    base = torch.randn(8 * 197 * 768 + 8, generator=gen, device=dev)
    worst = 0.0
    cases = {"[8*197, 768]": base[:8 * 197 * 768].reshape(8 * 197, 768),
             "[3, 50, 64]": base[:3 * 50 * 64].reshape(3, 50, 64),
             "[1001] ragged": base[:1001],
             "[1001] misaligned": base[1:1002]}
    for dtype, rate in itertools.product((torch.bfloat16, torch.float32), (0.1, 0.5)):
        for name, x in cases.items():
            x = x.to(dtype)
            if "misaligned" in name:  # a contiguous view that starts off a 16-byte boundary
                x = torch.cat([x[:1], x])[1:]
                check(x.data_ptr() % 16 != 0 and x.is_contiguous(), "the view is aligned")
            got = DO.fused_dropout(x, rate, seed)
            ref = DO.fused_dropout_plain(x, rate, seed)
            torch.cuda.synchronize()
            worst = max(worst, (got.float() - ref.float()).abs().max().item())
            kept = (got != 0).float().mean().item()
            print(f"  K8 {str(dtype)[6:]} rate {rate} {name}: equal to the bit "
                  f"{torch.equal(got, ref)}, kept {kept:.4f}", flush=True)
            check(got.dtype == x.dtype and got.shape == x.shape, "K8 dtype/shape")
            check(torch.equal(got, ref), f"K8 differs from its plain version ({name})")
    x = cases["[8*197, 768]"]
    check(DO.fused_dropout(x, 0.0, seed) is x, "K8 at rate 0 does not return x itself")
    check(not torch.equal(DO.fused_dropout(x, 0.1, seed), DO.fused_dropout(x, 0.1, seed + 1)),
          "K8 draws one mask from two seeds")
    for bad in (x.t(), x.to(torch.float16)):
        try:
            DO.fused_dropout(bad, 0.1, seed)
            check(False, "K8 took a tensor it does not support")
        except ValueError:
            pass

    # the MC-dropout shape: K=8 samples of batch 128 folded, N=197, C=768
    x = torch.randn(1024 * 197, 768, generator=gen, device=dev).to(torch.bfloat16)
    kern = lambda: DO.fused_dropout(x, 0.1, seed)
    plain = lambda: DO.fused_dropout_plain(x, 0.1, seed)
    lib = lambda: torch.nn.functional.dropout(x, 0.1, training=True)
    got, ref = kern(), plain()
    worst = max(worst, (got.float() - ref.float()).abs().max().item())
    check(torch.equal(got, ref), "K8 differs from its plain version at the MC-dropout shape")
    del got, ref
    best, runs = in_turns({"plain": plain, "kernel": kern, "library": lib}, 10)
    bound_ms, bound_by = bound(2 * nbytes(x), float(x.numel()), "float32")
    print(f"  K8 at [1024*197, 768] bf16 rate 0.1, ms per call: {runs}; bound {bound_ms:.4f} ms",
          flush=True)
    return {"max_abs_err": worst, "ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["library"], "bound_ms": bound_ms, "bound_by": bound_by}


def phase6(torch, FA, dev, det_ms_per_128):
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals.classification import (
        evaluate_ensemble, evaluate_mc_dropout,
    )
    from uncertainty_vit_tpu_torch.evals.ensembles import stack_params
    from uncertainty_vit_tpu_torch.evals.mc_dropout import (
        make_mc_dropout_forward, make_mc_dropout_mean_forward,
    )
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import dropout as DO

    FA.BOUNDED_SCORES = True  # cli/finetune.py evaluates with the bounded softmax
    # the MC-dropout bench's setup (tools/bench_mc_dropout.py:72-79): K=8
    # samples of batch 128, drop_rate 0.1, no drop-path, split at block 9
    k, bs, nb, split = 8, 128, 2, 9
    cfg = get_preset("beit_base_patch16_224", use_shared_rel_pos_bias=True, drop_path_rate=0.0,
                     drop_rate=0.1, init_values=0.1)
    gen = torch.Generator(device=dev).manual_seed(4)
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
    # the head's init std of 0.02 leaves logits of ~1e-2; a wider head makes
    # the samples' spread and the (a)/(b) comparison visible
    trunc_normal(0.1, 2.0)(model.head.weight, gen)
    split_model = VisionTransformer(cfg.replace(dropout_from_block=split), dtype=torch.bfloat16,
                                    device=dev, generator=gen)
    split_model.load_state_dict(model.state_dict())
    images = [torch.randn(bs, 224, 224, 3, generator=gen, device=dev) for _ in range(nb)]
    labels = [torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
              for _ in range(nb)]
    batches = list(zip(images, labels))

    def counts():
        return {"K1": FA.fused_qkv_attention.launches, "K2": FA.fused_qkv_attention_bwd.launches,
                "K8": DO.fused_dropout.launches}

    def reset():
        FA.fused_qkv_attention.launches = FA.fused_qkv_attention_bwd.launches = 0
        DO.fused_dropout.launches = 0

    launches = {}
    for name, mdl, split_at, k8_per_fwd in (("folded", model, 0, 2 * cfg.depth),
                                            ("split", split_model, split,
                                             2 * (cfg.depth - split))):
        reset()
        metrics = evaluate_mc_dropout(mdl, batches, num_samples=k, seed=0, split_at=split_at)
        torch.cuda.synchronize()
        launches[name] = counts()
        print(f"  evaluate_mc_dropout {name} (split_at={split_at}): launches {launches[name]}; "
              f"{json.dumps(metrics)}", flush=True)
        check(launches[name] == {"K1": cfg.depth * nb, "K2": 0, "K8": k8_per_fwd * nb},
              f"{name}: launches {launches[name]}, expected K1 {cfg.depth * nb}, K2 0, "
              f"K8 {k8_per_fwd * nb}")
        check(all(math.isfinite(v) for v in metrics.values()), f"{name}: non-finite metric")
        again = evaluate_mc_dropout(mdl, batches, num_samples=k, seed=0, split_at=split_at)
        # the logits are bit-identical from one seed (checked below); the
        # metric sums on the card use atomics, whose order varies
        for key, v in metrics.items():
            check(abs(again[key] - v) <= METRIC_ATOL + METRIC_RTOL * abs(v),
                  f"{name}: {key} is {v} and then {again[key]} from the same seed")

    def dev_gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    x0 = images[0]
    folded = make_mc_dropout_forward(model, k)
    logits = folded(x0, dev_gen(5))
    check(tuple(logits.shape) == (k, bs, cfg.num_classes) and logits.dtype == torch.float32,
          f"MC logits {tuple(logits.shape)} {logits.dtype}")
    check(torch.isfinite(logits).all().item(), "non-finite MC logits")
    spread = (logits - logits.mean(0)).abs().max().item()
    scale = logits.abs().max().item()
    print(f"  folded [K, B, C] logits: max|logit|={scale:.3e}, max|sample - mean|={spread:.3e}",
          flush=True)
    check(all(not torch.equal(logits[0], logits[i]) for i in range(1, k)),
          "MC samples do not differ from one another")
    check(torch.equal(logits, folded(x0, dev_gen(5))),
          "the MC logits are not bit-identical from the same generator seed")
    check(not torch.equal(logits, folded(x0, dev_gen(6))), "another seed gives the same logits")
    # K1 at the folded batch of 1024 inside the model, against the same
    # forward (same seed, K8's masks the same) with the attention on its plain
    # version
    with attention_on_plain(torch, FA):
        ref = folded(x0, dev_gen(5))
    diff = (logits - ref).abs().max().item()
    print(f"  folded forward, K1 vs its plain version: max|diff|={diff:.3e}, ratio "
          f"{diff / ref.abs().max().item():.3e} (bound {LOGIT_REL_BOUND})", flush=True)
    check(diff <= LOGIT_REL_BOUND * ref.abs().max().item(),
          "the folded MC forward disagrees with the same forward on the plain attention")

    # (b) against the folded forward of the same model and seed: exact
    # MC-dropout, since the shared blocks carry no dropout; only the batch the
    # shared blocks' GEMMs run at differs
    split_logits = make_mc_dropout_forward(split_model, k, split_at=split)(x0, dev_gen(7))
    ref = make_mc_dropout_forward(split_model, k)(x0, dev_gen(7))
    diff = (split_logits - ref).abs().max().item()
    ref_scale = ref.abs().max().item()
    print(f"  split-trunk vs folded forward of the same model and seed: max|diff|={diff:.3e}, "
          f"max|logit|={ref_scale:.3e}, ratio {diff / ref_scale:.3e} (bound {LOGIT_REL_BOUND})",
          flush=True)
    check(diff <= LOGIT_REL_BOUND * ref_scale, "the split-trunk forward disagrees with the folded")

    # metrics on the card against a CPU recomputation from the mean logits
    mean_fwd = make_mc_dropout_mean_forward(model, k)
    mean_logits = torch.cat([mean_fwd(x, dev_gen(8 + i)) for i, x in enumerate(images)])
    lab = torch.cat(labels)
    on_card = M.classification_metrics(mean_logits, lab)
    on_cpu = M.classification_metrics(mean_logits.cpu(), lab.cpu())
    for name in on_card:
        a, b = float(on_card[name]), float(on_cpu[name])
        check(abs(a - b) <= METRIC_ATOL + METRIC_RTOL * abs(b),
              f"MC metric {name}: card {a} vs cpu {b}")

    # attention dropout through the model: K1's in-kernel mask
    attn_model = VisionTransformer(cfg.replace(attn_drop_rate=0.1), dtype=torch.bfloat16,
                                   device=dev, generator=gen)
    attn_model.load_state_dict(model.state_dict())
    attn_fwd = make_mc_dropout_forward(attn_model, 2)
    reset()
    a1 = attn_fwd(x0, dev_gen(9))
    launches["attn_drop"] = counts()
    check(launches["attn_drop"] == {"K1": cfg.depth, "K2": 0, "K8": 2 * cfg.depth},
          f"attention-dropout forward: launches {launches['attn_drop']}")
    check(torch.isfinite(a1).all().item() and not torch.equal(a1[0], a1[1]),
          "attention-dropout samples are not finite or do not differ")
    check(torch.equal(a1, attn_fwd(x0, dev_gen(9))),
          "attention-dropout logits are not reproducible from the seed")
    check(not torch.equal(a1, make_mc_dropout_forward(model, 2)(x0, dev_gen(9))),
          "attention dropout 0.1 changes nothing")
    with attention_on_plain(torch, FA):
        a_ref = attn_fwd(x0, dev_gen(9))
    diff = (a1 - a_ref).abs().max().item()
    print(f"  one K=2 forward with attn_drop_rate=0.1: launches {launches['attn_drop']}; K1's "
          f"dropout vs its plain version with the same masks: max|diff|={diff:.3e}, ratio "
          f"{diff / a_ref.abs().max().item():.3e} (bound {LOGIT_REL_BOUND})", flush=True)
    check(diff <= LOGIT_REL_BOUND * a_ref.abs().max().item(),
          "the attention-dropout forward disagrees with the plain attention of the same masks")
    del attn_model

    # a 2-member ensemble at full depth on one batch
    det_cfg = cfg.replace(drop_rate=0.0)
    member = VisionTransformer(det_cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    stacked = stack_params([model.state_dict(), member.state_dict()])
    reset()
    ens = evaluate_ensemble(member, stacked, batches[:1])
    launches["ensemble"] = counts()
    print(f"  evaluate_ensemble (2 members, 1 batch): launches {launches['ensemble']}; ensemble "
          f"{json.dumps(ens['ensemble'])}", flush=True)
    check(launches["ensemble"] == {"K1": 2 * cfg.depth, "K2": 0, "K8": 0},
          f"ensemble launches {launches['ensemble']}")
    check(len(ens["members"]) == 2 and all(
        math.isfinite(v) for m in ens["members"] + [ens["ensemble"]] for v in m.values()),
          "ensemble metrics are not finite")
    check(ens["members"][0] != ens["members"][1], "the two members give the same metrics")
    del member, stacked

    # ms per K*B pass, and its ratio to the deterministic forward at batch 128
    split_fwd = make_mc_dropout_mean_forward(split_model, k, split_at=split)
    g = dev_gen(10)
    best, runs = in_turns({"folded": lambda: mean_fwd(x0, g),
                           "split": lambda: split_fwd(x0, g)}, 3)
    print(f"  MC-dropout K={k} of batch {bs} (information only), ms per K*B pass: {runs}; "
          f"deterministic forward {det_ms_per_128:.2f} ms per {bs}; pass-equivalents: folded "
          f"{best['folded'] / det_ms_per_128:.2f}, split at {split} "
          f"{best['split'] / det_ms_per_128:.2f}; img/s folded {bs * 1000 / best['folded']:.1f}, "
          f"split {bs * 1000 / best['split']:.1f}", flush=True)
    return launches


def attention_counts(FA) -> dict:
    return {"K1": FA.fused_qkv_attention.launches, "K2": FA.fused_qkv_attention_bwd.launches,
            "K3": FA.fused_qkv_attention.stream_launches,
            "K4": FA.fused_qkv_attention_bwd.stream_launches}


def reset_attention_counts(FA) -> None:
    FA.fused_qkv_attention.launches = FA.fused_qkv_attention_bwd.launches = 0
    FA.fused_qkv_attention.stream_launches = FA.fused_qkv_attention_bwd.stream_launches = 0


def plain_fwd_sliced(torch, FA, qkv, bias, qvb, scale, h, bounded, seed, rate, step=4):
    """The forward's plain version `step` images at a time (a [B, H, N, N]
    f32 tensor is 67 MB per image at N=1025, H=16), each slice with the mask
    of its place in the batch."""
    parts = [FA.stream_fwd_plain(qkv[i:i + step], bias, qvb, scale, h, bounded_scores=bounded,
                                 seed=seed, dropout_rate=rate, image0=i)
             for i in range(0, qkv.shape[0], step)]
    return torch.cat([o for o, _ in parts]), torch.cat([l for _, l in parts])


def plain_bwd_sliced(torch, FA, qkv, bias, qvb, lse, g, scale, h, seed, rate, step=2):
    """K4's two plain versions `step` images at a time: (dq, dk, dv, dbias
    summed over the slices, c)."""
    dq, dk, dv, cs, dbias = [], [], [], [], None
    for i in range(0, qkv.shape[0], step):
        sl = slice(i, i + step)
        dq_i, db_i, c_i = FA.stream_bwd_dq_plain(qkv[sl], bias, qvb, lse[sl], g[sl], scale, h,
                                                 seed=seed, dropout_rate=rate, image0=i)
        dk_i, dv_i = FA.stream_bwd_dkv_plain(qkv[sl], bias, qvb, lse[sl], c_i, g[sl], scale, h,
                                             seed=seed, dropout_rate=rate, image0=i)
        dq.append(dq_i), dk.append(dk_i), dv.append(dv_i), cs.append(c_i)
        if db_i is not None:
            dbias = db_i if dbias is None else dbias + db_i
    return torch.cat(dq), torch.cat(dk), torch.cat(dv), dbias, torch.cat(cs)


def phase7(torch, FA, dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    h, c, scale = 16, 1024, 64**-0.5
    seed = torch.tensor([0x0123456789ABCDEF], dtype=torch.int64, device=dev)
    worst, n_cases = 0.0, 0
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), BIG_N):
        name = str(dtype)[6:]
        tol = OUT_TOL[name]
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        check(FA.route(n) == "stream", f"N={n} does not take the streaming route")
        for has_bias, has_qvb, bounded, rate in itertools.product(
                (True, False), (True, False), (True, False), (0.0, 0.1)):
            b_ = bias if has_bias else None
            q_ = qvb if has_qvb else None
            sd = seed if rate > 0.0 else None
            before = attention_counts(FA)
            out, lse = FA.fused_qkv_attention(qkv, b_, q_, sd, scale, h, rate,
                                              bounded_scores=bounded, want_lse=True)
            out_only = FA.fused_qkv_attention(qkv, b_, q_, sd, scale, h, rate,
                                              bounded_scores=bounded)
            after = attention_counts(FA)
            check(after["K3"] == before["K3"] + 2 and after["K1"] == before["K1"],
                  f"the routed forward at N={n} did not launch K3 twice and K1 never")
            ref, ref_lse = FA.stream_fwd_plain(qkv, b_, q_, scale, h, bounded_scores=bounded,
                                               seed=sd, dropout_rate=rate)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            worst, n_cases = max(worst, err), n_cases + 1
            msg = (f"  K3 {name} N={n} bias={has_bias:d} qv_bias={has_qvb:d} bounded={bounded:d} "
                   f"dropout {rate}: max|out-plain|={err:.3e} max|lse-plain|={lse_err:.3e}")
            check(torch.isfinite(out.float()).all().item(), "K3 output is not finite")
            check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
                  f"K3 output disagrees with the plain version ({msg})")
            check(lse_err <= LSE_ATOL, f"K3 lse disagrees with the plain version ({msg})")
            check(torch.equal(out, out_only), "K3 output depends on want_lse")
            if rate > 0.0:  # the lse is the undropped softmax's, to the bit
                _, lse0 = FA.fused_qkv_attention(qkv, b_, q_, None, scale, h, 0.0,
                                                 bounded_scores=bounded, want_lse=True)
                check(torch.equal(lse, lse0), "K3's lse changes with dropout")
            if has_bias and has_qvb:
                print(msg, flush=True)
        del qkv, bias, out, lse, ref, ref_lse
    print(f"  K3: {n_cases} cases within the K1 tolerances, worst max|out-plain| {worst:.3e}",
          flush=True)

    # the L/512 eval shape: B=16, N=1025, H=16, bf16, bias, bounded scores; the
    # train step gives K3 the first half of it and asks for the lse
    bsz, train_bsz, n = 16, 8, 1025
    qkv = torch.randn(bsz, n, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
    bias_cast = bias.to(torch.bfloat16)
    fns = {
        "plain": lambda: plain_fwd_sliced(torch, FA, qkv, bias, None, scale, h, True, None, 0.0),
        "kernel": lambda: FA.fused_qkv_attention(qkv, bias, None, None, scale, h,
                                                 bounded_scores=True),
        f"train B={train_bsz} with lse": lambda: FA.fused_qkv_attention(
            qkv[:train_bsz], bias, None, None, scale, h, bounded_scores=True, want_lse=True),
        "no bias": lambda: FA.fused_qkv_attention(qkv, None, None, None, scale, h,
                                                  bounded_scores=True),
        "with lse": lambda: FA.fused_qkv_attention(qkv, bias, None, None, scale, h,
                                                   bounded_scores=True, want_lse=True),
        "dropout 0.1": lambda: FA.fused_qkv_attention(qkv, bias, None, seed, scale, h, 0.1,
                                                      bounded_scores=True),
        "K1": lambda: FA._launch(qkv, bias, None, scale, h, True, False),
        "library": lambda: sdpa_packed(torch, qkv, bias_cast, scale, h),
    }
    ref, ref_lse = fns["plain"]()
    ref = ref.float()
    tol = OUT_TOL["bfloat16"]
    for what in ("kernel", "K1"):
        got = fns[what]()
        got = (got[0] if isinstance(got, tuple) else got).float()  # K1's launcher: (out, None)
        err = (got - ref).abs().max().item()
        worst = max(worst, err) if what != "K1" else worst
        print(f"  {what} at B={bsz} N={n} H={h} bf16 bias=1 bounded=1: max|out-plain|={err:.3e}",
              flush=True)
        check(torch.allclose(got, ref, atol=tol, rtol=tol),
              f"{what} disagrees with the plain version at the L/512 eval shape ({err:.3e})")
    got, got_lse = fns[f"train B={train_bsz} with lse"]()
    err = (got.float() - ref[:train_bsz]).abs().max().item()
    lse_err = (got_lse - ref_lse[:train_bsz]).abs().max().item()
    worst = max(worst, err)
    print(f"  kernel at the train step's B={train_bsz} with the lse: max|out-plain|={err:.3e} "
          f"max|lse-plain|={lse_err:.3e}", flush=True)
    check(torch.allclose(got.float(), ref[:train_bsz], atol=tol, rtol=tol)
          and lse_err <= LSE_ATOL,
          "K3 disagrees with the plain version at the L/512 train shape")
    del got_lse, ref_lse
    got = fns["dropout 0.1"]().float()
    ref_d = plain_fwd_sliced(torch, FA, qkv, bias, None, scale, h, True, seed, 0.1)[0].float()
    err = (got - ref_d).abs().max().item()
    worst = max(worst, err)
    print(f"  kernel with dropout 0.1 at the same shape: max|out-plain|={err:.3e}", flush=True)
    check(torch.allclose(got, ref_d, atol=tol, rtol=tol),
          "K3 with dropout disagrees with the plain version at the L/512 eval shape")
    del got, ref, ref_d
    best, runs = in_turns(fns, 10)
    print(f"  K3 at B={bsz} N={n} H={h} D=64 bf16 (bias, bounded), ms per call: {runs}",
          flush=True)
    bound_ms, bound_by = bound(nbytes(qkv, bias) + qkv.numel() // 3 * 2,
                               4.0 * bsz * h * n * n * 64, "bfloat16")
    return {"max_abs_err": worst, "ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["library"], "bound_ms": bound_ms, "bound_by": bound_by,
            "other_ms": {k: best[k] for k in (f"train B={train_bsz} with lse", "no bias",
                                              "with lse", "dropout 0.1", "K1")}}


def phase8(torch, FA, dev):
    gen = torch.Generator(device=dev).manual_seed(8)
    h, c, scale = 16, 1024, 64**-0.5
    seed = torch.tensor([0x0FEDCBA987654321], dtype=torch.int64, device=dev)
    worst, n_cases = 0.0, 0

    def held(tag, got, ref, tol):
        """got = (dqkv, dbias, dqvb) of the routed call, ref = (dq, dk, dv,
        dbias) of the two plain versions; each part against its bound
        relative to max|plain|. Returns the largest absolute error of dqkv."""
        dqkv, dbias, dqvb = got
        cc = dqkv.shape[-1] // 3
        parts = {"dq": (dqkv[..., :cc], ref[0], tol["dqkv"]),
                 "dk": (dqkv[..., cc:2 * cc], ref[1], tol["dqkv"]),
                 "dv": (dqkv[..., 2 * cc:], ref[2], tol["dqkv"])}
        check((dbias is None) == (ref[3] is None), f"K4 dbias presence differs from plain ({tag})")
        if dbias is not None:
            parts["dbias"] = (dbias, ref[3], tol["dbias"])
        if dqvb is not None:
            parts["dqvb"] = (dqvb, FA.reduce_qv_bias_grad(torch.cat(ref[:3], dim=-1)), tol["dqvb"])
            check(torch.all(dqvb[1] == 0).item(), f"K4 dqvb has a nonzero k row ({tag})")
        msg, abs_err = [], 0.0
        for name, (a, r, bound_) in parts.items():
            check(torch.isfinite(a.float()).all().item(), f"K4 {name} is not finite ({tag})")
            rel = _rel_err(a, r)
            if name in ("dq", "dk", "dv"):
                abs_err = max(abs_err, (a.float() - r.float()).abs().max().item())
            msg.append(f"{name} rel={rel:.3e}")
            check(rel <= bound_, f"K4 {name} disagrees with its plain version ({tag}: rel "
                  f"{rel:.3e} > {bound_})")
        return abs_err, ", ".join(msg)

    for dtype, n in itertools.product((torch.bfloat16, torch.float32), BIG_N):
        name = str(dtype)[6:]
        tol = BWD_TOL[name]
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        for has_bias, has_qvb, bounded, rate in itertools.product(
                (True, False), (True, False), (True, False), (0.0, 0.1)):
            b_ = bias if has_bias else None
            q_ = qvb if has_qvb else None
            sd = seed if rate > 0.0 else None
            _, lse = FA.fused_qkv_attention(qkv, b_, q_, sd, scale, h, rate,
                                            bounded_scores=bounded, want_lse=True)
            before = attention_counts(FA)
            got = FA.fused_qkv_attention_bwd(qkv, b_, q_, lse, g, scale, h, seed=sd,
                                             dropout_rate=rate)
            after = attention_counts(FA)
            check(after["K4"] == before["K4"] + 1 and after["K2"] == before["K2"],
                  f"the routed backward at N={n} did not launch K4 once and K2 never")
            ref = plain_bwd_sliced(torch, FA, qkv, b_, q_, lse, g, scale, h, sd, rate)
            torch.cuda.synchronize()
            tag = (f"{name} N={n} bias={has_bias:d} qv_bias={has_qvb:d} bounded={bounded:d} "
                   f"dropout {rate}")
            check(got[0].dtype == dtype and got[0].shape == qkv.shape, "K4 dqkv dtype/shape")
            abs_err, msg = held(tag, got, ref, tol)
            worst, n_cases = max(worst, abs_err), n_cases + 1
            if has_bias and has_qvb:
                print(f"  K4 {tag}: {msg}", flush=True)
            again = FA.fused_qkv_attention_bwd(qkv, b_, q_, lse, g, scale, h, seed=sd,
                                               dropout_rate=rate)
            check(torch.equal(got[0], again[0]), f"K4's dqkv differs between two runs ({tag})")
        del qkv, g, bias, got, again, ref
    print(f"  K4: {n_cases} cases within K2's bounds, dqkv bit-identical between two runs, "
          f"worst max|dqkv-plain| {worst:.3e}", flush=True)

    # ragged tails feed dk and dv: the same call with NaN planted right before
    # and right behind qkv, g and the lse gives the same bits
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), (577, 1025)):
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5

        def fenced(t):
            buf = torch.full((t.numel() + 256,), float("nan"), dtype=t.dtype, device=dev)
            view = buf[128:128 + t.numel()].view(t.shape)
            view.copy_(t)
            check(view.data_ptr() % 16 == 0 and torch.isnan(buf[:128].float()).all().item()
                  and torch.isnan(buf[-128:].float()).all().item(), "the NaN fence is not there")
            return view

        out, lse = FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=False,
                                          want_lse=True)
        got = FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h)
        f_qkv, f_g, f_lse = fenced(qkv), fenced(g), fenced(lse)
        f_out, f_lse_out = FA.fused_qkv_attention(f_qkv, bias, None, None, scale, h,
                                                  bounded_scores=False, want_lse=True)
        f_got = FA.fused_qkv_attention_bwd(f_qkv, bias, None, f_lse, f_g, scale, h)
        torch.cuda.synchronize()
        check(torch.equal(out, f_out) and torch.equal(lse, f_lse_out),
              f"K3 reads behind the end of qkv ({str(dtype)[6:]} N={n})")
        check(torch.isfinite(f_got[0].float()).all().item() and torch.equal(got[0], f_got[0]),
              f"K4 reads behind the end of qkv, g or lse ({str(dtype)[6:]} N={n})")
        check(torch.isfinite(f_got[1]).all().item(), "K4's dbias is not finite behind a NaN fence")
        print(f"  K3/K4 {str(dtype)[6:]} N={n}: NaN planted around qkv, g and lse changes no bit "
              f"of out, lse and dqkv", flush=True)
        del qkv, g, bias, got, f_got, f_qkv, f_g

    # the Function through the streaming route (K3 + K4, f32) against autograd
    # through the plain forward
    n = 257
    qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev)
    bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
    qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
    g = torch.randn(2, n, c, generator=gen, device=dev)
    leaves = [t.clone().requires_grad_() for t in (qkv, bias, qvb)]
    plain_leaves = [t.clone().requires_grad_() for t in (qkv, bias, qvb)]
    before = attention_counts(FA)
    FA.fused_qkv_attention(*leaves, None, scale, h, bounded_scores=False).backward(g)
    after = attention_counts(FA)
    check({k: after[k] - before[k] for k in after} == {"K1": 0, "K2": 0, "K3": 1, "K4": 1},
          "the autograd Function at N=257 did not launch K3 and K4 once each")
    out, _ = FA.stream_fwd_plain(*plain_leaves, scale, h, bounded_scores=False)
    out.backward(g)
    for name, a, r in zip(("qkv", "bias", "qv_bias"), leaves, plain_leaves):
        rel = _rel_err(a.grad, r.grad)
        print(f"  grad of {name} N={n}: Function (K3 + K4) vs autograd of plain rel={rel:.3e}",
              flush=True)
        check(rel <= GRAD_REL_BOUND, f"Function grad of {name} disagrees at N={n} ({rel:.3e})")
    del leaves, plain_leaves, out

    # Euler identity through the Function at rate 0.3 (f32): <df/dv, v> = 2f
    # for f = sum(out^2) exactly when K4's two kernels replay K3's mask
    for n in (257, 577):
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).requires_grad_()
        out = FA.fused_qkv_attention(qkv, None, None, seed, scale, h, 0.3, bounded_scores=False)
        f = (out.double() ** 2).sum()
        f.backward()
        data = qkv.detach()
        inner = (qkv.grad[..., 2 * c:].double() * data[..., 2 * c:].double()).sum().item()
        rel = abs(inner - 2.0 * f.item()) / (2.0 * f.item())
        out2, lse = FA.fused_qkv_attention(data, None, None, seed, scale, h, 0.3,
                                           bounded_scores=False, want_lse=True)
        wrong = FA.fused_qkv_attention_bwd(data, None, None, lse, 2.0 * out2, scale, h,
                                           seed=seed + 1, dropout_rate=0.3)[0]
        inner_wrong = (wrong[..., 2 * c:].double() * data[..., 2 * c:].double()).sum().item()
        rel_wrong = abs(inner_wrong - 2.0 * f.item()) / (2.0 * f.item())
        print(f"  Euler identity N={n} rate 0.3: |<df/dv, v> - 2f| / 2f = {rel:.3e} with the "
              f"replayed mask, {rel_wrong:.3e} with another seed (bound {EULER_RTOL})", flush=True)
        check(rel <= EULER_RTOL, "K4 does not replay K3's dropout mask")
        check(rel_wrong > EULER_RTOL, "the Euler identity does not tell a wrong mask")
        del qkv, out, out2, wrong

    # the L/512 train shape: B=8, N=1025, H=16, bf16, bias, lse of a bounded
    # forward
    bsz, n = 8, 1025
    qkv = torch.randn(bsz, n, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(bsz, n, c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
    _, lse = FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=True,
                                    want_lse=True)
    kern = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h)
    no_dbias = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h,
                                                  want_dbias=False)
    drop = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, seed=seed,
                                              dropout_rate=0.05)
    plain = lambda: plain_bwd_sliced(torch, FA, qkv, bias, None, lse, g, scale, h, None, 0.0)
    for what, k_fn, rate in (("", kern, 0.0), (" dropout 0.05", drop, 0.05)):
        ref = plain_bwd_sliced(torch, FA, qkv, bias, None, lse, g, scale, h,
                               seed if rate else None, rate)
        abs_err, msg = held(f"B={bsz} N={n}{what}", k_fn(), ref, BWD_TOL["bfloat16"])
        worst = max(worst, abs_err)
        print(f"  K4 bfloat16 B={bsz} N={n} bias=1{what}: {msg}", flush=True)
        del ref
    bound_ms, bound_by = bound(nbytes(qkv, g, lse, bias) + nbytes(qkv, bias),
                               10.0 * bsz * h * n * n * 64, "bfloat16")
    # the library yardstick: autograd's backward of one
    # scaled_dot_product_attention call on the same inputs (dqkv and dbias)
    leaf = qkv.clone().requires_grad_()
    bias_leaf = bias.to(torch.bfloat16).requires_grad_()
    lib_out = sdpa_packed(torch, leaf, bias_leaf, scale, h)
    lib = lambda: torch.autograd.grad(lib_out, (leaf, bias_leaf), g, retain_graph=True)
    best, runs = in_turns({"plain": plain, "kernel": kern, "no dbias": no_dbias,
                           "bias copies rebuilt": bias_copies_rebuilt(FA, kern),
                           "dropout 0.05": drop, "library": lib}, 5)
    print(f"  K4 at B={bsz} N={n} H={h} D=64 bf16 (bias; \"kernel\" reuses the padded bias copies "
          f"of the call before, as 23 of a step's 24 layers do), ms per call: {runs}", flush=True)
    return {"max_abs_err": worst, "ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["library"], "bound_ms": bound_ms, "bound_by": bound_by,
            "other_ms": {k: best[k] for k in ("no dbias", "bias copies rebuilt",
                                              "dropout 0.05")}}


def phase9(torch, FA, dev):
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals.classification import evaluate, make_eval_forward
    from uncertainty_vit_tpu_torch.evals.mc_dropout import make_mc_dropout_forward
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )
    from uncertainty_vit_tpu_torch.train.engine_finetune import (
        FinetuneHParams, init_finetune_state, make_finetune_train_step,
    )
    from uncertainty_vit_tpu_torch.train.optim import make_optimizer
    from uncertainty_vit_tpu_torch.train.schedules import cosine_schedule
    from uncertainty_vit_tpu_torch.utils.checkpoint import resize_state_dict

    FA.BOUNDED_SCORES = True  # as cli/finetune.py trains and evaluates
    kw = dict(use_shared_rel_pos_bias=True, init_values=0.1)
    cfg = get_preset("beit_large_patch16_512", **kw)
    n = cfg.num_patches + 1
    check(FA.route(n) == "stream" and n == 1025, f"L/512 has N={n} on route {FA.route(n)}")
    gen = torch.Generator(device=dev).manual_seed(9)

    # the weights a 512 finetune starts from: a 224 model of the same width,
    # its rel-pos table (drawn at std 0.2 so that the bias is not all zeros)
    # carried from the 14 x 14 to the 32 x 32 window
    low = VisionTransformer(get_preset("beit_large_patch16_224", **kw), dtype=torch.bfloat16,
                            device=dev, generator=gen)
    trunc_normal(0.2, 2.0)(low.rel_pos_bias.relative_position_bias_table, gen)
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    init = resize_state_dict(low.state_dict(), model)
    model.load_state_dict(init, strict=True)
    table = model.rel_pos_bias.relative_position_bias_table
    check(tuple(table.shape) == ((2 * 32 - 1) ** 2 + 3, cfg.num_heads)
          and torch.isfinite(table).all().item() and table.abs().max().item() > 0.1,
          "the interpolated rel-pos table is not what the 32 x 32 window needs")
    check(torch.equal(table[-3:], low.rel_pos_bias.relative_position_bias_table[-3:]),
          "the cls entries of the rel-pos table did not pass through")
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  ViT-L/16 512: {n_params} params, depth {cfg.depth}, width {cfg.embed_dim}, "
          f"{cfg.num_heads} heads, N={n}; rel-pos table interpolated from the 224 model's "
          f"{tuple(low.rel_pos_bias.relative_position_bias_table.shape)} to {tuple(table.shape)}",
          flush=True)
    del low

    def counts():
        return {**attention_counts(FA), "K8": DO.fused_dropout.launches}

    def reset():
        reset_attention_counts(FA)
        DO.fused_dropout.launches = 0

    # --- evaluate(): 2 batches of 16 uint8 images
    bs, nb = 16, 2
    images = [torch.randint(0, 256, (bs, 512, 512, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(nb)]
    labels = [torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
              for _ in range(nb)]

    def batches():
        for u8, lbl in zip(images, labels):
            yield normalize(to_float(u8), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD), lbl

    torch.cuda.reset_peak_memory_stats()
    reset()
    metrics = evaluate(model, batches())
    torch.cuda.synchronize()
    launches = {"evaluate": counts()}
    peak_eval = torch.cuda.max_memory_allocated() / 2**30
    print(f"  evaluate(): launches {launches['evaluate']}; {json.dumps(metrics)}", flush=True)
    check(launches["evaluate"] == {"K1": 0, "K2": 0, "K3": cfg.depth * nb, "K4": 0, "K8": 0},
          f"evaluate() launched {launches['evaluate']}, expected K3 {cfg.depth * nb} only")
    check(all(math.isfinite(v) for v in metrics.values()), "non-finite metric")
    fwd = make_eval_forward(model)
    x0 = next(batches())[0]
    logits = torch.cat([fwd(x) for x, _ in batches()])
    check(tuple(logits.shape) == (bs * nb, cfg.num_classes) and logits.dtype == torch.float32
          and torch.isfinite(logits).all().item(), "L/512 logits are not finite f32 [32, 1000]")
    with attention_on_plain(torch, FA):
        ref = fwd(x0)
    diff = (logits[:bs] - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"  logits K3 vs plain attention: max|diff|={diff:.3e}, max|logit|={scale:.3e}, ratio "
          f"{diff / scale:.3e} (bound {LOGIT_REL_BOUND})", flush=True)
    check(diff <= LOGIT_REL_BOUND * scale, "L/512 logits disagree with the plain attention")
    # metrics on the card against a CPU recomputation, on well-separated
    # seeded logits (the random model's logits are within ~1e-3 of each other)
    lab = torch.cat(labels)
    syn = torch.randn(bs * nb, cfg.num_classes, generator=gen, device=dev) * 2.0
    syn[torch.arange(bs * nb, device=dev), lab] += 2.0
    on_card, on_cpu = M.classification_metrics(syn, lab), M.classification_metrics(syn.cpu(),
                                                                                   lab.cpu())
    for k in on_card:
        a, b = float(on_card[k]), float(on_cpu[k])
        check(abs(a - b) <= METRIC_ATOL + METRIC_RTOL * abs(b), f"metric {k}: card {a} vs cpu {b}")
    eval_ms = [cuda_ms(lambda: fwd(x0), 3) for _ in range(2)]
    print(f"  eval forward at batch {bs} (information only): {[bs * 1000 / ms for ms in eval_ms]} "
          f"img/s; peak memory of evaluate() {peak_eval:.2f} GiB", flush=True)
    del logits, ref, images

    # --- the finetune train step
    hp = FinetuneHParams(num_classes=cfg.num_classes)
    lr = cosine_schedule(4e-3, 1e-6, 10_000, warmup_steps=500)

    def build(**overrides):
        m = VisionTransformer(cfg.replace(drop_path_rate=0.1, **overrides), dtype=torch.bfloat16,
                              device=dev, generator=gen)
        m.load_state_dict(init)
        opt = make_optimizer(m, weight_decay=0.05, layer_decay=0.75, depth=cfg.depth)
        state = init_finetune_state(m, opt)
        # halfway up the warm-up (lr 2e-3): at its start lr times block 0's
        # layer-decay scale 0.75^24 is below half an ulp of a LayerNorm weight
        # of 1, and those weights would not move
        state.step = 250
        return m, state, make_finetune_train_step(m, opt, hp, lr)

    def gens(seed):
        return (torch.Generator(device=dev).manual_seed(seed), torch.Generator().manual_seed(seed))

    def step_counts(depth_steps):
        return {"K1": 0, "K2": 0, "K3": depth_steps, "K4": depth_steps, "K8": 0}

    bs_t, n_steps = 8, 3
    x = torch.randn(bs_t, 512, 512, 3, generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (bs_t,), generator=gen, device=dev)
    tmodel, state, step = build()
    torch.cuda.reset_peak_memory_stats()
    reset()
    ms = [step(state, x, y, *gens(11 + i)) for i in range(n_steps)]
    torch.cuda.synchronize()
    launches["train_step"] = counts()
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {n_steps} steps at batch {bs_t}: launches {launches['train_step']}; " + "; ".join(
        f"loss {float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f}" for m in ms),
        flush=True)
    check(launches["train_step"] == step_counts(cfg.depth * n_steps),
          f"{n_steps} train steps launched {launches['train_step']}")
    check(all(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))
              for m in ms), "non-finite loss or grad norm")
    moved = 0
    for k, v in tmodel.state_dict().items():
        check(torch.isfinite(v).all().item(), f"non-finite parameter {k}")
        moved += int(not torch.equal(v, init[k]))
    check(moved == len(init), f"only {moved} of {len(init)} parameter tensors changed")
    g = gens(20)
    train_ms = [cuda_ms(lambda: step(state, x, y, *g), 3) for _ in range(2)]
    print(f"  train step at batch {bs_t} (information only): "
          f"{[bs_t * 1000 / ms for ms in train_ms]} img/s; peak memory of the {n_steps} steps "
          f"{peak_train:.2f} GiB; all {moved} parameter tensors changed", flush=True)
    del tmodel, state, step

    # one step at batch 2 (the plain path saves [B, H, N, N] f32 tensors per
    # layer) from the same weights and seeds, kernels against plain versions
    x2, y2 = x[:2], y[:2]
    for what, overrides, seed in (("", {}, 30), (" with attn_drop_rate=0.05",
                                                 {"attn_drop_rate": 0.05}, 31)):
        _, st_k, step_k = build(**overrides)
        reset()
        m_k = step_k(st_k, x2, y2, *gens(seed))
        torch.cuda.synchronize()
        key = "train_step_attn_drop" if overrides else "train_step_batch_2"
        launches[key] = counts()
        check(launches[key] == step_counts(cfg.depth), f"the step{what} launched {launches[key]}")
        del st_k, step_k
        _, st_p, step_p = build(**overrides)
        with attention_on_plain(torch, FA):
            m_p = step_p(st_p, x2, y2, *gens(seed))
        torch.cuda.synchronize()
        check(counts() == launches[key], "the plain-attention reference step launched a kernel")
        del st_p, step_p
        loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
        gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
        print(f"  one step at batch 2{what}, K3/K4 vs their plain versions: loss {loss_k:.6f} / "
              f"{loss_p:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
        check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
              f"the L/512 step's loss{what} disagrees with the plain versions'")
        check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
              f"the L/512 step's grad norm{what} disagrees with the plain versions'")

    # --- one K=2 MC forward with attention dropout 0.1: K3's in-kernel mask
    mc_model = VisionTransformer(cfg.replace(attn_drop_rate=0.1), dtype=torch.bfloat16,
                                 device=dev, generator=gen)
    mc_model.load_state_dict(init)
    trunc_normal(0.1, 2.0)(mc_model.head.weight, gen)  # a wider head: the samples spread
    mc_fwd = make_mc_dropout_forward(mc_model, 2)
    xm = x[:4]
    reset()
    a1 = mc_fwd(xm, torch.Generator(device=dev).manual_seed(40))
    launches["mc_attn_drop"] = counts()
    check(launches["mc_attn_drop"] == {"K1": 0, "K2": 0, "K3": cfg.depth, "K4": 0, "K8": 0},
          f"the attention-dropout MC forward launched {launches['mc_attn_drop']}")
    check(tuple(a1.shape) == (2, 4, cfg.num_classes) and torch.isfinite(a1).all().item()
          and not torch.equal(a1[0], a1[1]), "MC samples are not finite or do not differ")
    check(torch.equal(a1, mc_fwd(xm, torch.Generator(device=dev).manual_seed(40))),
          "the MC logits are not reproducible from the seed")
    with attention_on_plain(torch, FA):
        a_ref = mc_fwd(xm, torch.Generator(device=dev).manual_seed(40))
    diff = (a1 - a_ref).abs().max().item()
    print(f"  one K=2 forward of batch 4 with attn_drop_rate=0.1: launches "
          f"{launches['mc_attn_drop']}; K3's dropout vs its plain version with the same masks: "
          f"max|diff|={diff:.3e}, ratio {diff / a_ref.abs().max().item():.3e} (bound "
          f"{LOGIT_REL_BOUND})", flush=True)
    check(diff <= LOGIT_REL_BOUND * a_ref.abs().max().item(),
          "the L/512 attention-dropout forward disagrees with the plain attention of the "
          "same masks")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from uncertainty_vit_tpu_torch.ops import _native
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA

    build_kernels(_native)

    dev = torch.device("cuda", 0)

    def run(number, title, fn, *fn_args):
        print(f"phase {number}: {title}", flush=True)
        t = time.perf_counter()
        out = fn(*fn_args)
        torch.cuda.synchronize()
        print(f"  phase {number} took {time.perf_counter() - t:.1f} s", flush=True)
        return out

    res = {1: run(1, "K1 against its plain version, without and with dropout",
                  phase1, torch, FA, dev)}
    eval_launches, det_ms = run(2, "ViT-B/16 224 evaluate()", phase2, torch, FA, dev)
    res[3] = run(3, "K2 against its plain version, without and with the mask replay",
                 phase3, torch, FA, dev)
    train, train_drop = run(4, "ViT-B/16 224 finetune train steps", phase4, torch, FA, dev)
    res[5] = run(5, "K8 against its plain version", phase5, torch, dev)
    res[6] = run(6, "ViT-B/16 224 evaluate_mc_dropout()", phase6, torch, FA, dev, det_ms)
    check(FA.fused_qkv_attention.stream_launches == 0
          and FA.fused_qkv_attention_bwd.stream_launches == 0,
          "a ViT-B/16 224 path launched a streaming kernel")
    res[7] = run(7, "K3 against its plain version, without and with dropout", phase7, torch, FA,
                 dev)
    res[8] = run(8, "K4 against its plain versions, without and with the mask replay", phase8,
                 torch, FA, dev)
    large = run(9, "ViT-L/16 512 evaluate(), finetune train steps, MC forward", phase9, torch,
                FA, dev)

    # one count per run of a path, each read after its own reset: evaluate()
    # over 4 batches, 3 train steps, 1 train step with attention dropout, and
    # phase 6's evaluate_mc_dropout() over 2 batches folded and split, its one
    # K=2 forward with attention dropout and its 2-member ensemble on 1 batch
    mc = {"mc_dropout_folded": res[6]["folded"], "mc_dropout_split": res[6]["split"],
          "mc_attn_drop": res[6]["attn_drop"], "ensemble": res[6]["ensemble"]}
    # and phase 9's ViT-L/16 512 paths ("large_"): evaluate() over 2 batches, 3
    # train steps, 1 step at batch 2, 1 step with attention dropout, one K=2
    # forward with attention dropout
    k1_paths = {"evaluate": eval_launches, "train_step": train["fwd"],
                "train_step_attn_drop": train_drop["fwd"],
                **{path: n["K1"] for path, n in mc.items()}}
    k2_paths = {"train_step": train["bwd"], "train_step_attn_drop": train_drop["bwd"]}
    k8_paths = {path: n["K8"] for path, n in mc.items() if n["K8"]}
    k3_paths = {f"large_{path}": n["K3"] for path, n in large.items()}
    k4_paths = {f"large_{path}": n["K4"] for path, n in large.items() if n["K4"]}
    for n_ in large.values():
        check(n_["K1"] == 0 and n_["K2"] == 0, "a ViT-L/16 512 path launched K1 or K2")
    pkg = "uncertainty_vit_tpu_torch/csrc/"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda", "source": pkg + "flash_attention_fwd.cu",
         "replaces": "uncertainty_vit_tpu/ops/flash_attention.py:188",
         "launches": sum(k1_paths.values()), "launches_by_path": k1_paths, **res[1]},
        {"name": "flash_attention_bwd", "route": "cuda", "source": pkg + "flash_attention_bwd.cu",
         "replaces": "uncertainty_vit_tpu/ops/flash_attention.py:244",
         "launches": sum(k2_paths.values()), "launches_by_path": k2_paths, **res[3]},
        {"name": "flash_attention_stream_fwd", "route": "cuda",
         "source": pkg + "flash_attention_stream_fwd.cu",
         "replaces": "uncertainty_vit_tpu/ops/flash_attention.py:668",
         "launches": sum(k3_paths.values()), "launches_by_path": k3_paths, **res[7]},
        {"name": "flash_attention_stream_bwd", "route": "cuda",
         "source": pkg + "flash_attention_stream_bwd.cu",
         "replaces": "uncertainty_vit_tpu/ops/flash_attention.py:744",
         "launches": sum(k4_paths.values()), "launches_by_path": k4_paths, **res[8]},
        {"name": "dropout", "route": "cuda", "source": pkg + "dropout.cu",
         "replaces": "uncertainty_vit_tpu/ops/dropout.py:43",
         "launches": sum(k8_paths.values()), "launches_by_path": k8_paths, **res[5]},
    ]
    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} was launched no time on the main paths")
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
