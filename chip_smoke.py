#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (uncertainty_vit_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc; it builds the port's CUDA
kernels from the sources in this checkout, then:

  phase 1  holds the attention forward (K1: at N <= 256 the streaming
           forward's kernel) against its plain PyTorch version at B=8, N in
           {197, 50, 256}, H=12, D=64, in bf16 (the model's compute dtype)
           and f32, over bias / no bias, q/v bias / none, bounded / exact
           softmax and with / without the row log-sum-exp; then holds its
           in-kernel dropout (rates 0.1 and 0.3) against the plain
           version's, which draws the same mask from the same seed, and
           checks that the lse is the undropped softmax's and that with zero
           scores and v = 1 the kernel's output is the plain version's to the
           bit (each row's kept count). Then holds and times it
           at the ViT-B/16 224 eval shape (B=128, N=197, bf16, bias,
           bounded), at the train step's B=160 with the lse and at the
           MC-dropout shape (B=1024), with rate 0 and rate 0.1, beside the
           plain version and one scaled_dot_product_attention call at B=128
           (the plain version at B=160 and 1024 computed 128 images at a
           time).
  phase 2  runs evaluate() of a full-width ViT-B/16 224 (beit_base_patch16_224,
           shared rel-pos bias, layer scale 0.1, 1000 classes, seeded random
           weights, bf16 compute on f32 params) over 4 batches of 128
           synthetic uint8 images, checks that every block launched K1, checks
           the logits against the same weights on the plain attention path and
           the metrics against a CPU recomputation, and measures the eval
           forward rate of both models.
  phase 3  holds the attention backward (K2: at N <= 256 the streaming
           backward's two kernels, the row sums formed from the forward's
           output) against its plain PyTorch version at B=8, N in {197, 50,
           256}, bf16 and f32, over bias / none, q/v bias / none, an lse
           from a bounded and from an exact K1 forward and dropout 0 / 0.1
           (the mask replayed), once with the row sums recomputed as
           rowsum(t) and once formed from the same output (dq, dk, dv, dbias
           and dqvb each against its bound; dqkv bit-identical between two
           runs); plants NaN right before and behind qkv, g, the output and
           the lse and checks that no bit of out, lse or dqkv changes;
           checks that the autograd Function's gradient (K1 + K2) equals
           autograd through the plain forward in f32; that with zero scores
           and g = 1 K2's dv is the plain version's to the bit (the same
           mask); the Euler identity <df/dv, v> = 2f of f = sum(out^2)
           through the Function at rate 0.3, and that it fails when the
           backward is given another seed than the forward; that the route
           changes from K1/K2 to K3/K4 right above N=256. Then holds K2 with
           rate 0 and 0.05 against both plain backwards at the ViT-B/16 224
           train shape (B=160, N=197, bf16, bias) and times them there, and
           without dbias, beside autograd's backward of
           scaled_dot_product_attention.
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
           same masks from the same seeds.
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
           also timed without bias, with the q/v bias, with the lse and with
           dropout 0.1, in turns
           with K1 at the same shape, one scaled_dot_product_attention call
           and the plain version (4 images at a time).
  phase 8  holds the split streaming backward (K4: two kernels behind one
           call; the row sums formed from the forward's output, which the
           backward now takes), through the routed call, against its two
           plain versions over the same grid of cases, once with the row
           sums recomputed as rowsum(t) (the function, as the JAX kernels
           form it) and once formed from the same output (dq, dk, dv, dbias
           and dqvb each against K2's bound relative to max|plain|; dqkv
           bit-identical between two runs); plants NaN right before and behind qkv, g, the output and
           the lse at N=577 and 1025 and checks that no bit of out, lse or
           dqkv changes;
           checks the Function's gradient (K3 + K4, f32) against autograd of
           the plain forward, and the Euler identity at rate 0.3 and its
           failure from another seed; then holds and times K4 at the ViT-L/16
           512 train shape (B=8, N=1025, bf16, bias) with rate 0 and 0.05,
           without dbias and with the q/v bias, beside autograd's backward of
           scaled_dot_product_attention and the plain versions.
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
  phase 10 holds the quantizing int8 matmul (K6) against its plain PyTorch
           version (the same rounding bits from the same seed): bf16 and f32,
           round-to-nearest and stochastic, with and without bias, at every
           (K, N) of ViT-B's and ViT-L's trunk and their dgrad transposes, M in
           {8, 197, 1000}, NaN planted around x; f32 within 1e-6 relative and
           bf16 within an ulp (equal to the bit is what is expected and
           printed); the same at K = 5120 and 6400 (past every trunk), and at
           M = 3333, K = 5120, N = 1280, where the persistent walk wraps and
           ends on a ragged row tile; then holds and times it at the train
           step's M = 31,520 (bf16; forward with bias, dgrad stochastic) for
           qkv, proj, fc1 and fc2 beside the plain version, F.linear in bf16
           (what the int8 layer replaces), torch._int_mm between plain
           quantize and dequantize passes (the library yardstick) and
           torch._int_mm alone on operands quantized beforehand, with K6's two
           kernels timed apart (torch.profiler).
  phase 11 holds the int8 wgrad (K7: two kernels behind one call) against its
           plain version over the same shapes: the int32 sums equal, and
           bit-identical between two runs, NaN planted around x and g; then
           holds and times it at M = 31,520 (wgrad() with its column-scale
           passes, and K7's two kernels alone, also apart) beside the plain
           version, the bf16 product, torch._int_mm between plain quantize,
           transpose and dequantize passes, and torch._int_mm alone on
           operands quantized beforehand (both with the tokens contiguous,
           as K7's product reads them).
  phase 12 the int8 slice: full-width, full-depth ViT-B/16 224 with
           quant="int8", otherwise phase 2's and phase 4's models. evaluate()
           over 4 batches of 128 (K6 48 launches per forward, K1 12, K7 none;
           logits against the same forward with K6 on its plain version); 3
           finetune train steps at batch 160 (per step K6 96, K7 48, K1 and K2
           12; every parameter finite and moved); one step held against the
           same step with K6 and K7 on their plain versions. Prints img/s
           beside the bf16 trunk's from the same turns, the int8 step's loss
           beside the bf16 step's on the same batch, and peak memory.
  phase 13 a 2-deep beit_huge_patch16_224 (head_dim 80, which the attention
           kernels do not take): one forward against the same weights in f32
           and one train step, on the plain attention, K1 to K4 never launched.
  phase 14 holds the cross attention of sequence-parallel attention (K5: K3's
           and K4's entries given Nq query rows against Nk keys) against its
           plain versions at Nq in {1, 63, 257, 513}, Nk in {65, 577, 1025},
           B=2, H=16, bf16 and f32, over bias / none, q/v bias / none and
           bounded / exact softmax (K1's and K2's bounds, the backward
           against the plain versions with the row sums recomputed and with
           them formed from the output, as phase 8; dq and dkv bit-identical
           between two runs); plants NaN around q, kv, g, the
           output and the lse; holds the S shards of K5 together against K3's
           output and K4's dqkv, dbias and dqvb of the whole sequence at N =
           577 and 1025
           for S = 2 and 4; then times one shard at B=8, N=1025 for S = 2
           (Nq = 513) and 4 (Nq = 257), forward with the lse and backward,
           beside K3 and K4 of the whole sequence, the plain versions and the
           library call (scaled_dot_product_attention with the bias as its
           mask, and autograd's backward of it).
  phase 15 the sequence-parallel slice: phase 9's ViT-L/16 512 on phase 9's
           weights with its tokens split over S = 2 gloo ranks that share the
           one card (rows 0-512 and 513-1024; k/v gathered through host
           memory): evaluate() over one batch of 16 and 2 train steps at batch
           8, per rank K5 24 launches per forward and 24 backward per step,
           K1-K4 none; logits equal on both ranks and within phase 2's bound
           of the unsharded model's on the same batch, the first step's loss
           and grad norm within phase 4's bounds of the unsharded step's.
           Prints each rank's rates and peak memory as information: two ranks
           on one card over gloo are not a throughput of sequence parallelism.

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
# Phase 15: each parameter's gradient norm after the sharded step's group sum
# against the unsharded step's (same weights, batch and seeds). The sharded
# backward sums two bf16 shares of each k/v cotangent where K4 rounds one f32
# sum, so a leaf's norm moves by a few bf16 roundings (read on an H100: the
# worst of 369 leaves, cls_token, 6.7e-4, the median 1.4e-5); a gradient left
# unsummed or summed twice moves it by tens of percent.
LEAF_GRAD_REL_BOUND = 5e-3
# The Euler identity <df/dv, v> = 2f of f = sum(out^2) holds to f32 rounding
# when the backward replays the forward's dropout mask and breaks at the
# percent level when it does not (tests/test_flash_attention.py:102-123).
EULER_RTOL = 1e-3
# Published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds: the
# least time the card could take is the larger of bytes / memory rate and
# operations / peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# Phase 10: K6 against its plain version. Both quantize every entry alike (the
# same rounding bits), the int32 sums are exact, and the dequantizing products
# and the bias add are rounded one by one in the same order, so the results
# should be equal; the bound allows the last rounding of the output type (an
# f32 ulp; half a bf16 ulp, 2^-8, either way).
QMM_REL_TOL = {"bfloat16": 2.0**-7, "float32": 1e-6}
# The fused kernels' token counts: ViT-B/16 224, a small N in one tile, and
# the route's edge (four whole tiles).
FUSED_N = (197, 50, 256)
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

    def plain_bwd(qkv, bias, qv_bias, lse, g, scale, h, *, out=None, want_dbias=True, seed=None,
                  dropout_rate=0.0):
        dqkv, dbias, dqvb = FA.fused_qkv_attention_bwd_plain(
            qkv, bias, qv_bias, lse, g, scale, h, out=out, seed=seed, dropout_rate=dropout_rate)
        return dqkv, dbias if want_dbias else None, dqvb

    FA._forward, FA.fused_qkv_attention_bwd = plain_fwd, plain_bwd
    try:
        yield
    finally:
        FA._forward, FA.fused_qkv_attention_bwd = fwd, bwd


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


def kernel_split(torch, fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel that fn launches, by a short name
    (torch.profiler over `calls` calls after one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and not e.is_user_annotation:
            name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", e.name).split("(")[0]
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 1000.0 / calls
    return split


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
            short = re.search(r"\d+((?:attention|dropout|stream|quant\w*|wgrad|qmm)_\w+?E)E*v",
                              entry)
            print(f"    {short.group(1) if short else entry}: {used}, {spills}", flush=True)


def phase1(torch, FA, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    h, c, scale = 12, 768, 64**-0.5
    worst_out = 0.0
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), FUSED_N):
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
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), FUSED_N):
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
                print(f"  K1 dropout {rate} N={n}: zero scores, v = 1: output equal to the plain "
                      f"version's to the bit (the same mask)", flush=True)
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

    # the ViT-B/16 224 shapes, N=197, bias, bounded scores: the eval batch
    # B=128, the train step's B=160 with the lse, and the MC-dropout batch
    # B=1024 (K=8 samples of batch 128 folded)
    big = torch.randn(1024, 197, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    qkv, train = big[:128], big[:160]
    bias = torch.randn(h, 197, 197, generator=gen, device=dev) * 0.5
    bias_cast = bias.to(torch.bfloat16)
    fwd = lambda x, rate=0.0, lse=False: (lambda: FA.fused_qkv_attention(  # noqa: E731
        x, bias, None, seed if rate else None, scale, h, rate, bounded_scores=True, want_lse=lse))
    kern, drop = fwd(qkv), fwd(qkv, 0.1)
    plain = lambda: FA.fused_qkv_attention_plain(qkv, bias, None, scale, h, bounded_scores=True)
    lib = lambda: sdpa_packed(torch, qkv, bias_cast, scale, h)

    def plain_sliced(x, rate):
        """The plain version 128 images at a time, each slice with the mask
        of its place in the batch: (out, lse)."""
        parts = [FA.fused_qkv_attention_plain(
            x[i:i + 128], bias, None, scale, h, bounded_scores=True, seed=seed,
            dropout_rate=rate, image0=i) for i in range(0, x.shape[0], 128)]
        return torch.cat([o for o, _ in parts]), torch.cat([l for _, l in parts])

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
    worst_drop = max(worst_drop, held_k1("B=128 dropout 0.1", drop(), plain_sliced(qkv, 0.1)[0]))
    del out, ref
    got, got_lse = fwd(train, lse=True)()
    want, want_lse = plain_sliced(train, 0.0)
    worst_out = max(worst_out, held_k1("B=160 with the lse", got, want))
    lse_err = (got_lse - want_lse).abs().max().item()
    check(lse_err <= LSE_ATOL, f"K1's lse disagrees at the train shape ({lse_err:.3e})")
    # the shape the MC-dropout path gives K1 (12,288 (image, head) pairs)
    worst_out = max(worst_out, held_k1("B=1024", fwd(big)(), plain_sliced(big, 0.0)[0]))
    worst_drop = max(worst_drop, held_k1("B=1024 dropout 0.1", fwd(big, 0.1)(),
                                         plain_sliced(big, 0.1)[0]))
    del got, got_lse, want, want_lse
    best, runs = in_turns({"plain": plain, "kernel": kern, "dropout 0.1": drop,
                           "B=160 with lse": fwd(train, lse=True), "library": lib}, 20)
    print(f"  K1 at B=128 N=197 H=12 D=64 bf16 (bias, bounded), ms per call: {runs}", flush=True)
    best_big, runs_big = in_turns({"kernel": fwd(big), "dropout 0.1": fwd(big, 0.1)}, 10)

    def k1_bound(x, lse):
        b_ = x.shape[0]
        return bound(nbytes(x, bias) + x.numel() // 3 * 2 + (4 * b_ * h * 197 if lse else 0),
                     4.0 * b_ * h * 197 * 197 * 64, "bfloat16")

    bound_ms, bound_by = k1_bound(qkv, False)
    train_bound, _ = k1_bound(train, True)
    big_bound, _ = k1_bound(big, False)
    print(f"  K1 at B=1024 (the MC-dropout shape), ms per call: {runs_big}; bounds: B=128 "
          f"{bound_ms:.4f} ms, B=160 with the lse {train_bound:.4f}, B=1024 {big_bound:.4f}",
          flush=True)
    return {"max_abs_err": max(worst_out, worst_drop), "ms": best["kernel"],
            "plain_ms": best["plain"], "library_ms": best["library"], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "other_ms": {"B=128 dropout 0.1": best["dropout 0.1"],
                         "B=160 with lse": best["B=160 with lse"],
                         "B=160 with lse bound": train_bound,
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
    seed = torch.tensor([0x0FEDCBA987654321], dtype=torch.int64, device=dev)
    worst, n_cases = 0.0, 0

    def parts(got):
        """(dqkv, dbias, dqvb) as (dq, dk, dv, dbias, dqvb)."""
        return (*got[0].chunk(3, dim=-1), got[1], got[2])

    def held(tag, got, qkv, b_, q_, lse, out, g, sd, rate, tol):
        """got = K2's (dqkv, dbias, dqvb), held against the plain backward
        with the row sums recomputed as rowsum(t) and with them formed from
        the forward's output ``out``."""
        refs = [parts(FA.fused_qkv_attention_bwd_plain(qkv, b_, q_, lse, g, scale, h, out=o,
                                                       seed=sd, dropout_rate=rate))
                for o in (None, out)]
        return held_bwd_both(torch, "K2", tag, parts(got), refs, tol)

    for dtype, n in itertools.product((torch.bfloat16, torch.float32), FUSED_N):
        name = str(dtype)[6:]
        tol = BWD_TOL[name]
        qkv = torch.randn(8, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(8, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        for has_bias, has_qvb, bounded, rate in itertools.product(
                (True, False), (True, False), (True, False), (0.0, 0.1)):
            b_ = bias if has_bias else None
            q_ = qvb if has_qvb else None
            sd = seed if rate > 0.0 else None
            out, lse = FA.fused_qkv_attention(qkv, b_, q_, sd, scale, h, rate,
                                              bounded_scores=bounded, want_lse=True)
            before = attention_counts(FA)
            got = FA.fused_qkv_attention_bwd(qkv, b_, q_, lse, g, scale, h, out=out, seed=sd,
                                             dropout_rate=rate)
            after = attention_counts(FA)
            check(after["K2"] == before["K2"] + 1 and after["K4"] == before["K4"],
                  f"the routed backward at N={n} did not launch K2 once and K4 never")
            check(got[0].dtype == dtype and got[0].shape == qkv.shape, "K2 dqkv dtype/shape")
            tag = (f"{name} N={n} bias={has_bias:d} qv_bias={has_qvb:d} bounded={bounded:d} "
                   f"dropout {rate}")
            abs_err, msg = held(tag, got, qkv, b_, q_, lse, out, g, sd, rate, tol)
            worst, n_cases = max(worst, abs_err), n_cases + 1
            if has_bias and (has_qvb or rate > 0.0):
                print(f"  K2 {tag}: {msg}", flush=True)
            again = FA.fused_qkv_attention_bwd(qkv, b_, q_, lse, g, scale, h, out=out, seed=sd,
                                               dropout_rate=rate)
            check(torch.equal(got[0], again[0]), f"K2's dqkv differs between two runs ({tag})")
        del qkv, g, bias, out, got, again
    print(f"  K2: {n_cases} cases within their bounds of both plain versions (the row sums "
          f"recomputed, and formed from the output), dqkv bit-identical between two runs, "
          f"worst max|dqkv-plain| {worst:.3e}", flush=True)

    # ragged tails: the same calls with NaN planted right before and right
    # behind qkv, g, the output and the lse give the same bits
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), FUSED_N):
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        out, lse = FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=False,
                                          want_lse=True)
        got = FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out)
        f_qkv, f_g, f_lse = fenced(torch, qkv), fenced(torch, g), fenced(torch, lse)
        f_out, f_lse_out = FA.fused_qkv_attention(f_qkv, bias, None, None, scale, h,
                                                  bounded_scores=False, want_lse=True)
        f_got = FA.fused_qkv_attention_bwd(f_qkv, bias, None, f_lse, f_g, scale, h,
                                           out=fenced(torch, out))
        torch.cuda.synchronize()
        check(torch.equal(out, f_out) and torch.equal(lse, f_lse_out),
              f"K1 reads behind the end of qkv ({str(dtype)[6:]} N={n})")
        check(torch.isfinite(f_got[0].float()).all().item() and torch.equal(got[0], f_got[0]),
              f"K2 reads behind the end of qkv, g, out or lse ({str(dtype)[6:]} N={n})")
        check(torch.isfinite(f_got[1]).all().item(), "K2's dbias is not finite behind a NaN fence")
        print(f"  K1/K2 {str(dtype)[6:]} N={n}: NaN planted around qkv, g, out and lse changes no "
              f"bit of out, lse and dqkv", flush=True)
        del qkv, g, bias, got, f_got, f_qkv, f_g

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

    # the replayed mask itself: zero scores, lse 0 (p = 1) and g = 1 make
    # column j of dv its kept count times 1/(1 - rate), bf16 sums exact in f32
    for n, rate in itertools.product(FUSED_N, (0.1, 0.3)):
        zeros = torch.zeros(8, n, 3 * c, device=dev, dtype=torch.bfloat16)
        ones = torch.ones(8, n, c, device=dev, dtype=torch.bfloat16)
        lse0 = torch.zeros(8, h, n, device=dev)
        got = FA.fused_qkv_attention_bwd(zeros, None, None, lse0, ones, scale, h,
                                         out=torch.zeros_like(ones), seed=seed,
                                         dropout_rate=rate)[0]
        ref = FA.fused_qkv_attention_bwd_plain(zeros, None, None, lse0, ones, scale, h,
                                               out=torch.zeros_like(ones), seed=seed,
                                               dropout_rate=rate)[0]
        check(torch.equal(got[..., 2 * c:], ref[..., 2 * c:]),
              f"K2's replayed dropout mask is not the plain version's (N={n} rate {rate})")
    print(f"  K2 dropout 0.1, 0.3 N={FUSED_N}: zero scores, g = 1: dv equal to the plain "
          f"version's to the bit (the same mask)", flush=True)

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
        wrong = FA.fused_qkv_attention_bwd(data, None, None, lse, 2.0 * out2, scale, h, out=out2,
                                           seed=seed + 1, dropout_rate=0.3)[0]
        inner_wrong = (wrong[..., 2 * c:].double() * data[..., 2 * c:].double()).sum().item()
        rel_wrong = abs(inner_wrong - 2.0 * f.item()) / (2.0 * f.item())
        print(f"  Euler identity N={n} rate 0.3: |<df/dv, v> - 2f| / 2f = {rel:.3e} with the "
              f"replayed mask, {rel_wrong:.3e} with another seed (bound {EULER_RTOL})", flush=True)
        check(rel <= EULER_RTOL, "K2 does not replay K1's dropout mask")
        check(rel_wrong > EULER_RTOL, "the Euler identity does not tell a wrong mask")

    check(FA.route(BIG_N[0] - 1) == "fused" and FA.route(BIG_N[0]) == "stream",
          "the route does not change kernels right above K2's limit")

    # train shape of ViT-B/16 224: B=160, N=197, bf16, bias, lse of a bounded
    # forward; turns plain, kernel, kernel, plain
    qkv = torch.randn(160, 197, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(160, 197, c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, 197, 197, generator=gen, device=dev) * 0.5
    out, lse = FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=True,
                                      want_lse=True)
    out_d = FA.fused_qkv_attention(qkv, bias, None, seed, scale, h, 0.05, bounded_scores=True)
    kern = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out)
    drop = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out_d,
                                              seed=seed, dropout_rate=0.05)
    plain = lambda: FA.fused_qkv_attention_bwd_plain(qkv, bias, None, lse, g, scale, h, out=out)
    for what, k_fn, rate, o in (("", kern, 0.0, out), (" dropout 0.05", drop, 0.05, out_d)):
        got = k_fn()
        abs_err, msg = held(f"B=160 N=197{what}", got, qkv, bias, None, lse, o, g,
                            seed if rate else None, rate, BWD_TOL["bfloat16"])
        worst = max(worst, abs_err)
        check(torch.equal(got[0], k_fn()[0]), f"K2's dqkv differs between two runs at B=160{what}")
        print(f"  K2 bfloat16 B=160 N=197 bias=1{what}: {msg}; dqkv bit-identical between two "
              f"runs", flush=True)
    bound_ms, bound_by = bound(nbytes(qkv, g, lse, bias) + nbytes(qkv, bias),
                               10.0 * 160 * h * 197 * 197 * 64, "bfloat16")
    del got
    # the library yardstick: autograd's backward of one
    # scaled_dot_product_attention call on the same inputs (dqkv and dbias)
    leaf = qkv.clone().requires_grad_()
    bias_leaf = bias.to(torch.bfloat16).requires_grad_()
    lib_out = sdpa_packed(torch, leaf, bias_leaf, scale, h)
    lib = lambda: torch.autograd.grad(lib_out, (leaf, bias_leaf), g, retain_graph=True)
    no_dbias = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out,
                                                  want_dbias=False)
    best, runs = in_turns({"plain": plain, "kernel": kern, "dropout 0.05": drop,
                           "no dbias": no_dbias, "library": lib}, 10)
    print(f"  K2 at B=160 N=197 H=12 D=64 bf16 (bias), ms per call: {runs}", flush=True)
    return {"max_abs_err": worst, "ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["library"], "bound_ms": bound_ms, "bound_by": bound_by,
            "other_ms": {"B=160 dropout 0.05": best["dropout 0.05"],
                         "B=160 no dbias": best["no dbias"]}}


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


def plain_bwd_sliced(torch, FA, qkv, bias, qvb, lse, out, g, scale, h, seed, rate, step=2):
    """K4's two plain versions `step` images at a time, the row sums formed
    from the forward's output `out` as the kernel forms them, or with `out`
    None recomputed as rowsum(t) over the keys, as the fused plain backward
    and the JAX kernels form them: (dq, dk, dv, dbias summed over the
    slices, c)."""
    dq, dk, dv, cs, dbias = [], [], [], [], None
    for i in range(0, qkv.shape[0], step):
        sl = slice(i, i + step)
        dq_i, db_i, c_i = FA.stream_bwd_dq_plain(qkv[sl], bias, qvb, lse[sl], g[sl], scale, h,
                                                 out=None if out is None else out[sl], seed=seed,
                                                 dropout_rate=rate, image0=i)
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
    qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
    fns = {
        "plain": lambda: plain_fwd_sliced(torch, FA, qkv, bias, None, scale, h, True, None, 0.0),
        "kernel": lambda: FA.fused_qkv_attention(qkv, bias, None, None, scale, h,
                                                 bounded_scores=True),
        f"train B={train_bsz} with lse": lambda: FA.fused_qkv_attention(
            qkv[:train_bsz], bias, None, None, scale, h, bounded_scores=True, want_lse=True),
        "no bias": lambda: FA.fused_qkv_attention(qkv, None, None, None, scale, h,
                                                  bounded_scores=True),
        "with q/v bias": lambda: FA.fused_qkv_attention(qkv, bias, qvb, None, scale, h,
                                                        bounded_scores=True),
        "with lse": lambda: FA.fused_qkv_attention(qkv, bias, None, None, scale, h,
                                                   bounded_scores=True, want_lse=True),
        "dropout 0.1": lambda: FA.fused_qkv_attention(qkv, bias, None, seed, scale, h, 0.1,
                                                      bounded_scores=True),
        "library": lambda: sdpa_packed(torch, qkv, bias_cast, scale, h),
    }
    ref, ref_lse = fns["plain"]()
    ref = ref.float()
    tol = OUT_TOL["bfloat16"]
    got = fns["kernel"]().float()
    err = (got - ref).abs().max().item()
    worst = max(worst, err)
    print(f"  kernel at B={bsz} N={n} H={h} bf16 bias=1 bounded=1: max|out-plain|={err:.3e}",
          flush=True)
    check(torch.allclose(got, ref, atol=tol, rtol=tol),
          f"kernel disagrees with the plain version at the L/512 eval shape ({err:.3e})")
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
                                              "with q/v bias", "with lse", "dropout 0.1")}}


def held_bwd_both(torch, kernel, tag, got, refs, tol):
    """``held_bwd`` against each of the two plain references in ``refs``:
    first the row sums recomputed as rowsum(t) (the function, as the JAX
    kernels form it), then the row sums formed from the forward's output
    (g·o, as the kernel forms them). Returns the larger absolute error and
    the first reference's summary."""
    first = held_bwd(torch, kernel, f"{tag}, c recomputed", got, refs[0], tol)
    second = held_bwd(torch, kernel, f"{tag}, c from the output", got, refs[1], tol)
    return max(first[0], second[0]), first[1]


def held_bwd(torch, kernel, tag, got, ref, tol):
    """got = (dq, dk, dv, dbias, dqvb) of a streaming backward (K4 or K5),
    ref the same of its plain versions; each part against its bound in
    ``tol`` relative to max|plain|. Returns (the largest absolute error of
    dq, dk and dv, a summary)."""
    names = ("dq", "dk", "dv", "dbias", "dqvb")
    check((got[3] is None) == (ref[3] is None), f"{kernel} dbias presence differs ({tag})")
    msg, abs_err = [], 0.0
    for name, a, r in zip(names, got, ref):
        if a is None:
            continue
        check(torch.isfinite(a.float()).all().item(), f"{kernel} {name} is not finite ({tag})")
        rel = _rel_err(a, r)
        if name in ("dq", "dk", "dv"):
            abs_err = max(abs_err, (a.float() - r.float()).abs().max().item())
        msg.append(f"{name} rel={rel:.3e}")
        bound_ = tol["dqkv" if name in ("dq", "dk", "dv") else name]
        check(rel <= bound_, f"{kernel} {name} disagrees with its plain version ({tag}: rel "
              f"{rel:.3e} > {bound_})")
    if got[4] is not None:
        check(torch.all(got[4][1] == 0).item(), f"{kernel} dqvb has a nonzero k row ({tag})")
    return abs_err, ", ".join(msg)


def phase8(torch, FA, dev):
    gen = torch.Generator(device=dev).manual_seed(8)
    h, c, scale = 16, 1024, 64**-0.5
    seed = torch.tensor([0x0FEDCBA987654321], dtype=torch.int64, device=dev)
    worst, n_cases = 0.0, 0

    def held(tag, got, qkv, b_, q_, lse, out, g, sd, rate, tol):
        """got = (dqkv, dbias, dqvb) of the routed call, held against the two
        plain versions (``plain_bwd_sliced``) with the row sums recomputed
        and with them formed from the forward's output ``out``."""
        dqkv, dbias, dqvb = got
        refs = []
        for o in (None, out):
            ref = plain_bwd_sliced(torch, FA, qkv, b_, q_, lse, o, g, scale, h, sd, rate)
            ref_dqvb = (FA.reduce_qv_bias_grad(torch.cat(ref[:3], dim=-1)) if dqvb is not None
                        else None)
            refs.append((*ref[:4], ref_dqvb))
        return held_bwd_both(torch, "K4", tag, (*dqkv.chunk(3, dim=-1), dbias, dqvb), refs, tol)

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
            out, lse = FA.fused_qkv_attention(qkv, b_, q_, sd, scale, h, rate,
                                              bounded_scores=bounded, want_lse=True)
            before = attention_counts(FA)
            got = FA.fused_qkv_attention_bwd(qkv, b_, q_, lse, g, scale, h, out=out, seed=sd,
                                             dropout_rate=rate)
            after = attention_counts(FA)
            check(after["K4"] == before["K4"] + 1 and after["K2"] == before["K2"],
                  f"the routed backward at N={n} did not launch K4 once and K2 never")
            tag = (f"{name} N={n} bias={has_bias:d} qv_bias={has_qvb:d} bounded={bounded:d} "
                   f"dropout {rate}")
            check(got[0].dtype == dtype and got[0].shape == qkv.shape, "K4 dqkv dtype/shape")
            abs_err, msg = held(tag, got, qkv, b_, q_, lse, out, g, sd, rate, tol)
            worst, n_cases = max(worst, abs_err), n_cases + 1
            if has_bias and has_qvb:
                print(f"  K4 {tag}: {msg}", flush=True)
            again = FA.fused_qkv_attention_bwd(qkv, b_, q_, lse, g, scale, h, out=out, seed=sd,
                                               dropout_rate=rate)
            check(torch.equal(got[0], again[0]), f"K4's dqkv differs between two runs ({tag})")
        del qkv, g, bias, out, got, again
    print(f"  K4: {n_cases} cases within K2's bounds of both plain versions (the row sums "
          f"recomputed, and formed from the output), dqkv bit-identical between two runs, "
          f"worst max|dqkv-plain| {worst:.3e}", flush=True)

    # ragged tails feed dk and dv: the same call with NaN planted right before
    # and right behind qkv, g, the output and the lse gives the same bits
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), (577, 1025)):
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5

        out, lse = FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=False,
                                          want_lse=True)
        got = FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out)
        f_qkv, f_g, f_lse = fenced(torch, qkv), fenced(torch, g), fenced(torch, lse)
        f_out, f_lse_out = FA.fused_qkv_attention(f_qkv, bias, None, None, scale, h,
                                                  bounded_scores=False, want_lse=True)
        f_got = FA.fused_qkv_attention_bwd(f_qkv, bias, None, f_lse, f_g, scale, h,
                                           out=fenced(torch, out))
        torch.cuda.synchronize()
        check(torch.equal(out, f_out) and torch.equal(lse, f_lse_out),
              f"K3 reads behind the end of qkv ({str(dtype)[6:]} N={n})")
        check(torch.isfinite(f_got[0].float()).all().item() and torch.equal(got[0], f_got[0]),
              f"K4 reads behind the end of qkv, g, out or lse ({str(dtype)[6:]} N={n})")
        check(torch.isfinite(f_got[1]).all().item(), "K4's dbias is not finite behind a NaN fence")
        print(f"  K3/K4 {str(dtype)[6:]} N={n}: NaN planted around qkv, g, out and lse changes no "
              f"bit of out, lse and dqkv", flush=True)
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
        wrong = FA.fused_qkv_attention_bwd(data, None, None, lse, 2.0 * out2, scale, h, out=out2,
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
    out, lse = FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=True,
                                      want_lse=True)
    out_d = FA.fused_qkv_attention(qkv, bias, None, seed, scale, h, 0.05, bounded_scores=True)
    qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
    out_q, lse_q = FA.fused_qkv_attention(qkv, bias, qvb, None, scale, h, bounded_scores=True,
                                          want_lse=True)
    kern = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out)
    no_dbias = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out,
                                                  want_dbias=False)
    drop = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out_d,
                                              seed=seed, dropout_rate=0.05)
    with_qvb = lambda: FA.fused_qkv_attention_bwd(qkv, bias, qvb, lse_q, g, scale, h, out=out_q)
    plain = lambda: plain_bwd_sliced(torch, FA, qkv, bias, None, lse, out, g, scale, h, None,
                                     0.0)
    for what, k_fn, rate, o in (("", kern, 0.0, out), (" dropout 0.05", drop, 0.05, out_d)):
        abs_err, msg = held(f"B={bsz} N={n}{what}", k_fn(), qkv, bias, None, lse, o, g,
                            seed if rate else None, rate, BWD_TOL["bfloat16"])
        worst = max(worst, abs_err)
        print(f"  K4 bfloat16 B={bsz} N={n} bias=1{what}: {msg}", flush=True)
    # the function's own traffic: the output the kernel reads for its row
    # sums is this design's, not the function's
    bound_ms, bound_by = bound(nbytes(qkv, g, lse, bias) + nbytes(qkv, bias),
                               10.0 * bsz * h * n * n * 64, "bfloat16")
    # the library yardstick: autograd's backward of one
    # scaled_dot_product_attention call on the same inputs (dqkv and dbias)
    leaf = qkv.clone().requires_grad_()
    bias_leaf = bias.to(torch.bfloat16).requires_grad_()
    lib_out = sdpa_packed(torch, leaf, bias_leaf, scale, h)
    lib = lambda: torch.autograd.grad(lib_out, (leaf, bias_leaf), g, retain_graph=True)
    best, runs = in_turns({"plain": plain, "kernel": kern, "no dbias": no_dbias,
                           "with q/v bias": with_qvb, "dropout 0.05": drop, "library": lib}, 5)
    print(f"  K4 at B={bsz} N={n} H={h} D=64 bf16 (bias), ms per call: {runs}", flush=True)
    return {"max_abs_err": worst, "ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["library"], "bound_ms": bound_ms, "bound_by": bound_by,
            "other_ms": {k: best[k] for k in ("no dbias", "with q/v bias", "dropout 0.05")}}


def host_ms(torch, fn) -> float:
    """ms of one call of fn on the host clock, the device synchronized before
    and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def large_512_model(torch, dev, init, group=None, train=False, **overrides):
    """Phase 9's ViT-L/16 512 (shared rel-pos bias, layer scale 0.1, bf16 on
    f32 parameters, config ``overrides``) on the state ``init``, its tokens
    split over ``group`` when one is given: (model, None, None) for
    evaluation; for training, with drop-path 0.1, (model, state, step) with
    phase 9's step (batch mixup, AdamW with layer decay 0.75 and weight decay
    0.05 on a cosine LR), the state halfway up the warm-up (lr 2e-3: at its
    start lr times block 0's layer-decay scale 0.75^24 is below half an ulp
    of a LayerNorm weight of 1, and those weights would not move)."""
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.train.engine_finetune import (
        FinetuneHParams, init_finetune_state, make_finetune_train_step,
    )
    from uncertainty_vit_tpu_torch.train.optim import make_optimizer
    from uncertainty_vit_tpu_torch.train.schedules import cosine_schedule

    cfg = get_preset("beit_large_patch16_512", use_shared_rel_pos_bias=True, init_values=0.1,
                     drop_path_rate=0.1 if train else 0.0, **overrides)
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, seq_group=group,
                              generator=torch.Generator(device=dev).manual_seed(0))
    model.load_state_dict(init)
    if not train:
        return model, None, None
    opt = make_optimizer(model, weight_decay=0.05, layer_decay=0.75, depth=cfg.depth)
    state = init_finetune_state(model, opt)
    state.step = 250
    step = make_finetune_train_step(model, opt, FinetuneHParams(num_classes=cfg.num_classes),
                                    cosine_schedule(4e-3, 1e-6, 10_000, warmup_steps=500))
    return model, state, step


def large_512_gens(torch, dev, seed):
    """(the device generator of drop-path, the CPU generator of mixup) of a
    step, both from ``seed``."""
    return torch.Generator(device=dev).manual_seed(seed), torch.Generator().manual_seed(seed)


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
    def build(**overrides):
        return large_512_model(torch, dev, init, train=True, **overrides)

    def gens(seed):
        return large_512_gens(torch, dev, seed)

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
    return launches, init


# The trunk's dense layers as (K, N) = (in, out): ViT-B's qkv, proj, fc1, fc2
# and ViT-L's. The forward runs (K, N), the dgrad (N, K).
TRUNK_B = {"qkv": (768, 2304), "proj": (768, 768), "fc1": (768, 3072), "fc2": (3072, 768)}
TRUNK_L = {"qkv": (1024, 3072), "proj": (1024, 1024), "fc1": (1024, 4096), "fc2": (4096, 1024)}
# (K, N) past every trunk: beit_huge_patch16_224's fc2 contraction, and one
# past the 6,272 that K6 took before it streamed the contraction.
WIDE_K = ((5120, 1280), (6400, 384))
# Tokens of the ViT-B/16 224 train step at batch 160 (ragged against 64: 492 * 64 + 32)
# and of its eval forward at batch 128 (394 * 64).
M_TRAIN = 160 * 197
M_EVAL = 128 * 197


def fenced(torch, t):
    """A copy of t with NaN planted right before and right behind it."""
    buf = torch.full((t.numel() + 256,), float("nan"), dtype=t.dtype, device=t.device)
    view = buf[128:128 + t.numel()].view(t.shape)
    view.copy_(t)
    check(view.data_ptr() % 16 == 0 and torch.isnan(buf[:128].float()).all().item()
          and torch.isnan(buf[-128:].float()).all().item(), "the NaN fence is not there")
    return view


def quant_shapes():
    """Every (K, N) the int8 kernels meet in ViT-B and ViT-L, forward and
    dgrad, once each."""
    shapes = []
    for k, n in list(TRUNK_B.values()) + list(TRUNK_L.values()):
        for pair in ((k, n), (n, k)):
            if pair not in shapes:
                shapes.append(pair)
    return shapes


def phase10(torch, dev):
    from uncertainty_vit_tpu_torch.ops import quant as TQ

    gen = torch.Generator(device=dev).manual_seed(10)
    seed = torch.tensor([0x0123456789ABCDEF], dtype=torch.int64, device=dev)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    unequal = n_cases = 0

    def held(tag, x, wq, ws, bias, sr, dtype):
        nonlocal unequal, n_cases
        name = str(dtype)[6:]
        before = TQ.qmm.launches
        got = TQ.qmm(x, wq, ws, bias, seed, sr, dtype)
        check(TQ.qmm.launches == before + 1, "qmm did not launch K6 once")
        ref = TQ.qmm_plain(x, wq, ws, bias, seed, sr, dtype)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == ref.shape, f"K6 dtype/shape ({tag})")
        check(torch.isfinite(got.float()).all().item(), f"K6 output is not finite ({tag})")
        rel = ((got.float() - ref.float()).abs() / ref.float().abs().clamp_min(1e-30)).max().item()
        rel = 0.0 if torch.equal(got, ref) else rel
        worst[name] = max(worst[name], rel)
        unequal += int(not torch.equal(got, ref))
        n_cases += 1
        check(rel <= QMM_REL_TOL[name], f"K6 disagrees with its plain version ({tag}: worst "
              f"relative difference {rel:.3e} > {QMM_REL_TOL[name]})")
        return (got.float() - ref.float()).abs().max().item()

    worst_abs = 0.0
    for dtype, (k, n) in itertools.product((torch.bfloat16, torch.float32), quant_shapes()):
        w = torch.randn(n, k, generator=gen, device=dev) * 0.05
        wq, ws = TQ.quantize_cols(w.t())
        bias = torch.randn(n, generator=gen, device=dev) * 0.1
        for m in (8, 197, 1000):  # 1000 = 15 * 64 + 40: ragged against every row tile
            x = fenced(torch, torch.randn(m, k, generator=gen, device=dev).to(dtype))
            for sr, has_bias in itertools.product((False, True), (True, False)):
                tag = f"{str(dtype)[6:]} M={m} K={k} N={n} sr={sr:d} bias={has_bias:d}"
                worst_abs = max(worst_abs, held(tag, x, wq, ws, bias if has_bias else None, sr,
                                                dtype))
        del w, wq
    print(f"  K6: {n_cases} cases (bf16/f32 x {len(quant_shapes())} shapes x M 8/197/1000 x "
          f"nearest/stochastic x bias/none, NaN planted around x): {unequal} not equal to the "
          f"bit, worst relative difference bf16 {worst['bfloat16']:.3e} / f32 "
          f"{worst['float32']:.3e}", flush=True)
    # contractions wider than any trunk's (the reference admits every multiple
    # of 128), and a walk of the persistent tiles that wraps with a ragged
    # last row tile (3333 = 26 * 128 + 5 rows; 27 x 5 tiles of 128 x 256)
    before = (n_cases, unequal)
    for dtype, (k, n), m in itertools.product((torch.bfloat16, torch.float32), WIDE_K,
                                              (8, 197, 1000)):
        w = torch.randn(n, k, generator=gen, device=dev) * 0.05
        wq, ws = TQ.quantize_cols(w.t())
        bias = torch.randn(n, generator=gen, device=dev) * 0.1
        x = fenced(torch, torch.randn(m, k, generator=gen, device=dev).to(dtype))
        for sr, has_bias in itertools.product((False, True), (True, False)):
            tag = f"{str(dtype)[6:]} M={m} K={k} N={n} sr={sr:d} bias={has_bias:d}"
            worst_abs = max(worst_abs, held(tag, x, wq, ws, bias if has_bias else None, sr,
                                            dtype))
    k, n, m = 5120, 1280, 3333
    w = torch.randn(n, k, generator=gen, device=dev) * 0.05
    wq, ws = TQ.quantize_cols(w.t())
    bias = torch.randn(n, generator=gen, device=dev) * 0.1
    x = fenced(torch, torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16))
    for sr in (False, True):
        worst_abs = max(worst_abs, held(f"ragged walk M={m} K={k} N={n} sr={sr:d}", x, wq, ws,
                                        None if sr else bias, sr, torch.bfloat16))
    print(f"  K6 at K = {', '.join(str(k) for k, _ in WIDE_K)} (bf16/f32 x M 8/197/1000 x "
          f"nearest/stochastic x bias/none) and M={m} K={k} N={n}: {n_cases - before[0]} cases, "
          f"{unequal - before[1]} not equal to the bit", flush=True)
    # the dgrad's second int8 copy of a weight is transposed once by the wrapper
    w = torch.randn(768, 2304, generator=gen, device=dev) * 0.05
    wq, ws = TQ.quantize_cols(w)  # [K, N] row-major: not the kernel's layout
    x = torch.randn(197, 768, generator=gen, device=dev).to(torch.bfloat16)
    check(not wq.t().is_contiguous(), "the test weight already lies as the kernel reads it")
    worst_abs = max(worst_abs, held("transposed copy", x, wq, ws, None, True, torch.bfloat16))
    for bad_x, bad_w in ((x.to(torch.float16), wq), (x[:4], wq), (x[:, :600], wq[:600])):
        try:
            TQ.qmm(bad_x, bad_w, ws, None, seed, False, torch.bfloat16)
            check(False, "K6 took a tensor it does not support")
        except ValueError:
            pass
    del w, wq, x

    # the train step's shapes: M = 31,520, bf16; forward (nearest, bias) and
    # dgrad (stochastic, K and N swapped, no bias)
    def int_mm_library(x, wq_t, ws, bias):
        """The library yardstick: torch._int_mm between plain PyTorch passes
        that quantize the rows and dequantize the result (nearest rounding).
        Timed here and used nowhere in the port."""
        xf = x.float()
        amax = xf.abs().amax(dim=1, keepdim=True)
        xq = torch.round(xf * (127.0 / amax.clamp_min(1e-30))).to(torch.int8)
        y = torch._int_mm(xq, wq_t.t()).float() * (amax * (1.0 / 127.0)) * ws
        return (y if bias is None else y + bias).to(x.dtype)

    times, main, eval_ms = {}, None, {}
    for layer, (k_in, n_out) in TRUNK_B.items():
        for what, (k, n), sr in (("forward", (k_in, n_out), False), ("dgrad", (n_out, k_in), True)):
            x = fenced(torch, torch.randn(M_TRAIN, k, generator=gen, device=dev)
                       .to(torch.bfloat16))
            w = torch.randn(n, k, generator=gen, device=dev) * 0.05
            wq, ws = TQ.quantize_cols(w.t())
            wb = w.to(torch.bfloat16)
            bias = None if sr else torch.randn(n, generator=gen, device=dev) * 0.1
            bias_b = None if bias is None else bias.to(torch.bfloat16)
            tag = f"{layer} {what} M={M_TRAIN} K={k} N={n}"
            worst_abs = max(worst_abs, held(tag, x, wq, ws, bias, sr, torch.bfloat16))
            if what == "forward":  # evaluate() gives K6 the same layers at batch 128
                x_eval = fenced(torch, x[:M_EVAL])
                worst_abs = max(worst_abs, held(f"{layer} forward M={M_EVAL} K={k} N={n}",
                                                x_eval, wq, ws, bias, False, torch.bfloat16))
                eval_ms[layer] = cuda_ms(
                    lambda: TQ.qmm(x_eval, wq, ws, bias, seed, False, torch.bfloat16), 5)
                del x_eval
            xq = TQ.quantize_rows(x, seed, sr)[0]
            fns = {"plain": lambda: TQ.qmm_plain(x, wq, ws, bias, seed, sr, torch.bfloat16),
                   "kernel": lambda: TQ.qmm(x, wq, ws, bias, seed, sr, torch.bfloat16),
                   "bf16 F.linear": lambda: torch.nn.functional.linear(x, wb, bias_b),
                   "library": lambda: int_mm_library(x, wq.t(), ws, bias),
                   "torch._int_mm alone": lambda: torch._int_mm(xq, wq)}
            best, runs = in_turns(fns, 5)
            split = kernel_split(torch, fns["kernel"])
            bound_ms, bound_by = bound(nbytes(x, wq, ws, bias) + M_TRAIN * n * 2,
                                        2.0 * M_TRAIN * k * n, "int8")
            print(f"  K6 {tag} bf16, ms per call: {runs}; K6's two kernels apart: "
                  f"{json.dumps(split)}; bound {bound_ms:.4f} ms ({bound_by})", flush=True)
            times[f"{layer} {what}"] = {**{name: best[name] for name in fns},
                                        "bound": bound_ms, "kernels": split}
            if (layer, what) == ("qkv", "forward"):
                main = {"ms": best["kernel"], "plain_ms": best["plain"],
                        "library_ms": best["library"], "bound_ms": bound_ms,
                        "bound_by": bound_by, "int_mm_ms": best["torch._int_mm alone"]}
            del x, w, wq, wb, xq
    print(f"  K6 at evaluate()'s shapes (M={M_EVAL}, bf16, nearest, bias): {n_cases} cases so "
          f"far, {unequal} not equal to the bit; ms per call: "
          + ", ".join(f"{layer} {t:.4f}" for layer, t in eval_ms.items()), flush=True)
    times.update({f"{layer} forward M={M_EVAL}": {"kernel": t} for layer, t in eval_ms.items()})
    return {"max_abs_err": worst_abs, **main, "other_ms": times}


def phase11(torch, dev):
    from uncertainty_vit_tpu_torch.ops import quant as TQ

    gen = torch.Generator(device=dev).manual_seed(11)
    seed = torch.tensor([0x0FEDCBA987654321], dtype=torch.int64, device=dev)
    n_cases = 0

    def held(tag, x, g):
        nonlocal n_cases
        sx, sg = TQ._col_scales(x), TQ._col_scales(g)
        inv_x, inv_g = sx.reciprocal(), sg.reciprocal()
        before = TQ.wgrad.launches
        acc = TQ.wgrad_acc(x, g, inv_x, inv_g, seed)
        check(TQ.wgrad.launches == before + 1, "wgrad_acc did not launch K7 once")
        ref = TQ.wgrad_acc_plain(x, g, inv_x, inv_g, seed)
        again = TQ.wgrad_acc(x, g, inv_x, inv_g, seed)
        dw, dw_ref = TQ.wgrad(x, g, seed), TQ.wgrad_plain(x, g, seed)
        torch.cuda.synchronize()
        check(acc.dtype == torch.int32 and acc.shape == ref.shape and acc.t().is_contiguous(),
              f"K7's sums are not an int32 [K, N] view of an [N, K] buffer ({tag})")
        diff = (acc.long() - ref.long()).abs().max().item()
        check(torch.equal(acc, ref), f"K7's int32 sums differ from the plain version's ({tag}: "
              f"by up to {diff})")
        check(torch.equal(acc, again), f"K7's sums differ between two runs ({tag})")
        check(torch.equal(dw, dw_ref), f"wgrad() differs from wgrad_plain() ({tag})")
        check(not torch.equal(dw, TQ.wgrad(x, g, seed + 1)), f"K7 ignores its seed ({tag})")
        n_cases += 1
        return (dw - dw_ref).abs().max().item()

    for dtype, (k, n) in itertools.product((torch.bfloat16, torch.float32), quant_shapes()):
        for m in (8, 197, 1000):
            x = fenced(torch, torch.randn(m, k, generator=gen, device=dev).to(dtype))
            g = fenced(torch, (torch.randn(m, n, generator=gen, device=dev) * 0.01).to(dtype))
            held(f"{str(dtype)[6:]} M={m} K={k} N={n}", x, g)
    print(f"  K7: {n_cases} cases (bf16/f32 x {len(quant_shapes())} shapes x M 8/197/1000, NaN "
          f"planted around x and g): int32 sums equal to the plain version's and bit-identical "
          f"between two runs", flush=True)
    try:
        TQ.wgrad(torch.zeros(4, 128, device=dev), torch.zeros(4, 128, device=dev), seed)
        check(False, "K7 took M=4")
    except ValueError:
        pass

    def int_mm_library(x, g):
        """The library yardstick: torch._int_mm between plain PyTorch passes
        that take the column scales, quantize both operands (to nearest),
        transpose both copies (the tokens contiguous in each, as the kernel's
        operands lie: int8 products take both operands with the contraction
        contiguous) and dequantize the result. Timed here and used nowhere
        in the port."""
        sx, sg = TQ._col_scales(x), TQ._col_scales(g)
        xq_t = torch.round(x.float() / sx).to(torch.int8).t().contiguous()
        gq = torch.round(g.float() / sg).to(torch.int8).t().contiguous().t()
        return torch._int_mm(xq_t, gq).float() * sx.reshape(-1, 1) * sg

    times, main, worst = {}, None, 0.0
    for layer, (k, n) in TRUNK_B.items():
        x = fenced(torch, torch.randn(M_TRAIN, k, generator=gen, device=dev).to(torch.bfloat16))
        g = fenced(torch, (torch.randn(M_TRAIN, n, generator=gen, device=dev) * 0.01)
                   .to(torch.bfloat16))
        tag = f"{layer} M={M_TRAIN} K={k} N={n}"
        worst = max(worst, held(tag, x, g))
        sx, sg = TQ._col_scales(x), TQ._col_scales(g)
        inv_x, inv_g = sx.reciprocal(), sg.reciprocal()
        # both copies with the tokens contiguous, as K7's product reads them
        xq_t = torch.round(x.float() * inv_x).to(torch.int8).t().contiguous()
        gq = torch.round(g.float() * inv_g).to(torch.int8).t().contiguous().t()
        fns = {"plain": lambda: TQ.wgrad_plain(x, g, seed),
               "kernel": lambda: TQ.wgrad(x, g, seed),
               "launcher alone": lambda: TQ.wgrad_acc(x, g, inv_x, inv_g, seed),
               "bf16 x.T @ g": lambda: x.t() @ g,
               "library": lambda: int_mm_library(x, g),
               "torch._int_mm alone": lambda: torch._int_mm(xq_t, gq)}
        best, runs = in_turns(fns, 5)
        split = kernel_split(torch, fns["launcher alone"])
        bound_ms, bound_by = bound(nbytes(x, g, inv_x, inv_g) + k * n * 4,
                                    2.0 * M_TRAIN * k * n, "int8")
        print(f"  K7 {tag} bf16, ms per call (\"kernel\" is wgrad() with its column-scale and "
              f"dequantizing passes, \"launcher alone\" K7's two kernels): {runs}; the "
              f"launcher's kernels apart: {json.dumps(split)}; bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        times[layer] = {**{name: best[name] for name in fns}, "bound": bound_ms,
                        "kernels": split}
        if layer == "qkv":
            main = {"ms": best["kernel"], "plain_ms": best["plain"],
                    "library_ms": best["library"], "bound_ms": bound_ms, "bound_by": bound_by,
                    "int_mm_ms": best["torch._int_mm alone"]}
        del x, g, xq_t, gq
    return {"max_abs_err": worst, **main, "other_ms": times}


@contextlib.contextmanager
def quant_on_plain(TQ):
    """Inside, ``qmm`` and ``wgrad`` compute with their plain versions on the
    card too (same seeds and so the same rounding bits) and launch neither K6
    nor K7: the reference that the int8 model on the kernels is held against.
    Only this script does so; the package never takes a plain version for a
    CUDA tensor."""
    qmm, wgrad = TQ.qmm, TQ.wgrad
    TQ.qmm, TQ.wgrad = TQ.qmm_plain, TQ.wgrad_plain
    try:
        yield
    finally:
        TQ.qmm, TQ.wgrad = qmm, wgrad


def phase12(torch, FA, dev, k6_ms, k7_ms):
    """k6_ms, k7_ms: phase 10's and phase 11's times per layer at the train
    step's shapes, for the account of where the int8 step's time goes."""
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.evals.classification import evaluate, make_eval_forward
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )
    from uncertainty_vit_tpu_torch.train.engine_finetune import (
        FinetuneHParams, init_finetune_state, make_finetune_train_step,
    )
    from uncertainty_vit_tpu_torch.train.optim import make_optimizer
    from uncertainty_vit_tpu_torch.train.schedules import cosine_schedule

    FA.BOUNDED_SCORES = True  # as phases 2 and 4
    cfg = get_preset("beit_base_patch16_224", use_shared_rel_pos_bias=True, init_values=0.1,
                     quant="int8")
    gen = torch.Generator(device=dev).manual_seed(12)

    qmm, wgrad = TQ.qmm, TQ.wgrad  # the counting wrappers, also inside quant_on_plain()

    def counts():
        return {**attention_counts(FA), "K6": qmm.launches, "K7": wgrad.launches}

    def reset():
        reset_attention_counts(FA)
        qmm.launches = wgrad.launches = 0

    # --- evaluate(): phase 2's model and batches with the int8 trunk
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
    # a wider head than the init's 0.02, so that the logits stand clear of
    # the int8 noise floor they are compared at
    trunc_normal(0.1, 2.0)(model.head.weight, gen)
    bf16_model = VisionTransformer(cfg.replace(quant="none"), dtype=torch.bfloat16, device=dev,
                                   generator=gen)
    bf16_model.load_state_dict(model.state_dict())
    bs, nb = 128, 4
    images = [torch.randint(0, 256, (bs, 224, 224, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(nb)]
    labels = [torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
              for _ in range(nb)]

    def batches():
        for u8, lbl in zip(images, labels):
            yield normalize(to_float(u8), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD), lbl

    launches = {}
    torch.cuda.reset_peak_memory_stats()
    reset()
    metrics = evaluate(model, batches())  # no generator: evaluation draws nothing
    torch.cuda.synchronize()
    launches["int8_evaluate"] = counts()
    peak_eval = torch.cuda.max_memory_allocated() / 2**30
    print(f"  evaluate(): launches {launches['int8_evaluate']}; {json.dumps(metrics)}",
          flush=True)
    check(launches["int8_evaluate"] == {"K1": cfg.depth * nb, "K2": 0, "K3": 0, "K4": 0,
                                        "K6": 4 * cfg.depth * nb, "K7": 0},
          f"evaluate() launched {launches['int8_evaluate']}, expected K6 {4 * cfg.depth} and K1 "
          f"{cfg.depth} per forward")
    check(all(math.isfinite(v) for v in metrics.values()), "non-finite metric")
    fwd, bf16_fwd = make_eval_forward(model), make_eval_forward(bf16_model)
    x0 = next(batches())[0]
    logits = fwd(x0)
    check(tuple(logits.shape) == (bs, cfg.num_classes) and logits.dtype == torch.float32
          and torch.isfinite(logits).all().item(), "int8 logits are not finite f32 [128, 1000]")
    with quant_on_plain(TQ):
        before = counts()
        ref = fwd(x0)
        check(counts()["K6"] == before["K6"], "the plain reference forward launched K6")
    diff = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    exact = bf16_fwd(x0)
    print(f"  logits K6 vs its plain version: max|diff|={diff:.3e}, max|logit|={scale:.3e}, "
          f"ratio {diff / scale:.3e} (bound {LOGIT_REL_BOUND}); int8 vs bf16 trunk on the same "
          f"weights: ratio {(logits - exact).abs().max().item() / exact.abs().max().item():.3e}",
          flush=True)
    check(diff <= LOGIT_REL_BOUND * scale, "int8 logits disagree with the plain versions'")
    best, runs = in_turns({"bf16": lambda: bf16_fwd(x0), "int8": lambda: fwd(x0)}, 5)
    eval_rates = {name: [bs * 1000.0 / ms for ms in v] for name, v in runs.items()}
    print(f"  eval forward img/s at batch {bs} (information only): int8 {eval_rates['int8']}, "
          f"bf16 trunk {eval_rates['bf16']}; peak memory of evaluate() {peak_eval:.2f} GiB",
          flush=True)
    del model, bf16_model, images, logits, ref, exact

    # --- the finetune train step: phase 4's step with the int8 trunk
    tcfg = cfg.replace(drop_path_rate=0.1)
    bs = 160
    x = torch.randn(bs, 224, 224, 3, generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
    hp = FinetuneHParams(num_classes=cfg.num_classes)
    lr = cosine_schedule(4e-3, 1e-6, 10_000, warmup_steps=500)

    def build(state_dict=None, **overrides):
        m = VisionTransformer(tcfg.replace(**overrides), dtype=torch.bfloat16, device=dev,
                              generator=gen)
        if state_dict is None:
            trunc_normal(0.2, 2.0)(m.rel_pos_bias.relative_position_bias_table, gen)
        else:
            m.load_state_dict(state_dict)
        opt = make_optimizer(m, weight_decay=0.05, layer_decay=0.65, depth=tcfg.depth)
        state = init_finetune_state(m, opt)
        state.step = 1  # the warm-up's learning rate is 0 at update 0
        return m, state, make_finetune_train_step(m, opt, hp, lr)

    def gens(seed):
        return (torch.Generator(device=dev).manual_seed(seed), torch.Generator().manual_seed(seed))

    tmodel, state, step = build()
    init = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    n_steps = 3
    torch.cuda.reset_peak_memory_stats()
    reset()
    ms = [step(state, x, y, *gens(11 + i)) for i in range(n_steps)]
    torch.cuda.synchronize()
    launches["int8_train_step"] = counts()
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {n_steps} steps at batch {bs}: launches {launches['int8_train_step']}; " + "; ".join(
        f"loss {float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f}" for m in ms),
        flush=True)
    d = cfg.depth * n_steps
    check(launches["int8_train_step"] == {"K1": d, "K2": d, "K3": 0, "K4": 0, "K6": 8 * d,
                                          "K7": 4 * d},
          f"{n_steps} int8 train steps launched {launches['int8_train_step']}, expected per "
          f"step K6 {8 * cfg.depth}, K7 {4 * cfg.depth}, K1 and K2 {cfg.depth}")
    check(all(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))
              for m in ms), "non-finite loss or grad norm")
    moved = 0
    for k, v in tmodel.state_dict().items():
        check(torch.isfinite(v).all().item(), f"non-finite parameter {k}")
        moved += int(not torch.equal(v, init[k]))
    check(moved == len(init), f"only {moved} of {len(init)} parameter tensors changed")

    # one step from the same weights and seeds: kernels, their plain versions
    # (the same rounding bits), and the bf16 trunk on the same batch
    _, st_k, step_k = build(init)
    m_k = step_k(st_k, x, y, *gens(30))
    del st_k, step_k
    _, st_p, step_p = build(init)
    before = counts()
    with quant_on_plain(TQ):
        m_p = step_p(st_p, x, y, *gens(30))
    torch.cuda.synchronize()
    check(counts()["K6"] == before["K6"] and counts()["K7"] == before["K7"],
          "the plain reference step launched K6 or K7")
    del st_p, step_p
    _, st_b, step_b = build(init, quant="none")
    m_b = step_b(st_b, x, y, *gens(30))
    loss_k, loss_p, loss_b = (float(m["loss"]) for m in (m_k, m_p, m_b))
    gn_k, gn_p, gn_b = (float(m["grad_norm"]) for m in (m_k, m_p, m_b))
    print(f"  one step, K6/K7 vs their plain versions vs the bf16 trunk: loss {loss_k:.6f} / "
          f"{loss_p:.6f} / {loss_b:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f} / {gn_b:.6f}",
          flush=True)
    check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
          "the int8 step's loss disagrees with the plain versions'")
    check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
          "the int8 step's grad norm disagrees with the plain versions'")

    rates = {"int8": [], "bf16": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        st, fn = (state, step) if name == "int8" else (st_b, step_b)
        g = gens(20)
        rates[name].append(bs * 1000.0 / cuda_ms(lambda: fn(st, x, y, *g), 5))
    print(f"  train step img/s at batch {bs} (information only): int8 {rates['int8']}, bf16 "
          f"trunk {rates['bf16']}; peak memory of the {n_steps} int8 steps {peak_train:.2f} GiB",
          flush=True)

    # where the int8 step's time goes: this run's kernel times at the step's
    # shapes times their launches per step, and the weight passes timed here
    # (per layer: the forward's quantize_cols, the dgrad's and its transposed
    # int8 copy, the layer-scale fold left out)
    def weight_passes(w):
        TQ.quantize_cols(w.t())
        TQ.quantize_cols(w)[0].t().contiguous()

    w_ms = sum(cuda_ms(lambda w=torch.randn(n, k, generator=gen, device=dev): weight_passes(w),
                       10) for k, n in TRUNK_B.values())
    step_ms = bs * 1000.0 / max(rates["int8"])
    parts = {
        "K6 forward": sum(k6_ms[f"{layer} forward"]["kernel"] for layer in TRUNK_B),
        "K6 dgrad": sum(k6_ms[f"{layer} dgrad"]["kernel"] for layer in TRUNK_B),
        "K7's two kernels": sum(k7_ms[layer]["launcher alone"] for layer in TRUNK_B),
        "wgrad()'s column-scale and dequantizing passes": sum(
            k7_ms[layer]["kernel"] - k7_ms[layer]["launcher alone"] for layer in TRUNK_B),
        "weight passes": w_ms,
    }
    parts = {name: cfg.depth * ms for name, ms in parts.items()}
    parts["the rest (attention, LayerNorm, GELU, casts, optimizer, host)"] = \
        step_ms - sum(parts.values())
    bf16_gemms = 3 * cfg.depth * sum(k6_ms[f"{layer} forward"]["bf16 F.linear"]
                                     for layer in TRUNK_B)
    print(f"  the int8 step's {step_ms:.1f} ms by this run's kernel times x launches per step: "
          + "; ".join(f"{name} {ms:.1f}" for name, ms in parts.items())
          + f"; the bf16 matmuls they replace ~{bf16_gemms:.1f} (3 x 12 x F.linear at the "
          f"forward shapes)", flush=True)
    return launches


def phase13(torch, FA, dev):
    """A head width the attention kernels do not take (80: the
    beit_huge_patch16_224 preset) runs on the plain attention, as in the
    reference."""
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.train.engine_finetune import (
        FinetuneHParams, init_finetune_state, make_finetune_train_step,
    )
    from uncertainty_vit_tpu_torch.train.optim import make_optimizer
    from uncertainty_vit_tpu_torch.train.schedules import cosine_schedule

    cfg = get_preset("beit_huge_patch16_224", use_shared_rel_pos_bias=True, init_values=0.1,
                     depth=2)
    check(cfg.head_dim == 80, f"the huge preset has head_dim {cfg.head_dim}")
    gen = torch.Generator(device=dev).manual_seed(13)
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
    trunc_normal(0.1, 2.0)(model.head.weight, gen)
    f32_model = VisionTransformer(cfg.replace(use_flash_attention=False), dtype=torch.float32,
                                  device=dev, generator=gen)
    f32_model.load_state_dict(model.state_dict())
    x = torch.randn(8, 224, 224, 3, generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (8,), generator=gen, device=dev)
    reset_attention_counts(FA)
    model.eval()
    f32_model.eval()
    with torch.no_grad():
        logits, ref = model(x), f32_model(x)
    diff, scale = (logits - ref).abs().max().item(), ref.abs().max().item()
    print(f"  2-deep beit_huge_patch16_224 (width {cfg.embed_dim}, head_dim 80): logits bf16 vs "
          f"f32 on the plain attention: max|diff|={diff:.3e}, max|logit|={scale:.3e}, ratio "
          f"{diff / scale:.3e} (bound {LOGIT_REL_BOUND})", flush=True)
    check(torch.isfinite(logits).all().item() and diff <= LOGIT_REL_BOUND * scale,
          "the head_dim-80 logits disagree with the f32 model's")
    opt = make_optimizer(model, weight_decay=0.05, layer_decay=0.65, depth=cfg.depth)
    state = init_finetune_state(model, opt)
    state.step = 1
    step = make_finetune_train_step(model, opt, FinetuneHParams(num_classes=cfg.num_classes),
                                    cosine_schedule(4e-3, 1e-6, 10_000, warmup_steps=500))
    m = step(state, x, y, torch.Generator(device=dev).manual_seed(1),
             torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    print(f"  one train step: loss {float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f}; "
          f"attention launches {attention_counts(FA)}", flush=True)
    check(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"])),
          "non-finite loss or grad norm at head_dim 80")
    check(attention_counts(FA) == {"K1": 0, "K2": 0, "K3": 0, "K4": 0},
          "a head_dim-80 model launched an attention kernel")


# K5's query and key counts on the card: one query row, a tile-ragged 63, and
# the shards of N = 1025 at S = 4 (257) and S = 2 (513); 65, 577 and 1025 keys
# (1 mod 64: one valid key in the last k/v tile).
CROSS_NQ = (1, 63, 257, 513)
CROSS_NK = (65, 577, 1025)


def cross_parts(got):
    """(dq, dk, dv, dbias, dqvb) of K5's backward (dq, dkv, dbias, dqvb)."""
    dq, dkv, dbias, dqvb = got
    return (dq, *dkv.chunk(2, dim=-1), dbias, dqvb)


def cross_plain_bwd(torch, FA, q, kv, bias, qvb, lse, out, g, scale, h, step=2):
    """K5's two plain versions `step` images at a time, the row sums formed
    from the forward's output `out`, or with `out` None recomputed as
    rowsum(t) over the keys: (dq, dk, dv, dbias, dqvb)."""
    c = q.shape[-1]
    dq, dkv, dbias = [], [], None
    for i in range(0, q.shape[0], step):
        sl = slice(i, i + step)
        dq_i, db_i, c_i = FA.cross_bwd_dq_plain(q[sl], kv[sl], bias, qvb, lse[sl], g[sl], scale, h,
                                                out=None if out is None else out[sl])
        dkv.append(FA.cross_bwd_dkv_plain(q[sl], kv[sl], bias, qvb, lse[sl], c_i, g[sl], scale, h))
        dq.append(dq_i)
        if db_i is not None:
            dbias = db_i if dbias is None else dbias + db_i
    dq, dkv = torch.cat(dq), torch.cat(dkv)
    dqvb = FA.cross_qv_bias_grad(dq, dkv) if qvb is not None else None
    return dq, dkv[..., :c], dkv[..., c:], dbias, dqvb


def cross_plain_bwd_both(torch, FA, q, kv, bias, qvb, lse, out, g, scale, h):
    """``cross_plain_bwd`` with the row sums recomputed, then formed from
    ``out``: the two references of ``held_bwd_both``."""
    return [cross_plain_bwd(torch, FA, q, kv, bias, qvb, lse, o, g, scale, h) for o in (None, out)]


def cross_counts(FA) -> dict:
    return {"K5": FA.cross_qkv_attention.launches, "K5_bwd": FA.cross_qkv_attention_bwd.launches}


def reset_cross_counts(FA) -> None:
    FA.cross_qkv_attention.launches = FA.cross_qkv_attention_bwd.launches = 0


def phase14(torch, FA, dev):
    gen = torch.Generator(device=dev).manual_seed(14)
    h, c, scale = 16, 1024, 64**-0.5
    worst, n_cases = 0.0, 0
    for dtype, nq, nk in itertools.product((torch.bfloat16, torch.float32), CROSS_NQ, CROSS_NK):
        name = str(dtype)[6:]
        q = torch.randn(2, nq, c, generator=gen, device=dev).to(dtype)
        kv = torch.randn(2, nk, 2 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, nq, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, nq, nk, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        for has_bias, has_qvb, bounded in itertools.product((True, False), repeat=3):
            b_ = bias if has_bias else None
            q_ = qvb if has_qvb else None
            tag = (f"{name} Nq={nq} Nk={nk} bias={has_bias:d} qv_bias={has_qvb:d} "
                   f"bounded={bounded:d}")
            before, before_s = cross_counts(FA), attention_counts(FA)
            out, lse = FA.cross_qkv_attention(q, kv, b_, q_, scale, h, bounded_scores=bounded,
                                              want_lse=True)
            out_only = FA.cross_qkv_attention(q, kv, b_, q_, scale, h, bounded_scores=bounded)
            got = FA.cross_qkv_attention_bwd(q, kv, b_, q_, lse, g, scale, h, out=out)
            again = FA.cross_qkv_attention_bwd(q, kv, b_, q_, lse, g, scale, h, out=out)
            after = cross_counts(FA)
            check(after["K5"] == before["K5"] + 2 and after["K5_bwd"] == before["K5_bwd"] + 2
                  and attention_counts(FA) == before_s,
                  f"K5 was not launched twice each way, or K1-K4 were ({tag})")
            ref, ref_lse = FA.cross_fwd_plain(q, kv, b_, q_, scale, h, bounded_scores=bounded)
            ref_bwd = cross_plain_bwd_both(torch, FA, q, kv, b_, q_, lse, out, g, scale, h)
            torch.cuda.synchronize()
            tol = OUT_TOL[name]
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            check(torch.isfinite(out.float()).all().item() and out.shape == q.shape
                  and out.dtype == dtype, f"K5 output is not finite [2, Nq, C] ({tag})")
            check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
                  f"K5 output disagrees with the plain version ({tag}: {err:.3e})")
            check(lse_err <= LSE_ATOL, f"K5 lse disagrees with the plain version ({tag})")
            check(torch.equal(out, out_only), f"K5 output depends on want_lse ({tag})")
            check(got[0].dtype == dtype and got[0].shape == q.shape and got[1].shape == kv.shape,
                  f"K5 dq / dkv dtype or shape ({tag})")
            check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                  f"K5's dq or dkv differs between two runs ({tag})")
            abs_err, msg = held_bwd_both(torch, "K5", tag, cross_parts(got), ref_bwd,
                                         BWD_TOL[name])
            worst, n_cases = max(worst, err, abs_err), n_cases + 1
            if has_bias and has_qvb and not bounded:
                print(f"  K5 {tag}: max|out-plain|={err:.3e} max|lse-plain|={lse_err:.3e}; "
                      f"{msg}", flush=True)
        del q, kv, g, bias, out, lse, got, again, ref, ref_bwd
    print(f"  K5: {n_cases} cases within K1's and K2's bounds (the backward of both plain "
          f"versions: the row sums recomputed, and formed from the output), dq and dkv "
          f"bit-identical between two runs, worst max|plain diff| {worst:.3e}", flush=True)
    check(FA.cross_qkv_attention(torch.randn(1, 1, c, device=dev), torch.randn(1, 1, 2 * c,
                                 device=dev), None, None, scale, h).shape == (1, 1, c),
          "K5 at one query row and one key")

    # NaN planted right before and right behind q, kv, g, the output and the
    # lse changes no bit of out, lse, dq or dkv
    for dtype, (nq, nk) in itertools.product((torch.bfloat16, torch.float32),
                                             ((63, 577), (513, 1025))):
        q = torch.randn(2, nq, c, generator=gen, device=dev).to(dtype)
        kv = torch.randn(2, nk, 2 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, nq, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, nq, nk, generator=gen, device=dev) * 0.5
        out, lse = FA.cross_qkv_attention(q, kv, bias, None, scale, h, bounded_scores=False,
                                          want_lse=True)
        got = FA.cross_qkv_attention_bwd(q, kv, bias, None, lse, g, scale, h, out=out)
        f_q, f_kv, f_g, f_lse = (fenced(torch, t) for t in (q, kv, g, lse))
        f_out, f_lse_out = FA.cross_qkv_attention(f_q, f_kv, bias, None, scale, h,
                                                  bounded_scores=False, want_lse=True)
        f_got = FA.cross_qkv_attention_bwd(f_q, f_kv, bias, None, f_lse, f_g, scale, h,
                                           out=fenced(torch, out))
        torch.cuda.synchronize()
        tag = f"{str(dtype)[6:]} Nq={nq} Nk={nk}"
        check(torch.equal(out, f_out) and torch.equal(lse, f_lse_out),
              f"K5 reads behind the end of q or kv ({tag})")
        check(torch.equal(got[0], f_got[0]) and torch.equal(got[1], f_got[1])
              and torch.isfinite(f_got[2]).all().item(),
              f"K5's backward reads behind the end of q, kv, g, out or lse ({tag})")
        print(f"  K5 {tag}: NaN planted around q, kv, g, out and lse changes no bit of out, lse, "
              f"dq and dkv", flush=True)
        del q, kv, g, bias, got, f_got, f_q, f_kv, f_g

    # the S shards of K5 together against K3 and K4 of the whole sequence
    for dtype, n, s in itertools.product((torch.bfloat16, torch.float32), (577, 1025), (2, 4)):
        name = str(dtype)[6:]
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        out, lse = FA.fused_qkv_attention(qkv, bias, qvb, None, scale, h, bounded_scores=True,
                                          want_lse=True)
        dqkv, dbias, dqvb = FA.fused_qkv_attention_bwd(qkv, bias, qvb, lse, g, scale, h, out=out)
        kv = qkv[..., c:].contiguous()
        outs, dqs, dkv, dbias_rows, dqvb_sum = [], [], 0.0, [], 0.0
        m = -(-n // s)
        for r in range(s):
            rows = slice(r * m, min((r + 1) * m, n))
            q_r, b_r = qkv[:, rows, :c].contiguous(), bias[:, rows].contiguous()
            o_r, l_r = FA.cross_qkv_attention(q_r, kv, b_r, qvb, scale, h, bounded_scores=True,
                                              want_lse=True)
            dq_r, dkv_r, db_r, dqvb_r = FA.cross_qkv_attention_bwd(
                q_r, kv, b_r, qvb, l_r, g[:, rows].contiguous(), scale, h, out=o_r)
            outs.append(o_r), dqs.append(dq_r), dbias_rows.append(db_r)
            dkv, dqvb_sum = dkv + dkv_r.float(), dqvb_sum + dqvb_r
        torch.cuda.synchronize()
        tag = f"{name} N={n} S={s}"
        o = torch.cat(outs, dim=1)
        err = (o.float() - out.float()).abs().max().item()
        check(torch.allclose(o.float(), out.float(), atol=OUT_TOL[name], rtol=OUT_TOL[name]),
              f"K5's shards disagree with K3's output ({tag}: {err:.3e})")
        tol = BWD_TOL[name]
        parts = {"dq": (torch.cat(dqs, dim=1), dqkv[..., :c], tol["dqkv"]),
                 "dkv": (dkv, dqkv[..., c:], tol["dqkv"]),
                 "dbias": (torch.cat(dbias_rows, dim=1), dbias, tol["dbias"]),
                 "dqvb": (dqvb_sum, dqvb, tol["dqvb"])}
        msg = []
        for part, (a, ref, bound_) in parts.items():
            rel = _rel_err(a, ref)
            msg.append(f"{part} rel={rel:.3e}")
            check(rel <= bound_, f"K5's shards disagree with K4's {part} ({tag}: {rel:.3e})")
        worst = max(worst, err)
        print(f"  K5's {s} shards vs K3/K4 of the whole sequence, {tag}: max|out-K3|={err:.3e}; "
              + ", ".join(msg), flush=True)
        del qkv, g, bias, out, lse, dqkv, dbias, kv, outs, dqs, dkv, dbias_rows

    # at every shape phase 15's path gives K5 (bf16, a bias, the q/v bias,
    # bounded; Nk = 1025): evaluate() at B=16 (no lse) and the train step at
    # B=8 (the lse and the backward), on rank 0's 513 query rows and rank 1's
    # 512 (whole 64-row tiles, no query tail); the plain versions 4 images
    # (forward) and 2 images (backward) at a time
    n = 1025
    for bsz, nq, train in ((16, 513, False), (16, 512, False), (8, 513, True), (8, 512, True)):
        q = torch.randn(bsz, nq, c, generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn(bsz, n, 2 * c, generator=gen, device=dev).to(torch.bfloat16)
        bias = torch.randn(h, nq, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        before = cross_counts(FA)
        if train:
            g = torch.randn(bsz, nq, c, generator=gen, device=dev).to(torch.bfloat16)
            out, lse = FA.cross_qkv_attention(q, kv, bias, qvb, scale, h, bounded_scores=True,
                                              want_lse=True)
            got = FA.cross_qkv_attention_bwd(q, kv, bias, qvb, lse, g, scale, h, out=out)
        else:
            out = FA.cross_qkv_attention(q, kv, bias, qvb, scale, h, bounded_scores=True)
        after = cross_counts(FA)
        check(after["K5"] == before["K5"] + 1
              and after["K5_bwd"] == before["K5_bwd"] + int(train), "K5 was not launched")
        refs = [FA.cross_fwd_plain(q[i:i + 4], kv[i:i + 4], bias, qvb, scale, h,
                                   bounded_scores=True) for i in range(0, bsz, 4)]
        ref = torch.cat([r[0] for r in refs])
        torch.cuda.synchronize()
        tag = f"phase 15's {'train step' if train else 'evaluate()'} B={bsz} Nq={nq} Nk={n}"
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.isfinite(out.float()).all().item() and out.shape == q.shape,
              f"K5 output is not finite [B, Nq, C] ({tag})")
        check(torch.allclose(out.float(), ref.float(), atol=OUT_TOL["bfloat16"],
                             rtol=OUT_TOL["bfloat16"]),
              f"K5 output disagrees with the plain version ({tag}: {err:.3e})")
        msg = ""
        if train:
            lse_err = (lse - torch.cat([r[1] for r in refs])).abs().max().item()
            check(lse_err <= LSE_ATOL, f"K5 lse disagrees with the plain version ({tag})")
            abs_err, msg = held_bwd_both(torch, "K5", tag, cross_parts(got), cross_plain_bwd_both(
                torch, FA, q, kv, bias, qvb, lse, out, g, scale, h), BWD_TOL["bfloat16"])
            worst = max(worst, abs_err)
            msg = f" max|lse-plain|={lse_err:.3e}; {msg}"
        worst = max(worst, err)
        print(f"  K5 at {tag}: max|out-plain|={err:.3e}{msg}", flush=True)
        del q, kv, bias, out, refs, ref
        if train:
            del lse, got, g

    # one shard at the ViT-L/16 512 train shape (B=8, N=1025, H=16, bf16, bias,
    # bounded, the lse kept) for S = 2 (Nq = 513) and S = 4 (Nq = 257), beside
    # K3 (with the lse) and K4 of the whole sequence, the plain versions and
    # one library call (scaled_dot_product_attention with the bias as a float
    # mask, forward, and autograd's backward of it)
    bsz, n = 8, 1025
    qkv = torch.randn(bsz, n, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    g_full = torch.randn(bsz, n, c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
    kv = qkv[..., c:].contiguous()
    out_full, lse_full = FA.fused_qkv_attention(qkv, bias, None, None, scale, h,
                                                bounded_scores=True, want_lse=True)
    fns, shards = {}, {}
    for s in (2, 4):
        nq = -(-n // s)
        q = qkv[:, :nq, :c].contiguous()
        b_r = bias[:, :nq].contiguous()
        g = g_full[:, :nq].contiguous()
        out, lse = FA.cross_qkv_attention(q, kv, b_r, None, scale, h, bounded_scores=True,
                                          want_lse=True)
        k_h = kv[..., :c].view(bsz, n, h, 64).transpose(1, 2)
        v_h = kv[..., c:].view(bsz, n, h, 64).transpose(1, 2)
        q_leaf = q.view(bsz, nq, h, 64).transpose(1, 2).detach().requires_grad_()
        kv_leaves = (k_h.detach().requires_grad_(), v_h.detach().requires_grad_())
        mask_leaf = b_r.to(torch.bfloat16).requires_grad_()
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            q_leaf, *kv_leaves, attn_mask=mask_leaf, scale=scale)
        g_h = g.view(bsz, nq, h, 64).transpose(1, 2)
        shards[s] = (q, b_r, g, lse, out, lib_out)
        fns[f"S={s} forward"] = (lambda q=q, b_r=b_r: FA.cross_qkv_attention(
            q, kv, b_r, None, scale, h, bounded_scores=True, want_lse=True))
        fns[f"S={s} backward"] = (lambda q=q, b_r=b_r, g=g, lse=lse, out=out:
                                  FA.cross_qkv_attention_bwd(q, kv, b_r, None, lse, g, scale, h,
                                                             out=out))
        fns[f"S={s} plain forward"] = (lambda q=q, b_r=b_r: torch.cat([FA.cross_fwd_plain(
            q[i:i + 4], kv[i:i + 4], b_r, None, scale, h, bounded_scores=True)[0]
            for i in range(0, bsz, 4)]))
        fns[f"S={s} plain backward"] = (lambda q=q, b_r=b_r, g=g, lse=lse, out=out: cross_plain_bwd(
            torch, FA, q, kv, b_r, None, lse, out, g, scale, h))
        fns[f"S={s} library forward"] = (
            lambda q=q, mask=mask_leaf.detach(): torch.nn.functional.scaled_dot_product_attention(
                q.view(bsz, -1, h, 64).transpose(1, 2), k_h, v_h, attn_mask=mask, scale=scale))
        fns[f"S={s} library backward"] = (
            lambda lib_out=lib_out, q_leaf=q_leaf, kv_leaves=kv_leaves, mask_leaf=mask_leaf,
            g_h=g_h: torch.autograd.grad(lib_out, (q_leaf, *kv_leaves, mask_leaf), g_h,
                                         retain_graph=True))
        got = fns[f"S={s} forward"]()[0].float()
        ref = fns[f"S={s} plain forward"]().float()
        err = (got - ref).abs().max().item()
        check(torch.allclose(got, ref, atol=OUT_TOL["bfloat16"], rtol=OUT_TOL["bfloat16"]),
              f"K5 disagrees with the plain version at the timed S={s} shard ({err:.3e})")
        abs_err, msg = held_bwd_both(
            torch, "K5", f"timed S={s}", cross_parts(fns[f"S={s} backward"]()),
            cross_plain_bwd_both(torch, FA, q, kv, b_r, None, lse, out, g, scale, h),
            BWD_TOL["bfloat16"])
        worst = max(worst, err, abs_err)
        print(f"  K5 at the S={s} shard B={bsz} Nq={nq} Nk={n}: max|out-plain|={err:.3e}; {msg}",
              flush=True)
    fns["K3 whole, with lse"] = lambda: FA.fused_qkv_attention(
        qkv, bias, None, None, scale, h, bounded_scores=True, want_lse=True)
    fns["K4 whole"] = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse_full, g_full, scale,
                                                         h, out=out_full)
    best, runs = in_turns(fns, 5)
    print(f"  K5 one shard at B={bsz} N={n} H={h} D=64 bf16 (bias, bounded), ms per call: {runs}",
          flush=True)
    q, b_r, g, lse, out, _ = shards[2]
    nq = q.shape[1]
    # the function's own traffic: the backward's read of the output (for the
    # row sums) is this design's, not the function's
    bound_ms, bound_by = bound(nbytes(q, kv, b_r) + nbytes(q, lse)  # forward: out, lse
                               + nbytes(q, kv, g, lse, b_r) + nbytes(q, kv, b_r),  # backward
                               14.0 * bsz * h * nq * n * 64, "bfloat16")
    # "ms" and the others are forward + backward of the S = 2 shard
    return {"max_abs_err": worst, "ms": best["S=2 forward"] + best["S=2 backward"],
            "plain_ms": best["S=2 plain forward"] + best["S=2 plain backward"],
            "library_ms": best["S=2 library forward"] + best["S=2 library backward"],
            "bound_ms": bound_ms, "bound_by": bound_by, "other_ms": dict(best)}


def leaf_grad_norms(torch, model) -> dict:
    """Each parameter's gradient norm (f32), by name."""
    names, grads = zip(*((k, p.grad) for k, p in model.named_parameters()))
    return dict(zip(names, torch.stack([g.float().norm() for g in grads]).cpu().tolist()))


def seq2_rank(group, path):
    """One rank of phase 15: ViT-L/16 512 with its tokens split over the
    group, on the one card. Returns what the parent holds and prints."""
    import torch

    from uncertainty_vit_tpu_torch.evals.classification import evaluate, make_eval_forward
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )
    from uncertainty_vit_tpu_torch.parallel import seq

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    FA.BOUNDED_SCORES = True
    saved = torch.load(path, map_location=dev)
    u8, labels = saved["eval_images"], saved["eval_labels"]
    x = normalize(to_float(u8), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD)
    model, _, _ = large_512_model(torch, dev, saved["init"], group)
    out = {"rows": group.rows(model.cfg.num_patches + 1)}

    def counts():
        return {**attention_counts(FA), **cross_counts(FA)}

    def reset():
        reset_attention_counts(FA)
        reset_cross_counts(FA)

    torch.cuda.reset_peak_memory_stats()
    reset()
    out["metrics"] = evaluate(model, iter([(x, labels)]))
    torch.cuda.synchronize()
    out["evaluate"] = counts()
    out["peak_eval_gib"] = torch.cuda.max_memory_allocated() / 2**30
    fwd = make_eval_forward(model)
    out["logits"] = fwd(x).cpu()
    out["eval_ms"] = [host_ms(torch, lambda: fwd(x)) for _ in range(2)]
    del model, fwd

    tmodel, state, step = large_512_model(torch, dev, saved["init"], group, train=True)
    xt, yt = saved["train_x"], saved["train_y"]
    torch.cuda.reset_peak_memory_stats()
    reset()
    ms = []
    for i in range(2):
        ms.append(step(state, xt, yt, *large_512_gens(torch, dev, 11 + i)))
        if i == 0:  # the gradients after the group's sum, before step 2
            out["grad_norms"] = leaf_grad_norms(torch, tmodel)
    torch.cuda.synchronize()
    out["train_step"] = counts()
    out["peak_train_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["steps"] = [(float(m["loss"]), float(m["grad_norm"])) for m in ms]
    out["finite"] = all(torch.isfinite(v).all().item() for v in tmodel.state_dict().values())
    out["step_ms"] = [host_ms(torch, lambda: step(state, xt, yt, *large_512_gens(torch, dev, 20)))
                      for _ in range(2)]

    # the path's collectives, the least ms of 3 calls after one: a layer's k/v
    # gather in evaluate() at batch 16, its backward (an all-reduce of the
    # cotangent and a slice) at the train step's batch 8, and one 256 MB
    # bucket of the gradient sum
    n, c = tmodel.cfg.num_patches + 1, tmodel.cfg.embed_dim
    del tmodel, state, step
    rows, bs_eval = out["rows"][1] - out["rows"][0], x.shape[0]
    kv_eval = torch.randn(bs_eval, rows, 2 * c, device=dev).to(torch.bfloat16)
    kv_train = torch.randn(xt.shape[0], rows, 2 * c, device=dev).to(torch.bfloat16)
    kv_train.requires_grad_()
    gathered = seq.gather_tokens(kv_train, group, n)
    cot = torch.randn_like(gathered)
    bucket = torch.zeros(1 << 26, device=dev, requires_grad=True)
    bucket.grad = torch.ones_like(bucket)

    def least_ms(fn):
        return min([host_ms(torch, fn) for _ in range(4)][1:])

    out["collective_ms"] = {
        f"k/v gather [{bs_eval}, {rows}, {2 * c}] bf16": least_ms(
            lambda: seq.gather_tokens(kv_eval, group, n)),
        f"its backward [{xt.shape[0]}, {n}, {2 * c}] bf16": least_ms(
            lambda: torch.autograd.grad(gathered, kv_train, cot, retain_graph=True)),
        "gradient sum, one bucket of 2^26 f32": least_ms(
            lambda: seq.all_reduce_grads([bucket], group)),
    }
    return out


def phase15(torch, FA, dev, init):
    """ViT-L/16 512 token-sharded over two gloo ranks that share the card,
    against the same model unsharded in this process."""
    import tempfile

    from uncertainty_vit_tpu_torch.evals.classification import make_eval_forward
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )
    from uncertainty_vit_tpu_torch.parallel import seq

    FA.BOUNDED_SCORES = True
    gen = torch.Generator(device=dev).manual_seed(15)
    bs, bs_t = 16, 8
    saved = {
        "init": init,
        "eval_images": torch.randint(0, 256, (bs, 512, 512, 3), generator=gen, device=dev,
                                     dtype=torch.uint8),
        "eval_labels": torch.randint(0, 1000, (bs,), generator=gen, device=dev),
        "train_x": torch.randn(bs_t, 512, 512, 3, generator=gen, device=dev),
        "train_y": torch.randint(0, 1000, (bs_t,), generator=gen, device=dev),
    }
    # the unsharded model on the same batch, weights and generator seeds
    model, _, _ = large_512_model(torch, dev, init)
    x = normalize(to_float(saved["eval_images"]), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD)
    ref_logits = make_eval_forward(model)(x)
    del model
    tmodel, state, step = large_512_model(torch, dev, init, train=True)
    m = step(state, saved["train_x"], saved["train_y"], *large_512_gens(torch, dev, 11))
    ref_loss, ref_gn = float(m["loss"]), float(m["grad_norm"])
    ref_norms = leaf_grad_norms(torch, tmodel)
    del tmodel, state, step, m
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "phase15.pt")
        torch.save(saved, path)
        del saved
        t0 = time.perf_counter()
        ranks = seq.run_ranks(seq2_rank, 2, path, timeout=900.0)
        secs = time.perf_counter() - t0
    depth = 24
    for r, res in enumerate(ranks):
        print(f"  rank {r}: token rows {res['rows']}; evaluate() launches {res['evaluate']}, "
              f"{json.dumps(res['metrics'])}; 2 train steps launches {res['train_step']}; "
              + "; ".join(f"loss {l:.6f} grad_norm {gn:.6f}" for l, gn in res["steps"]),
              flush=True)
        check(res["evaluate"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": depth, "K5_bwd": 0},
              f"rank {r}'s evaluate() launched {res['evaluate']}, expected K5 {depth} only")
        check(res["train_step"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 2 * depth,
                                    "K5_bwd": 2 * depth},
              f"rank {r}'s 2 train steps launched {res['train_step']}, expected K5 {depth} "
              f"each way per step only")
        check(all(math.isfinite(v) for v in res["metrics"].values()), "non-finite metric")
        check(res["finite"] and all(math.isfinite(l) and math.isfinite(gn)
                                    for l, gn in res["steps"]),
              f"rank {r}'s train steps left a non-finite loss, grad norm or parameter")
    a, b = ranks[0], ranks[1]
    check(torch.equal(a["logits"], b["logits"]), "the two ranks' logits differ")
    check(a["steps"] == b["steps"], "the two ranks' losses or grad norms differ")
    ref = ref_logits.cpu()
    diff, scale = (a["logits"] - ref).abs().max().item(), ref.abs().max().item()
    loss, gn = a["steps"][0]
    print(f"  sharded vs unsharded: logits max|diff|={diff:.3e}, max|logit|={scale:.3e}, ratio "
          f"{diff / scale:.3e} (bound {LOGIT_REL_BOUND}); step 1 loss {loss:.6f} / {ref_loss:.6f}, "
          f"grad norm {gn:.6f} / {ref_gn:.6f}", flush=True)
    check(a["logits"].shape == (bs, 1000) and diff <= LOGIT_REL_BOUND * scale,
          "the sharded L/512 logits disagree with the unsharded model's")
    check(abs(loss - ref_loss) <= LOSS_REL_BOUND * abs(ref_loss),
          "the sharded L/512 step's loss disagrees with the unsharded step's")
    check(abs(gn - ref_gn) <= GRAD_NORM_REL_BOUND * abs(ref_gn),
          "the sharded L/512 step's grad norm disagrees with the unsharded step's")
    # every leaf's gradient: equal on the two ranks after the group's sum (a
    # leaf left unsummed keeps each rank's own share), and its norm against the
    # unsharded step's (a leaf summed twice doubles)
    check(list(a["grad_norms"]) == list(ref_norms) and a["grad_norms"] == b["grad_norms"],
          "the two ranks' gradients differ after the group's sum")
    rel = {k: abs(a["grad_norms"][k] - v) / v if v > 0 else float(a["grad_norms"][k] != 0)
           for k, v in ref_norms.items()}
    worst_leaf = max(rel, key=rel.get)
    print(f"  step 1's gradients: equal on both ranks; worst leaf {worst_leaf}: norm "
          f"{a['grad_norms'][worst_leaf]:.6e} / {ref_norms[worst_leaf]:.6e} unsharded, relative "
          f"difference {rel[worst_leaf]:.3e} (bound {LEAF_GRAD_REL_BOUND}); the "
          f"{len(rel)} leaves' median {sorted(rel.values())[len(rel) // 2]:.3e}", flush=True)
    check(rel[worst_leaf] <= LEAF_GRAD_REL_BOUND,
          f"the sharded L/512 step's gradient of {worst_leaf} disagrees with the unsharded step's")
    for r, res in enumerate(ranks):
        print(f"  rank {r} (information only: two ranks share one card and gather through host "
              f"memory over gloo): eval forward at batch {bs} "
              f"{[bs * 1000 / ms for ms in res['eval_ms']]} img/s, train step at batch {bs_t} "
              f"{[bs_t * 1000 / ms for ms in res['step_ms']]} img/s; peak memory evaluate() "
              f"{res['peak_eval_gib']:.2f} GiB, train {res['peak_train_gib']:.2f} GiB; "
              f"collectives, ms each: {json.dumps(res['collective_ms'])}", flush=True)
    print(f"  the two ranks ran {secs:.1f} s from start to end", flush=True)
    return {path: {k: sum(r[path][k] for r in ranks) for k in ("K5", "K5_bwd")}
            for path in ("evaluate", "train_step")}


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
    large, init_512 = run(9, "ViT-L/16 512 evaluate(), finetune train steps, MC forward", phase9,
                          torch, FA, dev)
    res[10] = run(10, "K6 against its plain version, nearest and stochastic", phase10, torch, dev)
    res[11] = run(11, "K7 against its plain version", phase11, torch, dev)
    int8 = run(12, "ViT-B/16 224 with the int8 trunk: evaluate() and finetune train steps",
               phase12, torch, FA, dev, res[10]["other_ms"], res[11]["other_ms"])
    run(13, "a head_dim-80 model on the plain attention", phase13, torch, FA, dev)
    res[14] = run(14, "K5 against its plain version and its shards against K3/K4", phase14,
                  torch, FA, dev)
    seq2 = run(15, "ViT-L/16 512 over two gloo ranks sharing the card: evaluate(), train steps",
               phase15, torch, FA, dev, init_512)
    del init_512

    # one count per run of a path, each read after its own reset: evaluate()
    # over 4 batches, 3 train steps, 1 train step with attention dropout, and
    # phase 6's evaluate_mc_dropout() over 2 batches folded and split, its one
    # K=2 forward with attention dropout and its 2-member ensemble on 1 batch
    mc = {"mc_dropout_folded": res[6]["folded"], "mc_dropout_split": res[6]["split"],
          "mc_attn_drop": res[6]["attn_drop"], "ensemble": res[6]["ensemble"]}
    # and phase 9's ViT-L/16 512 paths ("large_"): evaluate() over 2 batches, 3
    # train steps, 1 step at batch 2, 1 step with attention dropout, one K=2
    # forward with attention dropout
    # and phase 12's int8 paths: evaluate() over 4 batches, 3 train steps
    k1_paths = {"evaluate": eval_launches, "train_step": train["fwd"],
                "train_step_attn_drop": train_drop["fwd"],
                **{path: n["K1"] for path, n in mc.items()},
                **{path: n["K1"] for path, n in int8.items()}}
    k2_paths = {"train_step": train["bwd"], "train_step_attn_drop": train_drop["bwd"],
                "int8_train_step": int8["int8_train_step"]["K2"]}
    k6_paths = {path: n["K6"] for path, n in int8.items()}
    k7_paths = {path: n["K7"] for path, n in int8.items() if n["K7"]}
    k8_paths = {path: n["K8"] for path, n in mc.items() if n["K8"]}
    k3_paths = {f"large_{path}": n["K3"] for path, n in large.items()}
    k4_paths = {f"large_{path}": n["K4"] for path, n in large.items() if n["K4"]}
    for n_ in large.values():
        check(n_["K1"] == 0 and n_["K2"] == 0, "a ViT-L/16 512 path launched K1 or K2")
    # phase 15's paths ("seq2_large_": ViT-L/16 512 over two ranks), summed
    # over the ranks: evaluate() over one batch, 2 train steps; K5's forward
    # and backward launches together
    k5_paths = {f"seq2_large_{path}": n["K5"] + n["K5_bwd"] for path, n in seq2.items()}
    pkg = "uncertainty_vit_tpu_torch/csrc/"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": pkg + "flash_attention_stream_fwd.cu",
         "replaces": "uncertainty_vit_tpu/ops/flash_attention.py:188",
         "launches": sum(k1_paths.values()), "launches_by_path": k1_paths, **res[1]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": pkg + "flash_attention_stream_bwd.cu",
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
        {"name": "quant_fwd", "route": "cuda", "source": pkg + "quant_fwd.cu",
         "replaces": "uncertainty_vit_tpu/ops/quant.py:128",
         "launches": sum(k6_paths.values()), "launches_by_path": k6_paths, **res[10]},
        {"name": "quant_wgrad", "route": "cuda", "source": pkg + "quant_wgrad.cu",
         "replaces": "uncertainty_vit_tpu/ops/quant.py:216",
         "launches": sum(k7_paths.values()), "launches_by_path": k7_paths, **res[11]},
        {"name": "flash_attention_cross", "route": "cuda",
         "source": pkg + "flash_attention_stream_fwd.cu",
         "sources": [pkg + "flash_attention_stream_fwd.cu", pkg + "flash_attention_stream_bwd.cu"],
         "replaces": "uncertainty_vit_tpu/ops/flash_attention.py:1136",
         "launches": sum(k5_paths.values()), "launches_by_path": k5_paths,
         "launches_by_kernel": {f"seq2_large_{path}": n for path, n in seq2.items()}, **res[14]},
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
