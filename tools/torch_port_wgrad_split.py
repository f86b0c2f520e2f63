#!/usr/bin/env python3
"""Sweep the token split of the int8 wgrad kernel (K7) on one card.

    python3 tools/torch_port_wgrad_split.py

K7's product (csrc/quant_wgrad.cu, ``wgrad_s8_kernel``) splits every tile
pair's tokens S ways and picks S with a small cost model (``launch``). This
script shows what the model is fitted to: it compiles the source once as it
is and once per fixed split (``-DUVIT_WGRAD_SPLIT=<s>``, all builds in
parallel, into build/wgrad_split/), calls the launcher ``uvit_quant_wgrad``
(both of K7's kernels, without ``wgrad()``'s plain passes) on the four
ViT-B/16 224 trunk shapes at M = 31,520 tokens in bf16, checks that every
build gives the same int32 sums, and prints the least of two turns of
CUDA-event timings for every split beside the model's own choice. Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SPLITS = (1, 2, 3, 4, 5, 6, 7, 8, 11, 16)
TRUNK = {"qkv": (768, 2304), "proj": (768, 768), "fc1": (768, 3072), "fc2": (3072, 768)}
M = 160 * 197
ITERS = 10


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from uncertainty_vit_tpu_torch.ops import _native
    from uncertainty_vit_tpu_torch.ops import quant as TQ

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    out_dir = _native.BUILD_DIR.parent / "wgrad_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _native.CSRC / "quant_wgrad.cu"

    def build(split):
        lib = out_dir / ("libmodel.so" if split is None else f"libsplit{split}.so")
        define = [] if split is None else [f"-DUVIT_WGRAD_SPLIT={split}"]
        subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, *define, "-o", str(lib), str(src)],
                       check=True, capture_output=True, text=True)
        return lib

    with concurrent.futures.ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        paths = dict(zip((None,) + SPLITS, pool.map(build, (None,) + SPLITS)))
    fns = {}
    for split, path in paths.items():
        fn = ctypes.CDLL(str(path)).uvit_quant_wgrad
        fn.argtypes, fn.restype = list(TQ._WGRAD_ARGTYPES), ctypes.c_int
        fns[split] = fn

    gen = torch.Generator(device=dev).manual_seed(11)
    seed = torch.tensor([0x0FEDCBA987654321], dtype=torch.int64, device=dev)
    m_pad = -(-M // TQ._WGRAD_M_ALIGN) * TQ._WGRAD_M_ALIGN
    stream = torch.cuda.current_stream(dev).cuda_stream
    for layer, (k, n) in TRUNK.items():
        x = torch.randn(M, k, generator=gen, device=dev).to(torch.bfloat16)
        g = (torch.randn(M, n, generator=gen, device=dev) * 0.01).to(torch.bfloat16)
        inv_x = TQ._col_scales(x).reciprocal().reshape(-1).contiguous()
        inv_g = TQ._col_scales(g).reciprocal().reshape(-1).contiguous()
        xq = torch.empty((k, m_pad), dtype=torch.int8, device=dev)
        gq = torch.empty((n, m_pad), dtype=torch.int8, device=dev)
        acc = torch.zeros((n, k), dtype=torch.int32, device=dev)

        def call(fn):
            err = fn(x.data_ptr(), g.data_ptr(), inv_x.data_ptr(), inv_g.data_ptr(),
                     seed.data_ptr(), xq.data_ptr(), gq.data_ptr(), acc.data_ptr(), M, m_pad, k,
                     n, 0, stream)
            if err != 0:
                raise RuntimeError(f"K7 launch failed ({err})")

        def ms(fn):
            for _ in range(3):
                call(fn)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                call(fn)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / ITERS

        sums = {}
        for split, fn in fns.items():
            acc.zero_()
            call(fn)
            sums[split] = acc.clone()
        same = all(torch.equal(sums[None], s) for s in sums.values())
        order = list(fns)
        best = {split: float("inf") for split in order}
        for split in order + order[::-1]:
            best[split] = min(best[split], ms(fns[split]))
        least = min(SPLITS, key=lambda s: best[s])
        print(f"K7 {layer} M={M} K={k} N={n} bf16, both kernels, ms by split "
              f"(sums equal across builds: {same}; {n // 128 * -(-k // 256)} tiles of 128 x 256): "
              + ", ".join(f"{s}: {best[s]:.4f}" for s in SPLITS)
              + f"; the model's choice {best[None]:.4f}; least {least}: {best[least]:.4f}",
              flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
