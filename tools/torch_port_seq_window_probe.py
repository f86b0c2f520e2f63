#!/usr/bin/env python3
"""Does phase 25 of chip_smoke.py see a rank that draws the wrong dropout rows?

    python3 tools/torch_port_seq_window_probe.py

Builds the kernels, runs ``chip_smoke.phase25`` as it is (it must pass),
then again with every rank's K8 window moved to start 0: rank 1 then draws
the masks of rank 0's rows (``models.layers.fused_dropout`` wrapped inside
the rank processes). The second run must fail one of its holds; its message
gives how far rank 0's arrays moved. Exits non-zero if the first run fails
or the second passes. Needs one CUDA card and nvcc (~3 min). The last line
names the card and its power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def start_zero_rank(group, device, cases, perturbations):
    """``chip_smoke.seq_eval_rank`` with every K8 window moved to row 0."""
    from uncertainty_vit_tpu_torch.models import layers as L

    real = L.fused_dropout

    def moved(x, rate, seed, window=None, fold=None):
        return real(x, rate, seed, None if window is None else (0, window[1]), fold)

    L.fused_dropout = moved
    return cs.seq_eval_rank(group, device, cases, perturbations)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from uncertainty_vit_tpu_torch.ops import _native
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA

    cs.build_kernels(_native)
    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    cs.phase25(torch, FA, dev)
    print(f"phase 25 as it is: passed in {time.perf_counter() - t:.1f} s", flush=True)
    cs.seq_eval_rank = start_zero_rank
    try:
        cs.phase25(torch, FA, dev)
        print("phase 25 with every window at row 0: PASSED (its holds do not see it)",
              flush=True)
        failed = False
    except RuntimeError as err:
        print(f"phase 25 with every window at row 0: failed, as it should: {err}", flush=True)
        failed = True
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip(), flush=True)
    return 0 if failed else 1


if __name__ == "__main__":
    sys.exit(main())
