"""Checks that chip_smoke.py's phase 26c sees the int8 trunk under a seq group
draw rank-local bits and scales.

Runs phase 26c (``cli.finetune --quant int8 --seq_parallel 2`` at ViT-B/16
384 on two gloo ranks sharing the card, one f32 step against one process)
as it is, then again with every rank's int8 layer given no shard: its
gradient rounding then draws the bits of the rank's own rows and wgrad's
column scales are the rank's, as before the row window. The first run must
hold and the second must fail its holds; the script prints both runs'
differences and exits 1 otherwise. On the card (~2.5 min):

    python3 tools/torch_port_int8_seq_probe.py
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

_NO_WINDOW = "UVIT_INT8_SEQ_PROBE_NO_WINDOW"

if os.environ.get(_NO_WINDOW) == "1":
    # imported again by each spawned rank as the main module: the ranks take
    # the mutation too
    from uncertainty_vit_tpu_torch.ops import quant as _TQ

    _real = _TQ.int8_dense
    _TQ.int8_dense = lambda x, w, bias, seed, shard=None, **_: _real(x, w, bias, seed, None)


def run_once(torch, FA, dev) -> str:
    """Phase 26c; its error message, or "" when it holds."""
    with tempfile.TemporaryDirectory() as tmp:
        try:
            cs.phase26_seq(torch, FA, dev, tmp)
        except RuntimeError as e:
            return str(e)
    return ""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available; this probe runs only on a GPU", file=sys.stderr)
        return 2
    from uncertainty_vit_tpu_torch.ops import _native
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA

    cs.build_kernels(_native)
    dev = torch.device("cuda", 0)
    FA.BOUNDED_SCORES = True
    t = time.perf_counter()
    first = run_once(torch, FA, dev)
    print(f"as it is: {'fails: ' + first if first else 'holds'} ({time.perf_counter() - t:.1f} s)",
          flush=True)
    os.environ[_NO_WINDOW] = "1"
    from uncertainty_vit_tpu_torch.ops import quant as TQ

    real = TQ.int8_dense
    TQ.int8_dense = lambda x, w, bias, seed, shard=None, **_: real(x, w, bias, seed, None)
    try:
        t = time.perf_counter()
        second = run_once(torch, FA, dev)
    finally:
        TQ.int8_dense = real
        del os.environ[_NO_WINDOW]
    print(f"without the window and the group's scales: "
          f"{'fails: ' + second if second else 'holds'} ({time.perf_counter() - t:.1f} s)",
          flush=True)
    ok = not first and bool(second)
    print("probe: " + ("phase 26c sees rank-local bits and scales" if ok
                       else "phase 26c does NOT tell the two runs apart"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
