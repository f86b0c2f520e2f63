"""PyTorch port: the attention kernels K1-K5 at head width 128 (2 heads, the
fewest for which the JAX route holds) against the JAX package's Pallas
kernels in interpret mode, a 2-deep ViT of 2 heads of 128 against the JAX
model and engine, and the full-width ViT-B/16 224 tree with 6 heads of 128
carried onto the port's model; the tests are tests/torch_head_widths.py's.
"""

from torch_head_widths import width_tests
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

globals().update(width_tests(128, 2, model=True))
