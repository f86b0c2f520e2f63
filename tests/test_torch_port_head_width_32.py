"""PyTorch port: the attention kernels K1-K5 at head width 32 (4 heads, the
fewest for which the JAX route holds) against the JAX package's Pallas
kernels in interpret mode, and a 2-deep ViT of 4 heads of 32 against the
JAX model and engine; the tests are tests/torch_head_widths.py's.
"""

from torch_head_widths import width_tests
from torch_threads import one_torch_thread  # noqa: F401  (autouse, module-scoped)

globals().update(width_tests(32, 4, model=True))
