"""Where the port builds what it is not told where to build.

The port's entry points run on the card unless the caller asks for the CPU:
a model, a state or a forward built without a ``device`` lies on the current
CUDA device, and building one on a host without a card raises. Nothing in
the package chooses the CPU on its own; the CPU tests pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def default_device() -> torch.device:
    """The current CUDA device; raises where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port builds on the card by default; "
            'pass device="cpu" to build on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``device`` as a torch.device, or the default device for None."""
    return default_device() if device is None else torch.device(device)
