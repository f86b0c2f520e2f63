"""Turn an orbax checkpoint directory of the JAX package into a ``.pth``
that the PyTorch port reads on a machine without tensorstore (the card's):

    python3 tools/torch_port_orbax_to_pth.py OUT_DIR/checkpoint-best best.pth
    python3 -m uncertainty_vit_tpu_torch.cli.finetune --finetune best.pth --eval ...

Run it where the ``tensorstore`` package is installed (it reads the
directory through ``uncertainty_vit_tpu_torch.utils.orbax``, which needs
neither JAX nor orbax). It writes ``{"model": state_dict}``, the container
``utils.checkpoint.load_torch_state_dict`` reads, holding exactly the
tensors that the port's drivers load from the directory itself
(``utils.checkpoint.jax_state_dict``): a train state's ``params`` and its
SNGP buffers, or a dVAE's variables. ``--family`` names the state the
directory must hold (``finetune``, ``dist``, ``cyclical``, ``mim`` or
``dvae``); by default it is read from the tree. The optimizer's state,
the step and the EMA are not carried. ``write_pth(tree, out)`` is the half
that needs no tensorstore: a tree already in memory to the file.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Mapping, Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from uncertainty_vit_tpu_torch.utils import checkpoint as C  # noqa: E402
from uncertainty_vit_tpu_torch.utils.orbax import read_orbax_tree  # noqa: E402


def write_pth(tree: Mapping, out: str, family: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A JAX train state's tree (``read_orbax_tree``'s form) → ``out`` as
    {"model": state_dict}; the file appears whole or not at all. Returns
    the state dict."""
    state = C.jax_state_dict(tree, family)
    tmp = out + ".tmp"
    torch.save({"model": state}, tmp)
    os.replace(tmp, out)
    return state


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("orbax checkpoint of the JAX package -> .pth for the port")
    p.add_argument("checkpoint", help="a checkpoint-N / checkpoint-best / checkpoint-dvae-weights "
                                      "directory that the JAX package wrote")
    p.add_argument("out", help="the .pth to write")
    p.add_argument("--family", choices=C.FAMILIES, default=None,
                   help="the train state the directory must hold (default: read from it)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = get_args_parser().parse_args(argv)
    tree = read_orbax_tree(args.checkpoint)
    state = write_pth(tree, args.out, args.family)
    print(f"{args.checkpoint}: a {C.jax_state_family(tree)} state, {len(state)} tensors -> "
          f"{args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
