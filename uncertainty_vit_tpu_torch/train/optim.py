"""AdamW with layer-wise LR decay and a scheduled decoupled weight decay.

Counterpart of the ``opt_name="adamw"`` core of uncertainty_vit_tpu/train/
optim.py (``vit_layer_id`` :24-43, ``layer_decay_scales`` :46-55,
``weight_decay_mask`` :58-70, ``make_optimizer`` :485-617,
``freeze_all_except`` :668-694, ``global_norm`` :697-700), read for the
port's torch parameter names. The optax chain

    clip_by_global_norm → scale_by_adam → + wd(step)·p (decayed params)
    → × lr_scale → × (−lr(step))

is a ``torch.optim.AdamW`` with one param group per (lr_scale, decayed)
pair: each step the group's lr is lr(step)·lr_scale and its weight decay
wd(step) (0 where undecayed), and AdamW's p ← p − lr·wd·p − lr·adam(g) is the
same update. Linear-probe freezing zeroes the final update of the frozen
parameters, as the JAX package's wrapper does: their gradients still enter
the global norm, its clip and Adam's moments, and a frozen group's lr is 0
(p·(1 − 0·wd) − 0·adam(g) leaves p as it was).

Gradient accumulation (``update_freq`` k > 1) is optax.MultiSteps around
that chain, as the JAX package wraps it (:608-616): each call keeps an f32
running mean of the gradients it is given, acc ← acc + (g − acc)/(n + 1),
and leaves the parameters as they are; the k-th call hands the mean to
the clip and AdamW (whose count, and the schedules' update index, advance
once per update) and starts the mean afresh. The other optimizers are not
ported yet (they raise).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn


def vit_layer_id(name: str, num_max_layer: int) -> int:
    """get_num_layer_for_vit (optim_factory.py:33-55) on a torch parameter
    name; num_max_layer = depth + 2."""
    parts = name.split(".")
    if parts[0] in ("cls_token", "mask_token", "pos_embed", "patch_embed"):
        return 0
    if parts[0] == "rel_pos_bias":
        return num_max_layer - 1
    if parts[0] == "blocks":
        return int(parts[1]) + 1
    return num_max_layer - 1


def layer_decay_scales(model: nn.Module, layer_decay: float, depth: int) -> Dict[str, float]:
    """lr multiplier per parameter: decay^(depth + 1 − layer_id)
    (run_class_finetuning.py:570-576)."""
    num_max_layer = depth + 2
    values = [layer_decay ** (num_max_layer - 1 - i) for i in range(num_max_layer)]
    return {k: values[vit_layer_id(k, num_max_layer)] for k, _ in model.named_parameters()}


def weight_decay_mask(model: nn.Module, skip_names: Sequence[str] = ("pos_embed", "cls_token")
                      ) -> Dict[str, bool]:
    """True where decoupled weight decay applies (optim_factory.py:66-70):
    not for ≤1-D parameters (biases, norms, layer scales) nor the skip list."""
    return {k: p.ndim > 1 and k.split(".")[-1] not in skip_names
            for k, p in model.named_parameters()}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm in f32 (get_grad_norm_, utils.py:392-405)."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class LayerDecayAdamW:
    """``torch.optim.AdamW`` over one param group per (lr_scale, decayed,
    trainable), with optional global-norm clipping of the gradients before
    Adam, and optional accumulation of ``update_freq`` calls' gradients.

    ``step(lr, wd)`` takes one mini-step's gradients and returns their global
    norm; it applies an update at this update's schedule values where an
    accumulation window ends (every call when ``update_freq`` is 1), with
    the clip on the norm of the window's mean gradient."""

    def __init__(self, model: nn.Module, *, weight_decay: float = 0.05,
                 clip_grad: Optional[float] = None, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, layer_decay: Optional[float] = None, depth: int = 12,
                 skip_names: Sequence[str] = ("pos_embed", "cls_token"), update_freq: int = 1):
        if update_freq < 1:
            raise ValueError(f"update_freq must be >= 1, got {update_freq}")
        self.weight_decay, self.clip_grad = weight_decay, clip_grad
        self._betas, self._eps = betas, eps
        # MultiStepsState: the calls taken in this window, and the window's
        # mean gradient (f32, in self.params' order; None before the first)
        self.update_freq, self.mini_step = update_freq, 0
        self._acc: Optional[List[torch.Tensor]] = None
        scales = (layer_decay_scales(model, layer_decay, depth)
                  if layer_decay is not None and layer_decay < 1.0 else None)
        decayed = weight_decay_mask(model, skip_names)
        self._named = [(name, p) for name, p in model.named_parameters() if p.requires_grad]
        self._keys = {name: (scales[name] if scales else 1.0,
                             bool(weight_decay) and decayed[name]) for name, _ in self._named}
        self._group(lambda name: True)

    def _group(self, trainable: Callable[[str], bool]) -> None:
        groups: Dict[Tuple[float, bool, bool], list] = {}
        for name, p in self._named:
            groups.setdefault(self._keys[name] + (trainable(name),), []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        self.optimizer = torch.optim.AdamW(
            [{"params": ps, "lr_scale": s, "decayed": d, "trainable": t}
             for (s, d, t), ps in groups.items()],
            lr=0.0, betas=self._betas, eps=self._eps, weight_decay=0.0,
        )

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, lr: float, wd: float) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                # a parameter the loss does not read (the dist model's
                # cov_qkv): its JAX gradient is zeros, which Adam's moments,
                # its count and the decoupled weight decay still see
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.update_freq > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            # optax.MultiSteps' running mean
            g = [p.grad.float() for p in self.params]
            delta = torch._foreach_sub(g, self._acc)
            torch._foreach_div_(delta, self.mini_step + 1)
            torch._foreach_add_(self._acc, delta)
            boundary = self.mini_step == self.update_freq - 1
            self.mini_step = (self.mini_step + 1) % self.update_freq
            if not boundary:
                return norm
            for p, a in zip(self.params, self._acc):
                p.grad = a
            grads = self._acc
            clip_norm = global_norm(grads)
        else:
            clip_norm = norm
        if self.clip_grad is not None and self.clip_grad > 0:
            # optax.clip_by_global_norm: g · max/‖g‖ where ‖g‖ ≥ max
            coef = torch.where(clip_norm < self.clip_grad, 1.0, self.clip_grad / clip_norm)
            torch._foreach_mul_(grads, coef)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"] if group["trainable"] else 0.0
            group["weight_decay"] = wd if group["decayed"] and group["trainable"] else 0.0
        self.optimizer.step()
        if self._acc is not None:
            for p in self.params:
                p.grad = None
            torch._foreach_zero_(self._acc)
        return norm

    def state_dict(self) -> dict:
        """AdamW's state dict; with accumulation also the window's count and
        mean gradient (``"multi_steps"``)."""
        state = self.optimizer.state_dict()
        if self.update_freq > 1:
            state["multi_steps"] = {"mini_step": self.mini_step, "acc": self._acc}
        return state

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        multi = state.pop("multi_steps", None)
        if (multi is None) != (self.update_freq == 1):
            raise ValueError(f"the optimizer state was saved with{'' if multi else 'out'} "
                             f"gradient accumulation; this run's update_freq is "
                             f"{self.update_freq}")
        self.optimizer.load_state_dict(state)
        if multi is not None:
            self.mini_step = int(multi["mini_step"])
            self._acc = (None if multi["acc"] is None else
                         [a.to(p.device, torch.float32) for a, p in zip(multi["acc"], self.params)])


def freeze_all_except(optimizer: LayerDecayAdamW, trainable_paths: Sequence[str]
                      ) -> LayerDecayAdamW:
    """Linear-probe freezing (run_class_finetuning.py:529-538): only the
    parameters whose name contains one of ``trainable_paths`` (typically the
    head the checkpoint did not provide) move. The others keep their
    gradients in the norm, the clip and Adam's moments; their update is
    zeroed, as the JAX package zeroes the final update. Call before the
    first step."""
    if optimizer.optimizer.state or optimizer._acc is not None:
        raise RuntimeError("freeze_all_except regroups the parameters: call it before a step")
    optimizer._group(lambda name: any(t in name for t in trainable_paths))
    return optimizer


def make_optimizer(model: nn.Module, *, opt_name: str = "adamw", **kwargs) -> LayerDecayAdamW:
    """The adamw branch of make_optimizer; keyword arguments as
    ``LayerDecayAdamW``."""
    if opt_name.replace("fused", "") not in ("adamw", ""):
        raise NotImplementedError(f"optimizer {opt_name!r} is not ported yet (adamw only)")
    return LayerDecayAdamW(model, **kwargs)
