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
once per update) and starts the mean afresh.

Every other name of the JAX ``make_optimizer`` (:485-617) is a
``ChainOptimizer``: one chain of plain ``torch._foreach_*`` transforms in
optax's order,

    clip_by_global_norm → core transform → + wd(step)·p (decayed params)
    → post-wd transforms → × lr_scale → × (−lr(step)) [→ lookahead]

each transform written after optax 0.2.6's source (the names' differences
from ``torch.optim`` are optax's: rmsprop's eps inside the sqrt and its
momentum after the scaling and the weight decay, nadam as Adam with
Nesterov's first moment, adadelta's eps on both sides, novograd's per-layer
second moment, sgd as a Nesterov trace). adamp / sgdp keep the weight decay
inside their transform (its coefficient shrinks where the projection
fires); adahessian takes the Hutchinson estimate of the Hessian diagonal
(``hutchinson_hessian_diag``) from the engine; the ``lookahead_`` prefix
wraps the chain (sync 6, α 0.5, the slow weights in the state); ``fused*``
names are the plain ones. ``needs_hessian`` says whether an engine must run
the Hutchinson pass.

A model built on a ``parallel.mesh.Mesh`` with a model axis holds its shard
of the cut parameters: the global norm (the clip's and the reported one)
sums their squares over the model axis and counts the replicated ones
once. A transform that reads a whole tensor's norm or its factored
statistics (lamb, lars, adamp / sgdp's projection, adafactor, novograd)
raises under a model axis; the element-wise ones run.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from uncertainty_vit_tpu_torch.models import layers
from uncertainty_vit_tpu_torch.ops.flash_attention import plain_only
from uncertainty_vit_tpu_torch.ops.losses import at_least_f32
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib

# the --opt names whose transforms read a whole tensor (its norm, its
# factored rows and columns, its per-layer moment): not under a model axis
WHOLE_TENSOR_OPTS = ("lamb", "lars", "adamp", "sgdp", "adafactor", "novograd")


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


def global_norm(tensors: Iterable[torch.Tensor], sharded: Optional[Sequence[bool]] = None,
                mesh=None) -> torch.Tensor:
    """Global L2 norm in f32, float64 for float64 tensors (get_grad_norm_,
    utils.py:392-405). Under ``mesh``'s model axis the squares of the
    ``sharded`` tensors are summed over the axis."""
    tensors = list(tensors)
    if sharded is None or not meshlib.active(mesh, meshlib.MODEL_AXIS):
        return torch.sqrt(sum(t.to(at_least_f32(t.dtype)).pow(2).sum() for t in tensors))
    squares = [t.to(at_least_f32(t.dtype)).pow(2).sum() for t in tensors]
    zero = squares[0].new_zeros(())
    cut = sum((q for q, s in zip(squares, sharded) if s), zero)
    whole = sum((q for q, s in zip(squares, sharded) if not s), zero)
    return torch.sqrt(whole + meshlib.reduce_value(cut, mesh, (meshlib.MODEL_AXIS,)))


def _reduced_norm(opt, grads: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """A mini-step's global gradient norm, its shares first summed in place
    (``opt._reduce``); None where the data ranks' shares wait to be summed
    at the end of the accumulation window (``_window_sum``)."""
    reduce = opt._reduce
    if reduce is not None:
        reduce.sum_tokens(grads)
        if opt.update_freq == 1:
            reduce.sum_data(grads)
        elif reduce.data is not None:
            return None
    return opt._norm(grads)


def _window_sum(opt, acc: List[torch.Tensor]) -> Optional[torch.Tensor]:
    """At the end of an accumulation window: the data sum of the window's
    mean, in place, and its global norm; None where nothing waited."""
    if opt._reduce is None or opt._reduce.data is None:
        return None
    opt._reduce.sum_data(acc)
    return opt._norm(acc)


def _norm_of(model: nn.Module, params: Sequence[torch.Tensor]):
    """global_norm over ``params`` of ``model``, sharded or not."""
    mesh = getattr(model, "mesh", None)
    if not meshlib.active(mesh, meshlib.MODEL_AXIS):
        return global_norm
    cut = {id(p) for n, p in model.named_parameters() if meshlib.param_spec(n) is not None}
    flags = [id(p) in cut for p in params]
    return functools.partial(global_norm, sharded=flags, mesh=mesh)


class LayerDecayAdamW:
    """``torch.optim.AdamW`` over one param group per (lr_scale, decayed,
    trainable), with optional global-norm clipping of the gradients before
    Adam, and optional accumulation of ``update_freq`` calls' gradients.

    ``step(lr, wd)`` takes one mini-step's gradients and returns their global
    norm; it applies an update at this update's schedule values where an
    accumulation window ends (every call when ``update_freq`` is 1), with
    the clip on the norm of the window's mean gradient.

    On a sharded model (``parallel.mesh.grad_reducer``) the step first sums
    the ranks' gradient shares. Under accumulation on a data axis it sums
    the data ranks' once a window, on the window's mean; a mini-step's own
    global gradient then exists on no rank, so the step returns None where
    the window goes on and the window mean's norm, the one the clip reads,
    where it ends (the reference's loss scaler, too, reports a norm only
    where it updates)."""

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
        self._model = model
        self._group(lambda name: True)

    def _group(self, trainable: Callable[[str], bool]) -> None:
        groups: Dict[Tuple[float, bool, bool], list] = {}
        for name, p in self._named:
            groups.setdefault(self._keys[name] + (trainable(name),), []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        self._norm = _norm_of(self._model, self.params)
        self._reduce = meshlib.grad_reducer(self._model, self.params)
        self.optimizer = torch.optim.AdamW(
            [{"params": ps, "lr_scale": s, "decayed": d, "trainable": t}
             for (s, d, t), ps in groups.items()],
            lr=0.0, betas=self._betas, eps=self._eps, weight_decay=0.0,
        )

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, lr: float, wd: float, hessian: Optional[List[torch.Tensor]] = None
             ) -> Optional[torch.Tensor]:
        """``hessian`` is ignored: AdamW takes none."""
        for p in self.params:
            if p.grad is None:
                # a parameter the loss does not read (the dist model's
                # cov_qkv): its JAX gradient is zeros, which Adam's moments,
                # its count and the decoupled weight decay still see
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = _reduced_norm(self, grads)
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
            summed = _window_sum(self, self._acc)
            for p, a in zip(self.params, self._acc):
                p.grad = a
            grads = self._acc
            clip_norm = self._norm(grads) if summed is None else summed
            if norm is None:
                norm = clip_norm
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


# ---------------------------------------------------------------------------
# the optax transforms of the other names (optax 0.2.6), over lists of f32
# tensors in ``ChainOptimizer.params``' order
# ---------------------------------------------------------------------------

Tensors = List[torch.Tensor]


class _Transform:
    """One gradient transformation: ``update(u, params, **extra)`` returns
    the new updates (never aliasing its state) and advances its state, the
    attributes named in ``STATE`` (lists of tensors, None or ints)."""

    STATE: Tuple[str, ...] = ()

    def init(self, params: Tensors) -> None:
        pass

    def update(self, u: Tensors, params: Tensors, **extra) -> Tensors:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.STATE}

    def load_state_dict(self, state: Dict[str, Any], params: Tensors) -> None:
        for k in self.STATE:
            v = state[k]
            if isinstance(v, list):
                v = [None if t is None else t.to(p.device, at_least_f32(p.dtype))
                     for t, p in zip(v, params)]
            setattr(self, k, v)


def _zeros(params: Tensors) -> Tensors:
    """f32 zeros like each parameter (float64 for a float64 copy)."""
    return [torch.zeros_like(p, dtype=at_least_f32(p.dtype)) for p in params]


def _moment_(m: Tensors, g: Tensors, decay: float, order: int = 1) -> None:
    """m ← (1 − decay)·g^order + decay·m (optax's update_moment)."""
    torch._foreach_mul_(m, decay)
    if order == 1:
        torch._foreach_add_(m, g, alpha=1.0 - decay)
    else:
        torch._foreach_addcmul_(m, g, g, value=1.0 - decay)


class ScaleByAdam(_Transform):
    """optax.scale_by_adam, with ``nesterov`` (nadam) the first moment
    b1·m̂(t+1) + (1 − b1)·ĝ(t)."""

    STATE = ("count", "mu", "nu")

    def __init__(self, b1: float, b2: float, eps: float, nesterov: bool = False):
        self.b1, self.b2, self.eps, self.nesterov = b1, b2, eps, nesterov

    def init(self, params):
        self.count, self.mu, self.nu = 0, _zeros(params), _zeros(params)

    def _mu_hat(self, u: Tensors) -> Tensors:
        b1, c = self.b1, self.count
        if self.nesterov:
            mh = torch._foreach_mul(self.mu, b1 / (1.0 - b1 ** (c + 1)))
            torch._foreach_add_(mh, u, alpha=(1.0 - b1) / (1.0 - b1 ** c))
            return mh
        return torch._foreach_div(self.mu, 1.0 - b1 ** c)

    def _denominator(self) -> Tensors:
        d = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(d)
        torch._foreach_add_(d, self.eps)
        return d

    def update(self, u, params, **extra):
        _moment_(self.mu, u, self.b1)
        _moment_(self.nu, u, self.b2, 2)
        self.count += 1
        return torch._foreach_div(self._mu_hat(u), self._denominator())


class ScaleByRAdam(ScaleByAdam):
    """optax.scale_by_radam: Adam's step times the rectification r once the
    variance is tractable (ρ_t ≥ 5), the bias-corrected first moment before;
    ρ_t in f32, as optax computes it."""

    def __init__(self, b1: float, b2: float, eps: float, threshold: float = 5.0):
        super().__init__(b1, b2, eps)
        self.threshold = threshold

    def update(self, u, params, **extra):
        _moment_(self.mu, u, self.b1)
        _moment_(self.nu, u, self.b2, 2)
        self.count += 1
        f = np.float32
        ro_inf = f(2.0 / (1.0 - self.b2) - 1.0)
        b2t = f(self.b2) ** f(self.count)
        ro = ro_inf - f(2) * f(self.count) * b2t / (f(1) - b2t)
        mh = self._mu_hat(u)
        if ro < self.threshold:
            return mh
        r = np.sqrt((ro - f(4)) * (ro - f(2)) * ro_inf / ((ro_inf - f(4)) * (ro_inf - f(2)) * ro))
        torch._foreach_mul_(mh, float(r))
        return torch._foreach_div(mh, self._denominator())


class ScaleByAdadelta(_Transform):
    """optax.scale_by_adadelta: u = √(E[Δ²] + eps) / √(E[g²] + eps) · g."""

    STATE = ("e_g", "e_x")

    def __init__(self, rho: float = 0.9, eps: float = 1e-6):
        self.rho, self.eps = rho, eps

    def init(self, params):
        self.e_g, self.e_x = _zeros(params), _zeros(params)

    def update(self, u, params, **extra):
        _moment_(self.e_g, u, self.rho, 2)
        num = torch._foreach_add(self.e_x, self.eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(self.e_g, self.eps)
        torch._foreach_sqrt_(den)
        out = torch._foreach_div(num, den)
        torch._foreach_mul_(out, u)
        _moment_(self.e_x, out, self.rho, 2)
        return out


class ScaleByNovograd(_Transform):
    """optax.scale_by_novograd: a second moment per parameter tensor, of
    ‖g‖², started at the first step's; m = b1·m + g/(√ν + eps), m = g/(√ν
    + eps) at the first step."""

    STATE = ("count", "mu", "nu")

    def __init__(self, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        self.count, self.mu = 0, _zeros(params)
        self.nu = [torch.zeros((), dtype=at_least_f32(p.dtype), device=p.device) for p in params]

    def update(self, u, params, **extra):
        self.count += 1
        sq = torch._foreach_norm(u)
        torch._foreach_mul_(sq, sq)
        if self.count == 1:
            self.nu = sq
        else:
            torch._foreach_mul_(self.nu, self.b2)
            torch._foreach_add_(self.nu, sq, alpha=1.0 - self.b2)
        den = torch._foreach_sqrt(self.nu)
        torch._foreach_add_(den, self.eps)
        step = [g / d for g, d in zip(u, den)]
        if self.count == 1:
            self.mu = step
        else:
            torch._foreach_mul_(self.mu, self.b1)
            torch._foreach_add_(self.mu, step)
        return [m.clone() for m in self.mu]


class ScaleByRms(_Transform):
    """optax.scale_by_rms(decay, eps, eps_in_sqrt=True): g / √(ν + eps)."""

    STATE = ("nu",)

    def __init__(self, decay: float = 0.9, eps: float = 1e-8):
        self.decay, self.eps = decay, eps

    def init(self, params):
        self.nu = _zeros(params)

    def update(self, u, params, **extra):
        _moment_(self.nu, u, self.decay, 2)
        den = torch._foreach_add(self.nu, self.eps)
        torch._foreach_rsqrt_(den)
        return torch._foreach_mul(u, den)


class Trace(_Transform):
    """optax.trace: t = g + decay·t; the update t, or g + decay·t with
    ``nesterov``."""

    STATE = ("trace",)

    def __init__(self, decay: float, nesterov: bool = False):
        self.decay, self.nesterov = decay, nesterov

    def init(self, params):
        self.trace = _zeros(params)

    def update(self, u, params, **extra):
        torch._foreach_mul_(self.trace, self.decay)
        torch._foreach_add_(self.trace, u)
        if self.nesterov:
            out = torch._foreach_mul(self.trace, self.decay)
            torch._foreach_add_(out, u)
            return out
        return [t.clone() for t in self.trace]


class ScaleByTrustRatio(_Transform):
    """optax.scale_by_trust_ratio: u · ‖p‖/‖u‖ per tensor, 1 where either
    norm is 0."""

    def update(self, u, params, **extra):
        pn, un = torch._foreach_norm(params), torch._foreach_norm(u)
        return [t * torch.where((a == 0) | (b == 0), 1.0, a / b)
                for t, a, b in zip(u, pn, un)]


def _factored_dims(shape, min_dim: int) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the two largest axes, where the smaller
    of them has at least ``min_dim`` entries."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class ScaleByFactoredRms(_Transform):
    """optax.scale_by_factored_rms (Adafactor's second moment, no update
    clipping): tensors whose two largest axes have ≥ 128 entries keep a row
    and a column statistic, the others an elementwise one; the decay at
    step t is 1 − (t + 1)^−0.8."""

    STATE = ("count", "v_row", "v_col", "v")

    def __init__(self, decay_rate: float = 0.8, min_dim_size_to_factor: int = 128,
                 epsilon: float = 1e-30):
        self.decay_rate, self.min_dim, self.epsilon = decay_rate, min_dim_size_to_factor, epsilon

    def init(self, params):
        self.count = 0
        self.v_row, self.v_col, self.v = [], [], []
        for p in params:
            dims = _factored_dims(tuple(p.shape), self.min_dim)
            if dims is None:
                self.v_row.append(None)
                self.v_col.append(None)
                self.v.append(torch.zeros_like(p, dtype=at_least_f32(p.dtype)))
            else:
                d1, d0 = dims
                shape, dtype = list(p.shape), at_least_f32(p.dtype)
                self.v_row.append(p.new_zeros(shape[:d0] + shape[d0 + 1:], dtype=dtype))
                self.v_col.append(p.new_zeros(shape[:d1] + shape[d1 + 1:], dtype=dtype))
                self.v.append(None)

    def update(self, u, params, **extra):
        decay = float(1.0 - np.float32(self.count + 1) ** np.float32(-self.decay_rate))
        out = []
        for i, g in enumerate(u):
            dims = _factored_dims(tuple(g.shape), self.min_dim)
            g2 = g * g + self.epsilon
            if dims is None:
                self.v[i] = decay * self.v[i] + (1.0 - decay) * g2
                out.append(g * self.v[i].rsqrt())
                continue
            d1, d0 = dims
            self.v_row[i] = decay * self.v_row[i] + (1.0 - decay) * g2.mean(dim=d0)
            self.v_col[i] = decay * self.v_col[i] + (1.0 - decay) * g2.mean(dim=d1)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = self.v_row[i].mean(dim=reduced_d1, keepdim=True)
            row_factor = (self.v_row[i] / row_col_mean).rsqrt()
            col_factor = self.v_col[i].rsqrt()
            out.append(g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1))
        self.count += 1
        return out


def adamp_projection(p: torch.Tensor, grad: torch.Tensor, perturb: torch.Tensor, delta: float,
                     wd_ratio: float, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """timm adamp/sgdp ``_projection`` (JAX optim.py:115-146): for a ≥ 2-D
    parameter whose gradient is nearly orthogonal to it (the scale-invariant
    case), the radial part of the update is removed and the weight decay
    shrinks to ``wd_ratio``; the channel view (one row per output, axis 0
    of torch's layout, as timm views it) first, the whole tensor next.
    Returns (update, weight-decay ratio as a 0-d tensor)."""
    one = torch.ones((), dtype=at_least_f32(p.dtype), device=p.device)
    if p.ndim <= 1:
        return perturb, one

    def cond_and_proj(channel: bool):
        pv = p.reshape(p.shape[0], -1) if channel else p.reshape(1, -1)
        gv = grad.reshape(pv.shape)
        pn, gn = pv.norm(dim=1), gv.norm(dim=1)
        cos = (pv * gv).sum(dim=1).abs() / (pn.clamp_min(eps) * gn.clamp_min(eps))
        cond = cos.max() < delta / math.sqrt(pv.shape[1])
        expand = ((-1,) if channel else (1,)) + (1,) * (p.ndim - 1)
        p_n = p / (pn.reshape(expand) + eps)
        dot = (p_n * perturb).reshape(pv.shape).sum(dim=1).reshape(expand)
        return cond, perturb - p_n * dot

    c_cond, c_proj = cond_and_proj(True)
    l_cond, l_proj = cond_and_proj(False)
    out = torch.where(c_cond, c_proj, torch.where(l_cond, l_proj, perturb))
    return out, torch.where(c_cond | l_cond, wd_ratio * one, one)


class ScaleByAdamP(_Transform):
    """timm AdamP (optim_factory.py:139-140; JAX optim.py:155-212): emits
    perturb/bc1 + wd·ratio·p on decayed parameters, so the chain's −lr
    scaling is torch's p·(1 − lr·wd·ratio) − lr·perturb/bc1."""

    STATE = ("count", "mu", "nu")

    def __init__(self, b1: float, b2: float, eps: float, decayed: Sequence[bool],
                 delta: float = 0.1, wd_ratio: float = 0.01, nesterov: bool = True):
        self.b1, self.b2, self.eps, self.decayed = b1, b2, eps, list(decayed)
        self.delta, self.wd_ratio, self.nesterov = delta, wd_ratio, nesterov

    def init(self, params):
        self.count, self.mu, self.nu = 0, _zeros(params), _zeros(params)

    def update(self, u, params, *, wd: float = 0.0, **extra):
        b1, b2 = self.b1, self.b2
        _moment_(self.mu, u, b1)
        _moment_(self.nu, u, b2, 2)
        self.count += 1
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        out = []
        for g, m, v, p, decayed in zip(u, self.mu, self.nu, params, self.decayed):
            denom = (v / bc2).sqrt() + self.eps
            perturb = ((b1 * m + (1.0 - b1) * g) if self.nesterov else m) / denom
            perturb, ratio = adamp_projection(p, g, perturb, self.delta, self.wd_ratio, self.eps)
            o = perturb / bc1
            if wd and decayed:
                o = o + wd * ratio * p
            out.append(o)
        return out


class ScaleBySGDP(_Transform):
    """timm SGDP (optim_factory.py:141-142; JAX optim.py:220-268): Nesterov
    momentum with the AdamP projection; the weight decay wd·ratio·p/(1 −
    momentum) on decayed parameters, torch's rescaled decay."""

    STATE = ("buf",)

    def __init__(self, momentum: float, eps: float, decayed: Sequence[bool], delta: float = 0.1,
                 wd_ratio: float = 0.1, nesterov: bool = True, dampening: float = 0.0):
        self.momentum, self.eps, self.decayed = momentum, eps, list(decayed)
        self.delta, self.wd_ratio, self.nesterov, self.dampening = (delta, wd_ratio, nesterov,
                                                                    dampening)

    def init(self, params):
        self.buf = _zeros(params)

    def update(self, u, params, *, wd: float = 0.0, **extra):
        torch._foreach_mul_(self.buf, self.momentum)
        torch._foreach_add_(self.buf, u, alpha=1.0 - self.dampening)
        out = []
        for g, b, p, decayed in zip(u, self.buf, params, self.decayed):
            d_p = (g + self.momentum * b) if self.nesterov else b
            d_p, ratio = adamp_projection(p, g, d_p, self.delta, self.wd_ratio, self.eps)
            if wd and decayed:
                d_p = d_p + wd * ratio * p / (1.0 - self.momentum)
            out.append(d_p)
        return out


class ScaleByAdahessian(_Transform):
    """timm Adahessian.step() (optim_factory.py:149; JAX optim.py:330-380):
    m = EMA(g), v = EMA(D²) of the Hutchinson estimate D (the ``hessian``
    the engine passes), update (m/bc1) / (sqrt(v/bc2) + eps): timm's
    hessian_power 1, the only value the reference builds it with."""

    STATE = ("count", "exp_avg", "exp_hess_sq")

    def __init__(self, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        self.count, self.exp_avg, self.exp_hess_sq = 0, _zeros(params), _zeros(params)

    def update(self, u, params, *, hessian: Optional[Tensors] = None, **extra):
        if hessian is None:
            raise ValueError("adahessian needs the Hessian diagonal estimate: build the train "
                             "step with use_hessian=True (needs_hessian(opt)), which passes "
                             "hessian= to the optimizer's step")
        _moment_(self.exp_avg, u, self.b1)
        _moment_(self.exp_hess_sq, hessian, self.b2, 2)
        self.count += 1
        mh = torch._foreach_div(self.exp_avg, 1.0 - self.b1 ** self.count)
        den = torch._foreach_div(self.exp_hess_sq, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        return torch._foreach_div(mh, den)


# ---------------------------------------------------------------------------
# the optimizer names
# ---------------------------------------------------------------------------

# the lookahead_ prefix's constants (JAX lookahead_wrapper :620-665: timm's
# Lookahead defaults, which the reference never overrides)
LOOKAHEAD_SYNC_PERIOD = 6
LOOKAHEAD_ALPHA = 0.5

OPT_NAMES = ("adamw", "adam", "nadam", "radam", "adadelta", "novograd", "rmsprop", "rmsproptf",
             "sgd", "momentum", "lamb", "lars", "adafactor", "adamp", "sgdp", "adahessian")


def parse_opt_name(opt_name: Optional[str]) -> Tuple[str, bool]:
    """(base name, lookahead) of an --opt value: ``fused`` dropped (the apex
    kernels' names map to the plain ones, JAX :511-517), ``lookahead_``
    stripped. Raises ValueError for a name the JAX make_optimizer refuses."""
    name = (opt_name or "adamw").replace("fused", "") or "adamw"
    lookahead = name.startswith("lookahead_")
    if lookahead:
        name = name[len("lookahead_"):]
    if name not in OPT_NAMES:
        raise ValueError(f"optimizer '{name}' is not supported (the reference package's "
                         f"make_optimizer takes {', '.join(OPT_NAMES)})")
    return name, lookahead


def needs_hessian(opt_name: Optional[str]) -> bool:
    """Whether the optimizer takes a Hessian-diagonal estimate, so that the
    engine must run the Hutchinson pass (JAX optim.py:275-282)."""
    name = (opt_name or "adamw").replace("fused", "")
    return name.removeprefix("lookahead_") == "adahessian"


class ChainOptimizer:
    """Every name but adamw / adam: optax's chain for it (JAX
    make_optimizer :485-617), in the interface of ``LayerDecayAdamW``.

    ``step(lr, wd, hessian=None)`` takes one mini-step's gradients (a
    parameter without one takes zeros, as its JAX gradient is) and returns
    their global norm; where an accumulation window ends (every call when
    ``update_freq`` is 1) it runs the chain on the window's mean gradient
    (and, for adahessian, the mean of the windows' Hessian estimates, JAX
    ``multi_steps_with_hessian`` :389-458) at this update's lr and wd, then
    the lookahead, then zeroes the update of frozen parameters
    (``freeze_all_except``), and adds it to the parameters. A sharded
    model's gradient shares are summed as ``LayerDecayAdamW`` sums them."""

    def __init__(self, model: nn.Module, *, opt_name: str, weight_decay: float = 0.05,
                 clip_grad: Optional[float] = None, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, layer_decay: Optional[float] = None, depth: int = 12,
                 skip_names: Sequence[str] = ("pos_embed", "cls_token"), update_freq: int = 1,
                 momentum: float = 0.9):
        if update_freq < 1:
            raise ValueError(f"update_freq must be >= 1, got {update_freq}")
        self.opt_name = opt_name
        name, self.lookahead = parse_opt_name(opt_name)
        if name in WHOLE_TENSOR_OPTS and meshlib.active(getattr(model, "mesh", None),
                                                        meshlib.MODEL_AXIS):
            raise NotImplementedError(f"--opt {opt_name} reads whole tensors: not ported under "
                                      "a model axis (ROADMAP.md item 21)")
        self.name, self.weight_decay, self.clip_grad = name, weight_decay, clip_grad
        self.update_freq, self.mini_step = update_freq, 0
        self._named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in self._named]
        self._norm = _norm_of(model, self.params)
        self._reduce = meshlib.grad_reducer(model, self.params)
        mask = weight_decay_mask(model, skip_names)
        self._decayed = [bool(weight_decay) and mask[n] for n, _ in self._named]
        self._trainable = [True] * len(self.params)
        scales = (layer_decay_scales(model, layer_decay, depth)
                  if layer_decay is not None and layer_decay < 1.0 else None)
        self._scales = None if scales is None else [scales[n] for n, _ in self._named]
        b1, b2 = betas
        # the weight decay of the chain, after the core transform; adamp /
        # sgdp take it inside theirs
        self._chain_wd = bool(weight_decay) and name not in ("adamp", "sgdp")
        post: List[_Transform] = []
        if name in ("adamw", "adam", "lamb"):
            core: Optional[_Transform] = ScaleByAdam(b1, b2, eps)
            if name == "lamb":
                post.append(ScaleByTrustRatio())
        elif name == "nadam":
            core = ScaleByAdam(b1, b2, eps, nesterov=True)
        elif name == "radam":
            core = ScaleByRAdam(b1, b2, eps)
        elif name == "adadelta":
            core = ScaleByAdadelta(eps=eps)
        elif name == "novograd":
            core = ScaleByNovograd(b1, b2, eps)
        elif name in ("rmsprop", "rmsproptf"):
            # timm's rmsprop_tf: decay 0.9, eps in the sqrt, heavy-ball
            # momentum after the scaling and the weight decay
            core = ScaleByRms(0.9, eps)
            if momentum:
                post.append(Trace(momentum))
        elif name == "sgd":
            core = Trace(momentum, nesterov=True)
        elif name == "momentum":
            core = Trace(momentum)
        elif name == "lars":
            core = None
            post += [ScaleByTrustRatio(), Trace(momentum)]
        elif name == "adafactor":
            core = ScaleByFactoredRms()
        elif name == "adamp":
            core = ScaleByAdamP(b1, b2, eps, self._decayed)
        elif name == "sgdp":
            core = ScaleBySGDP(momentum, eps, self._decayed)
        else:  # adahessian
            core = ScaleByAdahessian(b1, b2, eps)
        self._core, self._post = core, post
        self._transforms = ([] if core is None else [core]) + post
        for t in self._transforms:
            t.init(self.params)
        self.count = 0  # updates applied
        self._slow: Optional[Tensors] = ([p.detach().clone() for p in self.params]
                                         if self.lookahead else None)
        self._acc: Optional[Tensors] = None
        self._acc_hessian: Optional[Tensors] = None

    @property
    def uses_hessian(self) -> bool:
        return self.name == "adahessian"

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _accumulate(self, acc: Optional[Tensors], values: Tensors) -> Tensors:
        """optax.MultiSteps' running mean, acc + (g − acc)/(n + 1)."""
        if acc is None:
            acc = _zeros(self.params)
        delta = torch._foreach_sub([v.to(a.dtype) for v, a in zip(values, acc)], acc)
        torch._foreach_div_(delta, self.mini_step + 1)
        torch._foreach_add_(acc, delta)
        return acc

    @torch.no_grad()
    def step(self, lr: float, wd: float, hessian: Optional[Tensors] = None
             ) -> Optional[torch.Tensor]:
        if self.uses_hessian and hessian is None:
            raise ValueError("adahessian needs hessian= (the Hutchinson estimate) on every "
                             "mini-step; build the train step with use_hessian=True")
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        norm = _reduced_norm(self, grads)
        if self.update_freq > 1:
            self._acc = self._accumulate(self._acc, grads)
            if hessian is not None:
                self._acc_hessian = self._accumulate(self._acc_hessian, hessian)
            boundary = self.mini_step == self.update_freq - 1
            self.mini_step = (self.mini_step + 1) % self.update_freq
            if not boundary:
                return norm
            grads, hessian = self._acc, self._acc_hessian
            summed = _window_sum(self, grads)
            if summed is not None:
                norm = summed
        updates = [g.to(at_least_f32(g.dtype)) for g in grads]
        if self.clip_grad is not None and self.clip_grad > 0:
            # optax.clip_by_global_norm: g · max/‖g‖ where ‖g‖ ≥ max
            clip_norm = norm if self.update_freq == 1 else self._norm(updates)
            coef = torch.where(clip_norm < self.clip_grad, 1.0, self.clip_grad / clip_norm)
            updates = torch._foreach_mul(updates, coef)
        params = [p.detach() for p in self.params]
        if self._core is not None:
            updates = self._core.update(updates, params, wd=wd, hessian=hessian)
        idx = [i for i, d in enumerate(self._decayed) if d]
        if self._chain_wd and wd and idx:
            torch._foreach_add_([updates[i] for i in idx], [params[i] for i in idx], alpha=wd)
        for t in self._post:
            updates = t.update(updates, params)
        if self._scales is not None:
            updates = [u * s for u, s in zip(updates, self._scales)]
        torch._foreach_mul_(updates, -lr)
        if self.lookahead:
            updates = self._lookahead(updates, params)
        self._apply(params, updates)
        self.count += 1
        if self._acc is not None:
            torch._foreach_zero_(self._acc)
            if self._acc_hessian is not None:
                torch._foreach_zero_(self._acc_hessian)
        return norm

    def _apply(self, params: Tensors, updates: Tensors) -> None:
        """Zero the frozen parameters' updates (``freeze_all_except``) and
        add the updates to the parameters."""
        for u, trainable in zip(updates, self._trainable):
            if not trainable:
                u.zero_()
        torch._foreach_add_(params, updates)

    def _lookahead(self, updates: Tensors, params: Tensors) -> Tensors:
        """Every ``LOOKAHEAD_SYNC_PERIOD`` updates the update retargets the parameters
        onto slow + α·(fast − slow), which become the slow weights (JAX
        ``lookahead_wrapper`` :620-665)."""
        if (self.count + 1) % LOOKAHEAD_SYNC_PERIOD != 0:
            return updates
        fast = torch._foreach_add(params, updates)
        torch._foreach_sub_(fast, self._slow)
        torch._foreach_add_(self._slow, fast, alpha=LOOKAHEAD_ALPHA)
        return torch._foreach_sub(self._slow, params)

    def state_dict(self) -> dict:
        state = {"opt_name": self.opt_name, "count": self.count,
                 "transforms": [t.state_dict() for t in self._transforms]}
        if self.lookahead:
            state["lookahead"] = {"slow": self._slow}
        if self.update_freq > 1:
            state["multi_steps"] = {"mini_step": self.mini_step, "acc": self._acc,
                                    "acc_hessian": self._acc_hessian}
        return state

    def load_state_dict(self, state: dict) -> None:
        name, _ = parse_opt_name(state.get("opt_name"))
        if name != self.name or ("lookahead" in state) != self.lookahead:
            raise ValueError(f"the optimizer state was saved by --opt {state.get('opt_name')}; "
                             f"this run's is {self.opt_name}")
        multi = state.get("multi_steps")
        if (multi is None) != (self.update_freq == 1):
            raise ValueError(f"the optimizer state was saved with{'' if multi else 'out'} "
                             f"gradient accumulation; this run's update_freq is "
                             f"{self.update_freq}")
        self.count = int(state["count"])
        for t, s in zip(self._transforms, state["transforms"]):
            t.load_state_dict(s, self.params)

        def placed(ts):
            return None if ts is None else [t.to(p.device, at_least_f32(p.dtype))
                                            for t, p in zip(ts, self.params)]

        if self.lookahead:
            self._slow = placed(state["lookahead"]["slow"])
        if multi is not None:
            self.mini_step = int(multi["mini_step"])
            self._acc, self._acc_hessian = placed(multi["acc"]), placed(multi["acc_hessian"])


Optimizer = Any  # LayerDecayAdamW or ChainOptimizer


def make_optimizer(model: nn.Module, *, opt_name: str = "adamw", momentum: float = 0.9,
                   **kwargs) -> Optimizer:
    """The JAX make_optimizer (:485-617) for ``model``: adamw and adam (the
    same chain) are ``LayerDecayAdamW``; every other name, and any name with
    the ``lookahead_`` prefix, a ``ChainOptimizer``. Keyword arguments as
    ``LayerDecayAdamW``; ``momentum`` is sgd's, momentum's, sgdp's, lars's
    and rmsprop's. An unknown name raises ValueError."""
    name, lookahead = parse_opt_name(opt_name)
    if name in ("adamw", "adam") and not lookahead:
        return LayerDecayAdamW(model, **kwargs)
    return ChainOptimizer(model, opt_name=opt_name, momentum=momentum, **kwargs)


def freeze_all_except(optimizer: Optimizer, trainable_paths: Sequence[str]) -> Optimizer:
    """Linear-probe freezing (run_class_finetuning.py:529-538): only the
    parameters whose name contains one of ``trainable_paths`` (typically the
    head the checkpoint did not provide) move. The others keep their
    gradients in the norm, the clip and the optimizer's statistics; their
    update is zeroed, as the JAX package zeroes the final update. Call
    before the first step."""
    def trainable(name: str) -> bool:
        return any(t in name for t in trainable_paths)

    if isinstance(optimizer, ChainOptimizer):
        if optimizer.count or optimizer._acc is not None:
            raise RuntimeError("freeze_all_except: call it before a step")
        optimizer._trainable = [trainable(n) for n, _ in optimizer._named]
        return optimizer
    if optimizer.optimizer.state or optimizer._acc is not None:
        raise RuntimeError("freeze_all_except regroups the parameters: call it before a step")
    optimizer._group(trainable)
    return optimizer


# ---------------------------------------------------------------------------
# the AdaHessian pass (JAX optim.py:285-321, 461-482)
# ---------------------------------------------------------------------------

def draw_rademacher(params: Tensors, generator: torch.Generator) -> Tensors:
    """Rademacher z (±1 in the parameter's dtype) for each parameter, in
    order, from ``generator``. The one place the Hutchinson pass draws (the
    tests replace it to feed the JAX package's draws)."""
    return [(torch.randint(0, 2, p.shape, generator=generator, device=p.device) * 2 - 1
             ).to(p.dtype) for p in params]


def hutchinson_hessian_diag(loss_fn: Callable[[], torch.Tensor], params: Tensors,
                            generator: torch.Generator) -> Tensors:
    """Hutchinson's estimate of the Hessian diagonal, D = E_z[z ⊙ Hz] with
    Rademacher z from ``generator`` (timm adahessian.py ``set_hessian``; one
    sample, as the reference's unconfigured construction).

    ``loss_fn()`` recomputes the step's loss (``StepReplay`` gives it the
    step's draws); it runs inside ``flash_attention.plain_only()``, so the
    graph holds no kernel Function. Hz is a double backward, as timm's
    ``create_graph=True`` backward and ``autograd.grad(g, p, z)``: every op
    of the plain path has one, while ``torch.func``'s forward-over-reverse
    would need forward-mode rules of the same ops and a functional copy of
    the model's buffers (the SNGP statistics a forward updates). A parameter
    the loss does not read gets D = 0, as its JAX gradient is constant."""
    with plain_only(), torch.enable_grad():
        loss = loss_fn()
    grads = torch.autograd.grad(loss, params, create_graph=True, allow_unused=True)
    used = [i for i, g in enumerate(grads) if g is not None and g.requires_grad]
    out = _zeros(params)
    z = draw_rademacher(params, generator)
    hz = torch.autograd.grad([grads[i] for i in used], [params[i] for i in used],
                             grad_outputs=[z[i] for i in used], allow_unused=True)
    for i, h in zip(used, hz):
        if h is not None:
            out[i].addcmul_(z[i], h.detach())
    return out


def _buffer_slots(model: nn.Module) -> List[Tuple[nn.Module, str]]:
    return [(m, name) for m in model.modules() for name, b in m._buffers.items()
            if b is not None]


class StepReplay:
    """What the Hessian pass needs to recompute a train step's loss as the
    step computed it (the reference differentiates the step's own graph
    twice; JAX optim.py:297-300 reruns the same program): made before the
    step's forward, it keeps the model's buffers (the SNGP precision matrix
    and spectral vectors a train forward updates) and the states of the
    step's other generators (Gumbel noise, the heteroscedastic head's);
    ``recording()`` records the forward's dropout and drop-path masks.
    ``hessian_diag`` then runs the loss again on all of these, inside
    ``plain_only()``, its attention-dropout masks drawn from the pass's own
    generator (the one draw not replayed), and restores the buffers and
    generators the step left."""

    def __init__(self, model: nn.Module, generators: Iterable[Optional[torch.Generator]] = ()):
        self._slots = _buffer_slots(model)
        self._buffers = [m._buffers[n].detach().clone() for m, n in self._slots]
        self._generators = [(g, g.get_state()) for g in generators if g is not None]
        self.log: Optional[layers.DrawLog] = None

    @contextlib.contextmanager
    def recording(self) -> Iterator[None]:
        with layers.record_draws() as log:
            self.log = log
            yield

    def hessian_diag(self, loss_fn: Callable[[], torch.Tensor], params: Tensors,
                     generator: Optional[torch.Generator]) -> Tensors:
        if generator is None:
            raise ValueError("the AdaHessian pass draws from an explicit hessian_generator")
        if self.log is None:
            raise RuntimeError("StepReplay.hessian_diag before the step's recorded forward")

        def replayed() -> torch.Tensor:
            after = [m._buffers[n] for m, n in self._slots]
            after_gens = [g.get_state() for g, _ in self._generators]
            # fresh tensors, not in-place copies: the step's graph keeps its own
            for (m, n), b in zip(self._slots, self._buffers):
                m._buffers[n] = b.clone()
            for g, state in self._generators:
                g.set_state(state)
            try:
                with layers.replay_draws(self.log, generator):
                    return loss_fn()
            finally:
                for (m, n), b in zip(self._slots, after):
                    m._buffers[n] = b
                for (g, _), state in zip(self._generators, after_gens):
                    g.set_state(state)

        return hutchinson_hessian_diag(replayed, params, generator)
