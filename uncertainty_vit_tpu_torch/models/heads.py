"""Uncertainty heads: SNGP (the spectral-norm fc_norm and the RFF-Laplace GP
output layer) and the heteroscedastic MC-softmax head.

Counterpart of uncertainty_vit_tpu/models/heads.py (:31-249), mirroring the
reference's modeling_finetune.py:525-638 (SNGP), sngp.py (the bounded
spectral norm, BertLinear) and modeling_finetune.py:904-1217
(MCSoftmaxDenseFA, Collier et al. 2021).

The state the JAX package threads through flax collections lives here in
registered (persistent) buffers, so that a module's ``state_dict`` holds
all of it under distinct names:
  - the power-iteration vectors ``weight_u`` / ``weight_v`` of
    ``SpectralNormDense`` ('spectral_stats'), under the names the torch
    ``spectral_norm`` hook of the reference gives them, beside
    ``weight_orig``;
  - the frozen random features ``_random_feature.weight`` / ``.bias`` of
    ``SNGPHead`` ('sngp_frozen') and its ``precision_matrix``
    ('sngp_state'), under the reference module's names.
A forward updates them in place only when it is asked to (``update=``,
``update_cov=``), under ``torch.no_grad()``.

The heteroscedastic head's noise is drawn apart from the op on it:
``draw_het_noise`` makes (ε_K, ε_R) from an explicit ``torch.Generator``;
``MCSoftmaxDenseFA.forward`` takes them as ``noise=`` or draws them from
``generator=``, and raises with neither.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.core import init as I
from uncertainty_vit_tpu_torch.core.device import resolve as resolve_device
from uncertainty_vit_tpu_torch.models.layers import _param
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib

MIN_SCALE_MONTE_CARLO = 1e-3  # modeling_finetune.py:641
NORM_BOUND = 0.95  # the spectral norm's bound (sngp.py:95)
NORM_EPS = 1e-12  # the power iteration's l2 floor and the SNGP input LayerNorm's eps
PROB_EPS = 1e-7  # the het head's floor on the mean probability
MC_CHUNK = 100  # het samples a chunk: no [B, S, classes] latent exists at once


def _buffer_init(shape, init: I.Init, device, generator) -> torch.Tensor:
    return init(torch.empty(shape, dtype=torch.float32, device=device), generator)


def _normal(std: float) -> I.Init:
    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            return t.normal_(0.0, std, generator=generator)

    return init


def _uniform(lo: float, hi: float) -> I.Init:
    def init(t: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            return t.uniform_(lo, hi, generator=generator)

    return init


def l2_normalize(a: torch.Tensor) -> torch.Tensor:
    return a / torch.clamp(torch.linalg.vector_norm(a), min=NORM_EPS)


class SpectralNormDense(nn.Module):
    """Linear layer with the reference's bounded spectral norm (JAX :31-88).

    BertLinear init (sngp.py:222-227: weight N(0, 0.02), bias 0). With
    ``update`` one power iteration per forward (under no_grad) moves the
    stored (u, v); the weight is rescaled by NORM_BOUND/σ, σ = u·(W v), only
    when σ exceeds NORM_BOUND (sngp.py:95). Without ``update`` the stored
    vectors give σ (sngp.py:92). torch's ``spectral_norm`` always divides by
    σ and iterates in every training forward, so it is not used."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.weight_orig = _param((features, in_features), _normal(0.02), device,
                                  generator)
        self.bias = _param((features,), I.zeros, device, generator)
        self.register_buffer("weight_u", l2_normalize(
            _buffer_init((features,), _normal(1.0), device, generator)))
        self.register_buffer("weight_v", l2_normalize(
            _buffer_init((in_features,), _normal(1.0), device, generator)))

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        w = self.weight_orig  # [out, in]; u: (out,), v: (in,)
        u, v = self.weight_u, self.weight_v
        if update:
            with torch.no_grad():
                v = l2_normalize(w.detach().t() @ u)
                u = l2_normalize(w.detach() @ v)
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        u, v = u.detach().clone(), v.detach().clone()
        sigma = u @ (w @ v)
        ratio = NORM_BOUND / sigma
        w_norm = torch.where(ratio < 1.0, ratio * w, w)
        return x.to(self.dtype) @ w_norm.t().to(self.dtype) + self.bias.to(self.dtype)


class _RandomFeature(nn.Module):
    """The frozen random-feature projection (modeling_finetune.py:36-46):
    buffers ``weight`` [inducing, hidden] N(0, 0.05) and ``bias``
    [inducing] U(0, 2π), never trained."""

    def __init__(self, hidden: int, inducing: int, *, device, generator):
        super().__init__()
        self.register_buffer("weight", _buffer_init((inducing, hidden), _normal(0.05), device,
                                                    generator))
        self.register_buffer("bias", _buffer_init((inducing,), _uniform(0.0, 2.0 * math.pi),
                                                  device, generator))


class _Linear(nn.Module):
    """``weight`` [out, in] at torch nn.Linear's default U(±1/√in) and an
    optional ``bias`` of zeros (flax Dense's), drawn from a generator."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *, device,
                 generator):
        super().__init__()
        self.weight = _param((out_features, in_features), I.torch_linear_default(in_features),
                             device, generator)
        self.bias = _param((out_features,), I.zeros, device, generator) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight.t()
        return y if self.bias is None else y + self.bias


class SNGPHead(nn.Module):
    """RFF-Laplace Gaussian-process output layer (JAX :91-177,
    modeling_finetune.py:525-638): LayerNorm (eps 1e-12) → frozen random
    features → cos → a linear output layer without bias (torch's default
    init). The reference's gp_kernel_scale 1 and gp_output_bias 0 make the
    scaling and the output bias identities, so neither appears. The posterior precision
    matrix (ridge·I at first) is updated by ``update_cov`` with momentum, or
    summed exactly when momentum ≤ 0 (``models.registry.sngp_reset_cov``
    restarts it); with ``return_gp_cov`` the forward also returns the
    predictive covariance φ P⁻¹ φᵀ · ridge.

    Under a ``mesh`` the rows of x are split over ``axes`` of it (the data
    axis, and the seq axis for the cyclical ``lm_head`` over token rows):
    the minibatch precision φᵀφ / B is taken over the global rows, its sum
    and B summed over those axes, so the matrix stays equal on every rank
    (JAX :163-168 computes it on the global batch)."""

    def __init__(self, hidden_size: int, num_inducing: int, num_classes: int,
                 momentum: float = 0.999, ridge_penalty: float = 1e-3, *, device=None,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 axes: Tuple[str, ...] = ("data",)):
        super().__init__()
        device = resolve_device(device)
        self.momentum, self.ridge_penalty = momentum, ridge_penalty
        self.mesh, self.axes = mesh, axes
        self._gp_input_normalize_layer = nn.LayerNorm(hidden_size, eps=NORM_EPS, device=device)
        self._random_feature = _RandomFeature(hidden_size, num_inducing, device=device,
                                              generator=generator)
        self._gp_output_layer = _Linear(num_inducing, num_classes, bias=False, device=device,
                                        generator=generator)
        self.register_buffer("precision_matrix", ridge_penalty * torch.eye(
            num_inducing, dtype=torch.float32, device=device))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """φ [B, inducing]: the random features of x, f32."""
        ln, rf = self._gp_input_normalize_layer, self._random_feature
        x = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
        return torch.cos(x @ rf.weight.t() + rf.bias)

    def forward(self, x: torch.Tensor, update_cov: bool = False, return_gp_cov: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        phi = self.features(x)
        out = self._gp_output_layer(phi)
        if update_cov:
            with torch.no_grad():
                p = phi.detach().float()
                minibatch = meshlib.reduce_value(p.t() @ p, self.mesh, self.axes)
                if self.momentum > 0:
                    rows = meshlib.reduce_value(p.new_full((), p.shape[0]), self.mesh, self.axes)
                    minibatch = minibatch / rows
                    new = self.momentum * self.precision_matrix + (1.0 - self.momentum) * minibatch
                else:
                    new = self.precision_matrix + minibatch
                self.precision_matrix.copy_(new)
        if return_gp_cov:
            feature_cov = torch.linalg.inv(self.precision_matrix)
            p = phi.float()
            return out, p @ (feature_cov @ p.t()) * self.ridge_penalty
        return out


def het_noise_shapes(batch: int, num_classes: int, num_factors: int, num_samples: int
                     ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The shapes of (ε_K, ε_R) for one forward: [chunks, B, chunk, classes]
    and [chunks, B, chunk, factors] (JAX :226-235)."""
    chunk = min(MC_CHUNK, num_samples)
    chunks = max(num_samples // chunk, 1)
    return (chunks, batch, chunk, num_classes), (chunks, batch, chunk, num_factors)


def draw_het_noise(generator: torch.Generator, batch: int, num_classes: int, num_factors: int,
                   num_samples: int, dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ε_K, ε_R) standard normal on the generator's device."""
    k_shape, r_shape = het_noise_shapes(batch, num_classes, num_factors, num_samples)
    device = generator.device
    eps_k = torch.randn(k_shape, generator=generator, device=device, dtype=dtype)
    eps_r = torch.randn(r_shape, generator=generator, device=device, dtype=dtype)
    return eps_k, eps_r


class MCSoftmaxDenseFA(nn.Module):
    """Heteroscedastic MC-softmax head with a factor-analysis covariance
    (JAX :187-249; modeling_finetune.py:904-1217).

    u = μ(x) + V(x)·ε_R + d(x)·ε_K; probs = mean_S softmax(u/T);
    logits = log(clip(probs, PROB_EPS, 1)). ``loc_layer``, ``scale_layer`` and
    ``diag_layer`` are trained parameters (the JAX package's fix of the
    reference, which re-creates them in every forward). The S samples run
    in chunks of MC_CHUNK.
    ``training`` picks train_mc_samples, else test_mc_samples."""

    def __init__(self, in_features: int, num_classes: int, num_factors: int = 10,
                 temperature: float = 1.0, train_mc_samples: int = 1000,
                 test_mc_samples: int = 1000, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.num_classes, self.num_factors, self.temperature = num_classes, num_factors, temperature
        self.train_mc_samples, self.test_mc_samples = train_mc_samples, test_mc_samples
        kw = dict(device=device, generator=generator)
        self.loc_layer = _Linear(in_features, num_classes, **kw)
        self.scale_layer = _Linear(in_features, num_classes * num_factors, **kw)
        self.diag_layer = _Linear(in_features, num_classes, **kw)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        b = x.shape[0]
        locs = self.loc_layer(x)
        v = self.scale_layer(x).reshape(b, self.num_classes, self.num_factors)
        diag_scale = self.diag_layer(x) + MIN_SCALE_MONTE_CARLO
        shape = (b, self.num_classes, self.num_factors,
                 self.train_mc_samples if training else self.test_mc_samples)
        if noise is None:
            if generator is None:
                raise ValueError("the heteroscedastic head draws its MC noise from an explicit "
                                 "torch.Generator; pass generator= (or noise=)")
            noise = draw_het_noise(generator, *shape, dtype=x.dtype)
        eps_k, eps_r = noise
        want = het_noise_shapes(*shape)
        if (tuple(eps_k.shape), tuple(eps_r.shape)) != want:
            raise ValueError(f"noise shapes {tuple(eps_k.shape)}, {tuple(eps_r.shape)}; "
                             f"expected {want}")
        total = torch.zeros(b, self.num_classes, dtype=x.dtype, device=x.device)
        for ek, er in zip(eps_k, eps_r):
            latents = locs[:, None, :] + (torch.einsum("bcf,bsf->bsc", v, er)
                                          + ek * diag_scale[:, None, :])
            total = total + torch.softmax(latents / self.temperature, dim=-1).sum(dim=1)
        probs_mean = total / (eps_k.shape[0] * eps_k.shape[2])
        return torch.log(torch.clamp(probs_mean, PROB_EPS, 1.0))
