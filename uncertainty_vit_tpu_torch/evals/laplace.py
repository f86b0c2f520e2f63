"""Last-layer KFAC Laplace approximation of the linear head.

Counterpart of uncertainty_vit_tpu/evals/laplace.py (:53-266), which
carries the intent of the reference's dead ``--laplace`` dispatch
(run_class_finetuning.py:40, 651-656: laplace-torch's last-layer KFAC
Laplace with the prior tuned by marginal likelihood).

Math (linear head f = W φ̃, φ̃ = [φ, 1] the pooled feature with a bias
column, W the [C, D+1] head):
- KFAC factors over the fit set: A = Σ φ̃ φ̃ᵀ [D+1, D+1] and G = Σ_n
  (diag(p_n) − p_n p_nᵀ) [C, C], summed in f32 on the features' device,
  then eigendecomposed (``torch.linalg.eigh``); the posterior precision
  kron(G, A)/N + τI is diagonal in the kron eigenbasis, with eigenvalues
  g_l a_k / N + τ.
- GLM predictive: Σ_f = Q_G diag(s) Q_Gᵀ with s_l = Σ_k ã_k² / (g_l a_k /
  N + τ), ã = Q_Aᵀ φ̃; link 'probit' (softmax(f / √(1 + π/8 · diag Σ_f)),
  laplace-torch's default) or 'mc' (the mean softmax over logit draws
  f + Q_G(√s ⊙ ε)); ε is drawn from a generator or passed in.
- The prior precision τ maximizes the Laplace evidence over a 49-point
  log grid on [1e-4, 1e4].

Eigenvectors are defined up to sign and, within ties, order: what is
compared across packages is a reconstruction Q diag(λ) Qᵀ, a variance or a
log-probability. The JAX package reduces the factor sums over hosts; the
port runs one process (the multi-host reduction is ROADMAP.md item 21).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from uncertainty_vit_tpu_torch.evals import metrics as M
from uncertainty_vit_tpu_torch.evals.collect import per_call_generator, pipelined_pairs
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib

FeatureForward = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class KronLaplace:
    """Fitted last-layer KFAC factors (eigendecomposed) and fit statistics."""

    q_a: torch.Tensor  # [D+1, D+1] eigenvectors of A = Σ φ̃ φ̃ᵀ
    a: torch.Tensor  # [D+1] eigenvalues of A (clipped ≥ 0)
    q_g: torch.Tensor  # [C, C] eigenvectors of G = Σ Λ_n
    g: torch.Tensor  # [C] eigenvalues of G (clipped ≥ 0)
    n: int  # number of fit samples
    loglik: float  # Σ log p(y_n | x_n) at the MAP
    theta_sqnorm: float  # ‖θ*‖² of the last layer (weight + bias)
    prior_precision: float = 1.0  # τ (set by optimize_prior_precision)

    @property
    def num_params(self) -> int:
        return self.q_g.shape[0] * self.q_a.shape[0]

    def replace(self, **kw) -> "KronLaplace":
        return dataclasses.replace(self, **kw)


def _augment(feats: torch.Tensor) -> torch.Tensor:
    """[B, D] → f32 [B, D+1] with a constant 1 column (the head bias)."""
    feats = feats.float()
    return torch.cat([feats, torch.ones_like(feats[:, :1])], dim=-1)


def _accumulate(a_sum: torch.Tensor, g_sum: torch.Tensor, loglik: torch.Tensor,
                logits: torch.Tensor, feats: torch.Tensor, labels: torch.Tensor):
    """One fit batch (JAX :79-88): A += φ̃ᵀφ̃, G += Σ (diag(p) − p pᵀ),
    loglik += Σ log p_y; all f32."""
    phi = _augment(feats)
    logp = torch.log_softmax(logits.float(), dim=-1)
    p = logp.exp()
    a_sum = a_sum + phi.t() @ phi
    g_sum = g_sum + torch.diag(p.sum(dim=0)) - p.t() @ p
    loglik = loglik + logp.gather(1, labels.long()[:, None]).sum()
    return a_sum, g_sum, loglik


def fit_last_layer_laplace(feature_forward: FeatureForward,
                           head_params: Mapping[str, torch.Tensor],
                           batches: Iterable, mesh=None) -> KronLaplace:
    """Stream the fit set once; returns the eigendecomposed KFAC factors.

    feature_forward(images) → (logits [B, C], pooled features [B, D]), the
    model's forward with return_features; ``head_params`` holds the linear
    head's "weight" [C, D] and "bias" [C] (θ* for the prior term). The sums
    and ``eigh`` run on the features' device; the only readbacks are the
    log-likelihood and ‖θ*‖² at the end. Under a ``parallel.mesh.Mesh``
    each data rank streams its shard, and the factor sums, the
    log-likelihood and the count are summed over the data axis (JAX
    :117-136), so every rank fits the same posterior; an empty shard is
    fine, an empty fit set on every rank raises."""
    weight, bias = head_params["weight"], head_params["bias"]
    c, d = weight.shape
    device = weight.device
    a_sum = torch.zeros(d + 1, d + 1, dtype=torch.float32, device=device)
    g_sum = torch.zeros(c, c, dtype=torch.float32, device=device)
    loglik = torch.zeros((), dtype=torch.float32, device=device)
    n = 0
    with torch.no_grad():
        for batch in batches:
            images, labels = batch[0], batch[-1]
            logits, feats = feature_forward(images)
            labels = torch.as_tensor(labels).to(device, non_blocking=True)
            a_sum, g_sum, loglik = _accumulate(a_sum, g_sum, loglik, logits, feats, labels)
            n += int(labels.shape[0])
        if meshlib.active(mesh, meshlib.DATA_AXIS):
            a_sum, g_sum, loglik = (meshlib.reduce_value(t, mesh) for t in (a_sum, g_sum, loglik))
            n = int(meshlib.reduce_value(torch.tensor(n, dtype=torch.float64, device=device),
                                         mesh))
        if n == 0:
            raise ValueError("laplace fit got an empty loader")
        a, q_a = torch.linalg.eigh(a_sum)
        g, q_g = torch.linalg.eigh(g_sum)
        theta_sqnorm = (weight.float().square().sum() + bias.float().square().sum())
    return KronLaplace(q_a=q_a, a=a.clamp(min=0.0), q_g=q_g, g=g.clamp(min=0.0), n=n,
                       loglik=float(loglik), theta_sqnorm=float(theta_sqnorm))


def log_marginal_likelihood(la: KronLaplace, tau) -> torch.Tensor:
    """The Laplace evidence at prior precision τ (up to τ-independent
    constants), f32; ``tau`` a scalar or a 1-D tensor of them."""
    tau = torch.as_tensor(tau, dtype=torch.float32, device=la.a.device)
    eig = torch.outer(la.g, la.a) / la.n  # [C, D+1] posterior curvature eigenvalues
    logdet = torch.log(eig + tau.reshape(tau.shape + (1, 1))).sum(dim=(-2, -1))
    return (la.loglik - 0.5 * tau * la.theta_sqnorm + 0.5 * la.num_params * torch.log(tau)
            - 0.5 * logdet)


def optimize_prior_precision(la: KronLaplace, grid: Optional[np.ndarray] = None
                             ) -> KronLaplace:
    """Grid-maximize the evidence over τ (laplace-torch's method='marglik'
    runs Adam on log τ toward the same stationary point); one readback."""
    if grid is None:
        grid = np.logspace(-4.0, 4.0, 49)
    scores = log_marginal_likelihood(la, torch.tensor(np.asarray(grid), dtype=torch.float32))
    return la.replace(prior_precision=float(grid[int(torch.argmax(scores))]))


def functional_variance(la: KronLaplace, feats: torch.Tensor) -> torch.Tensor:
    """Per-sample eigenvalues s [B, C] of Σ_f = Q_G diag(s) Q_Gᵀ."""
    at = _augment(feats) @ la.q_a  # ã [B, D+1]
    denom = torch.outer(la.g, la.a) / la.n + la.prior_precision  # [C, D+1]
    return at.square() @ (1.0 / denom).t()


def draw_mc_eps(generator: torch.Generator, mc_samples: int, batch: int, classes: int
                ) -> torch.Tensor:
    """The mc link's ε [S, B, C], standard normal on the generator's device."""
    return torch.randn((mc_samples, batch, classes), generator=generator,
                       device=generator.device)


def predictive_log_probs(la: KronLaplace, logits: torch.Tensor, feats: torch.Tensor,
                         link: str = "probit", mc_samples: int = 32,
                         generator: Optional[torch.Generator] = None,
                         eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GLM predictive log-probabilities of MAP logits and features.

    link='probit': log_softmax(f_c / √(1 + π/8 Σ_f[c, c])).
    link='mc': log mean_s softmax(f + Q_G(√s ⊙ ε_s)), ε [S, B, C] passed in
    or drawn from ``generator`` (one of the two is required)."""
    logits = logits.float()
    s = functional_variance(la, feats)  # [B, C]
    if link == "probit":
        var = s @ la.q_g.square().t()  # diag Σ_f[b, c] = Σ_l Q_G[c, l]² s[b, l]
        return torch.log_softmax(logits * torch.rsqrt(1.0 + (math.pi / 8.0) * var), dim=-1)
    if link == "mc":
        if eps is None:
            if generator is None:
                raise ValueError("the mc link draws from an explicit torch.Generator; pass "
                                 "generator= (or eps=)")
            eps = draw_mc_eps(generator, mc_samples, *s.shape)
        draws = logits[None] + (s.sqrt()[None] * eps) @ la.q_g.t()
        return torch.logsumexp(torch.log_softmax(draws, dim=-1), dim=0) - math.log(eps.shape[0])
    raise ValueError(f"unknown link {link!r} (probit|mc)")


def evaluate_laplace(la: KronLaplace, feature_forward: FeatureForward, batches: Iterable,
                     link: str = "probit", mc_samples: int = 32, seed: int = 0
                     ) -> Dict[str, float]:
    """Clean eval under the Laplace predictive: the full calibration suite
    on the global log-probabilities (valid logits for every metric), with
    "loss" and "prior_precision". Under link='mc' each batch draws from a
    fresh generator of the stream ``seed`` starts."""
    fresh = per_call_generator(seed, la.q_a.device)

    def dispatch():
        for batch in batches:
            logits, feats = feature_forward(batch[0])
            with torch.no_grad():
                pred = predictive_log_probs(la, logits, feats, link, mc_samples,
                                            generator=fresh() if link == "mc" else None)
            yield pred, batch[-1]

    outs = list(pipelined_pairs(dispatch()))
    out = M.classification_metrics(
        torch.from_numpy(np.concatenate([o[0] for o in outs])).to(la.q_a.device),
        torch.from_numpy(np.concatenate([o[1] for o in outs])).to(la.q_a.device))
    out["loss"] = out["nll"]
    out = {k: float(v) for k, v in out.items()}
    out["prior_precision"] = float(la.prior_precision)
    return out


def make_feature_forward(model: nn.Module) -> FeatureForward:
    """images → (logits, pooled features), eval mode, under inference_mode."""

    def forward(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        model.eval()
        with torch.inference_mode():
            return model(images, return_features=True)

    return forward
