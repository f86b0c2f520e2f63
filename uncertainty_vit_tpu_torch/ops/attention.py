"""Reference-semantics attention in plain PyTorch, and its variants.

Counterpart of uncertainty_vit_tpu/ops/attention.py: the attention math of
the reference (modeling_finetune.py:145-188) over [B, H, N, D] tensors, with
its three probability variants over [..., N, N] scores:

- softmax (:181), the default;
- Gumbel-softmax (:169-170; F.gumbel_softmax, soft or hard with the
  straight-through estimator), its noise drawn from an explicit generator
  on every forward, evaluation included, as F.gumbel_softmax draws;
- sinkformer (:171-178, sinkhorn.py:9-74): the log-domain Sinkhorn plan of
  the scores, rescaled by the column count.

``naive_attention`` is the model's path when ``use_flash_attention=False``,
for the variants, inside ``flash_attention.plain_only()``, and the oracle
the fused kernel (ops/flash_attention.py) is held against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from uncertainty_vit_tpu_torch.ops.losses import at_least_f32
from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
from uncertainty_vit_tpu_torch.parallel import seq

VARIANTS = ("softmax", "gumbel", "sinkformer")


def softmax_probs(scores: torch.Tensor) -> torch.Tensor:
    return torch.softmax(scores, dim=-1)


def draw_gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise [shape] in f32 from ``generator``:
    −log(−log u), u uniform on [tiny, 1), as jax.random.gumbel makes it.
    The one place a Gumbel draw is made (the tests replace it to feed the
    JAX package's draws)."""
    if generator is None:
        raise ValueError("Gumbel-softmax attention draws from an explicit torch.Generator; "
                         "pass gumbel_generator= to the model's forward")
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def gumbel_softmax_probs(
    scores: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    tau: float = 1.0,
    hard: bool = False,
    dim: int = -1,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """F.gumbel_softmax semantics (modeling_finetune.py:170, :235, :246):
    softmax((scores + g) / tau) in f32 (float64 for a float64 model), with g
    from ``generator`` (``draw_gumbel``) or ``noise``; ``hard`` gives the
    one-hot of the argmax with the soft probabilities' gradient,
    y_hard + y_soft − y_soft.detach(). The result is in scores' dtype."""
    if noise is None:
        noise = draw_gumbel(scores.shape, generator, scores.device)
    work = at_least_f32(scores.dtype)
    y_soft = torch.softmax((scores.to(work) + noise.to(work)) / tau, dim=dim)
    if not hard:
        return y_soft.to(scores.dtype)
    index = y_soft.argmax(dim=dim, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(dim, index, 1.0)
    return (y_hard + y_soft - y_soft.detach()).to(scores.dtype)


def sinkhorn_probs(scores: torch.Tensor, eps: float = 1.0, max_iter: int = 3,
                   group: Optional[seq.SeqGroup] = None, n_rows: Optional[int] = None
                   ) -> torch.Tensor:
    """Sinkformer attention: the Sinkhorn transport plan of the scores × N.

    sinkhorn.py:17-67 with C = −scores and uniform marginals, as the JAX
    package computes it (ops/attention.py:45-77): even iterations update the
    row potentials u, odd ones the column potentials v, in the log domain,
    for exactly ``max_iter`` iterations (the reference's early break on
    convergence is dropped there too). Computed in f32 (float64 for a
    float64 model); the result is in scores' dtype.

    Under a seq ``group`` scores [..., rows, N] hold this rank's query rows
    of ``n_rows``: the row marginal is 1/n_rows, the row steps stay local
    and the column steps' logsumexp runs over every rank's rows
    (``seq.logsumexp_over``), so the ranks' rows together are the plan of
    the whole sequence."""
    n_cols = scores.shape[-1]
    n_rows = scores.shape[-2] if n_rows is None else n_rows
    s = scores.to(at_least_f32(scores.dtype))
    log_mu = -torch.log(torch.tensor(float(n_rows), dtype=s.dtype))
    log_nu = -torch.log(torch.tensor(float(n_cols), dtype=s.dtype))

    def m(u, v):
        return (s + u[..., :, None] + v[..., None, :]) / eps

    def column_lse(x):
        return (torch.logsumexp(x, dim=-2) if group is None
                else seq.logsumexp_over(x, -2, group))

    u = s.new_zeros(s.shape[:-1])
    v = s.new_zeros(s.shape[:-2] + (n_cols,))
    for i in range(max_iter):
        if i % 2 == 0:
            u = eps * (log_mu - torch.logsumexp(m(u, v), dim=-1)) + u
        else:
            v = eps * (log_nu - column_lse(m(u, v))) + v
    return (torch.exp(m(u, v)) * n_cols).to(scores.dtype)


def attention_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    scale: float,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, H, Nq, D] q, [B, H, Nk, D] k → [B, H, Nq, Nk] f32 scores with
    optional bias add.

    q is scaled in its own dtype; the product of the (exactly upcast)
    operands is taken in f32 (float64 for float64 operands), as the
    reference's ``einsum(..., preferred_element_type=f32)`` does."""
    work = at_least_f32(q.dtype)
    scores = torch.matmul((q * scale).to(work), k.to(work).transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    return scores


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    bias: Optional[torch.Tensor] = None,
    *,
    variant: str = "softmax",
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    query_rows: Optional[Tuple[int, int]] = None,
    batch_rows: Optional[Tuple[int, int, int]] = None,
    gumbel_generator: Optional[torch.Generator] = None,
    sinkformer_eps: float = 1.0,
    sinkformer_iters: int = 3,
    group: Optional[seq.SeqGroup] = None,
) -> torch.Tensor:
    """Unfused attention: the correctness reference and the variants' path.

    q: [B, H, Nq, D], k, v: [B, H, Nk, D] (Nq = Nk = N in self-attention).
    bias: broadcastable to [B, H, Nq, Nk]. Returns [B, H, Nq, D] in v.dtype.
    Probabilities are computed in float32 (float64 for float64 inputs).
    ``variant`` (``VARIANTS``) picks them; "gumbel" draws its noise from
    ``gumbel_generator``. The dropout mask comes from ``generator``, never
    from the global one; with ``query_rows`` = (start, n), q holds rows
    [start, start + Nq) of n queries, and the mask is drawn for all n rows
    and those kept, as the unsharded attention draws it; with
    ``batch_rows`` = (start, stop, total) q's images are a data rank's rows
    of a global batch of ``total`` (or folds of them,
    ``parallel.mesh.rand_rows``), and the mask is drawn for the global batch
    and those rows kept. A sinkformer's column steps run over the rows of
    every rank of the seq ``group`` that holds the other rows
    (``sinkhorn_probs``)."""
    scores = attention_scores(q, k, scale, bias)
    if variant == "softmax":
        probs = softmax_probs(scores)
    elif variant == "gumbel":
        probs = gumbel_softmax_probs(scores, gumbel_generator)
    elif variant == "sinkformer":
        probs = sinkhorn_probs(scores, eps=sinkformer_eps, max_iter=sinkformer_iters,
                               group=group, n_rows=None if query_rows is None else query_rows[1])
    else:
        raise ValueError(f"unknown attention variant: {variant}")
    if dropout_rate > 0.0 and not deterministic:
        if generator is None:
            raise ValueError("attention dropout draws from an explicit torch.Generator; "
                             "pass generator=")
        b, h, nq, nk = probs.shape
        if query_rows is None:
            u = meshlib.rand_rows(probs.shape, generator, probs.device, batch_rows)
        else:
            start, n = query_rows
            u = meshlib.rand_rows((b, h, n, nk), generator, probs.device,
                                  batch_rows)[:, :, start:start + nq]
        keep = u < 1.0 - dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    work = at_least_f32(v.dtype)
    out = torch.matmul(probs.to(v.dtype).to(work), v.to(work))
    return out.to(v.dtype)
