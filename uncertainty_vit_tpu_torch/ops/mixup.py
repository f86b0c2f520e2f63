"""Mixup / cutmix on the device (batch, elem and pair modes), and smoothed
one-hot targets.

Counterpart of uncertainty_vit_tpu/ops/mixup.py (``one_hot_smooth`` :29-32,
``_rand_bbox_minmax`` :62-87, ``_elem_params`` :90-117, ``_mix_per_elem``
:120-133, ``mixup_cutmix`` :136-207): timm.data.Mixup as the reference's
finetune script sets it (run_class_finetuning.py:339-346). The mixing
partner is the flipped batch; the cutmix lambda is corrected to the box's
area.

Each mode splits its draws from their application. The draws come from a
``torch.Generator`` on the CPU (``draw_mixup_batch``: six scalars;
``draw_mixup_elem``: a few per sample), so they cost the device no sync.
The application is a pure function of the draws (``mix_batch``,
``mix_elem``), so a test can hand it the JAX package's draws. The
per-sample draws reach the device in one pinned buffer copied without
blocking, and the boxes [B, H, W] are formed there in one pass, by comparing
row and column iotas against each sample's corners as the JAX package does.

Modes (timm Mixup._mix_batch / _mix_elem / _mix_pair):
  - 'batch': one lambda / box / apply draw for the whole batch.
  - 'elem': lambda, box, cutmix switch and apply drawn per sample.
  - 'pair': the first half's draws, mirrored onto the partners: sample i
    and B−1−i share one lambda and box (an even batch only).
``cutmix_minmax`` (timm rand_bbox_minmax): the box's height and width drawn
uniformly from [⌊dim·min⌋, ⌊dim·max⌋) and its corner so that it never
clips; lambda from the realized area. It forces cutmix_alpha to 1.

Under a ``parallel.mesh.Mesh`` whose data axis splits the batch (JAX
:122-131, 173-181 on the global batch) every rank draws from a generator
of the same seed for the global batch and takes its rows' draws, and the
partner of global row i, row B−1−i, comes from the mirrored data rank
(``parallel.mesh.flip_batch``): the images and the targets are exchanged
over the data axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from uncertainty_vit_tpu_torch.parallel import mesh as meshlib


def one_hot_smooth(labels: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    """[B] int labels → [B, num_classes] f32 targets, smoothing/num_classes
    off target."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels, num_classes).float() * (on - off) + off


@dataclasses.dataclass(frozen=True)
class MixupDraws:
    """One batch's draws (timm Mixup._params_per_batch + rand_bbox). The
    lambdas are float32 values. ``box``: the (y1, y2, x1, x2) that
    cutmix_minmax drew, in place of the box of ``lam_cut`` centred at
    (cy, cx)."""

    apply: bool
    use_cutmix: bool
    lam_mix: float
    lam_cut: float
    cy: int
    cx: int
    box: Optional[Tuple[int, int, int, int]] = None


@dataclasses.dataclass(frozen=True)
class ElemDraws:
    """Per-sample draws of the elem / pair modes (timm
    Mixup._params_per_elem), numpy arrays over the samples: apply and
    use_cutmix (bool), lam (f32, area-corrected where cutmix), and each
    box's corners y1, y2, x1, x2 (int; rows [y1, y2), columns [x1, x2))."""

    apply: np.ndarray
    use_cutmix: np.ndarray
    lam: np.ndarray
    y1: np.ndarray
    y2: np.ndarray
    x1: np.ndarray
    x2: np.ndarray

    def rows(self, start: int, stop: int) -> "ElemDraws":
        """The draws of samples [start, stop)."""
        return ElemDraws(*(a[start:stop] for a in dataclasses.astuple(self)))

    def mirrored(self) -> "ElemDraws":
        """The pair mode's draws: these for the first half, reversed for the
        second, so that i and B−1−i share theirs (JAX mixup.py:170-175)."""
        return ElemDraws(*(np.concatenate([a, a[::-1]]) for a in dataclasses.astuple(self)))


def _uniform(gen: torch.Generator) -> float:
    return float(torch.rand((), generator=gen, device=gen.device))


def _gamma(alpha: float, gen: torch.Generator) -> float:
    """Gamma(alpha, 1) by Marsaglia and Tsang's method (alpha < 1 boosted)."""
    if alpha < 1.0:
        return _gamma(alpha + 1.0, gen) * _uniform(gen) ** (1.0 / alpha)
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    while True:
        x = float(torch.randn((), generator=gen, device=gen.device))
        v = (1.0 + c * x) ** 3
        if v <= 0.0:
            continue
        u = _uniform(gen)
        if u > 0.0 and math.log(u) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v


def _beta(alpha: float, gen: torch.Generator) -> float:
    a, b = _gamma(alpha, gen), _gamma(alpha, gen)
    return float(np.float32(a / (a + b)))


def _draw_minmax_boxes(gen: torch.Generator, count: int, h: int, w: int,
                       minmax: Sequence[float]) -> Tuple[np.ndarray, ...]:
    """``count`` boxes of rand_bbox_minmax (JAX mixup.py:62-87): the sides
    uniform on [⌊dim·min⌋, ⌊dim·max⌋), the corner uniform where the box
    fits. (y1, y2, x1, x2) as int64 arrays. Bounds that collapse raise, as
    timm's randint does."""
    lo_h, hi_h = int(h * minmax[0]), int(h * minmax[1])
    lo_w, hi_w = int(w * minmax[0]), int(w * minmax[1])
    if lo_h >= hi_h or lo_w >= hi_w:
        raise ValueError(
            f"cutmix_minmax {tuple(minmax)} collapses at image size "
            f"{(h, w)}: int bounds h[{lo_h},{hi_h}) w[{lo_w},{hi_w}) are "
            "empty (timm raises here too)"
        )
    cut_h = torch.randint(lo_h, hi_h, (count,), generator=gen).numpy()
    cut_w = torch.randint(lo_w, hi_w, (count,), generator=gen).numpy()
    u = torch.rand((2, count), generator=gen, dtype=torch.float64).numpy()
    y1 = np.floor(u[0] * (h - cut_h)).astype(np.int64)
    x1 = np.floor(u[1] * (w - cut_w)).astype(np.int64)
    return y1, y1 + cut_h, x1, x1 + cut_w


def _box_lam(h: int, w: int, y1, y2, x1, x2) -> np.ndarray:
    """1 − box area / image area, in the JAX package's float32 arithmetic."""
    area = np.asarray((y2 - y1) * (x2 - x1), np.float32)
    return np.float32(1.0) - area / np.float32(h * w)


def draw_mixup_batch(
    generator: torch.Generator,
    h: int,
    w: int,
    mixup_alpha: float = 0.8,
    cutmix_alpha: float = 1.0,
    prob: float = 1.0,
    switch_prob: float = 0.5,
    cutmix_minmax: Optional[Sequence[float]] = None,
) -> MixupDraws:
    """The batch mode's draws from ``generator`` (JAX mixup.py:179-202)."""
    if cutmix_minmax is not None:
        cutmix_alpha = 1.0  # timm Mixup.__init__ forces this
    if mixup_alpha > 0 and cutmix_alpha > 0:
        use_cutmix = _uniform(generator) < switch_prob
    else:
        use_cutmix = cutmix_alpha > 0
    lam_mix = _beta(mixup_alpha, generator) if mixup_alpha > 0 else 1.0
    lam_cut = _beta(cutmix_alpha, generator) if cutmix_alpha > 0 else 1.0
    box = None
    cy = cx = 0
    if cutmix_minmax is not None:
        box = tuple(int(v[0]) for v in _draw_minmax_boxes(generator, 1, h, w, cutmix_minmax))
    else:
        cy = int(torch.randint(0, h, (), generator=generator, device=generator.device))
        cx = int(torch.randint(0, w, (), generator=generator, device=generator.device))
    apply = _uniform(generator) < prob
    return MixupDraws(apply, use_cutmix, lam_mix, lam_cut, cy, cx, box)


def draw_mixup_elem(
    generator: torch.Generator,
    count: int,
    h: int,
    w: int,
    mixup_alpha: float = 0.8,
    cutmix_alpha: float = 1.0,
    prob: float = 1.0,
    switch_prob: float = 0.5,
    cutmix_minmax: Optional[Sequence[float]] = None,
) -> ElemDraws:
    """``count`` samples' draws from ``generator`` (JAX ``_elem_params``,
    mixup.py:90-117): the cutmix switch, each mode's lambda, a box (of the
    cutmix lambda's area centred at a uniform point, clipped; or
    cutmix_minmax's), apply; lam is the box's realized area where cutmix."""
    if cutmix_minmax is not None:
        cutmix_alpha = 1.0
    if mixup_alpha > 0 and cutmix_alpha > 0:
        use_cutmix = torch.rand((count,), generator=generator).numpy() < switch_prob
    else:
        use_cutmix = np.full((count,), cutmix_alpha > 0)
    lam_mix = np.array([_beta(mixup_alpha, generator) if mixup_alpha > 0 else 1.0
                        for _ in range(count)], np.float32)
    lam_cut = np.array([_beta(cutmix_alpha, generator) if cutmix_alpha > 0 else 1.0
                        for _ in range(count)], np.float32)
    if cutmix_minmax is not None:
        y1, y2, x1, x2 = _draw_minmax_boxes(generator, count, h, w, cutmix_minmax)
    else:
        cy = torch.randint(0, h, (count,), generator=generator).numpy()
        cx = torch.randint(0, w, (count,), generator=generator).numpy()
        boxes = [_cutmix_box(h, w, lam_cut[i], cy[i], cx[i])[:4] for i in range(count)]
        y1, y2, x1, x2 = (np.array(v, np.int64) for v in zip(*boxes))
    apply = torch.rand((count,), generator=generator).numpy() < prob
    lam = np.where(use_cutmix, _box_lam(h, w, y1, y2, x1, x2), lam_mix).astype(np.float32)
    return ElemDraws(apply, use_cutmix, lam, y1, y2, x1, x2)


def _cutmix_box(h: int, w: int, lam: float, cy: int, cx: int) -> Tuple[int, int, int, int, float]:
    """Box of area ratio (1 − lam) centred at (cy, cx), clipped to the image:
    (y1, y2, x1, x2, area-corrected lambda), in the JAX package's float32
    arithmetic (``_rand_bbox``, mixup.py:41-59)."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h = int(np.float32(h) * ratio)
    cut_w = int(np.float32(w) * ratio)
    y1, y2 = np.clip(cy - cut_h // 2, 0, h), np.clip(cy + cut_h // 2, 0, h)
    x1, x2 = np.clip(cx - cut_w // 2, 0, w), np.clip(cx + cut_w // 2, 0, w)
    return int(y1), int(y2), int(x1), int(x2), float(_box_lam(h, w, y1, y2, x1, x2))


def mix_batch(
    images: torch.Tensor, labels: torch.Tensor, num_classes: int, label_smoothing: float,
    draws: MixupDraws, mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one batch's draws: images [B, H, W, C] → (mixed images, soft
    targets [B, num_classes] f32); this rank's rows of the global batch
    under ``mesh``."""
    _, h, w, _ = images.shape
    targets1 = one_hot_smooth(labels, num_classes, label_smoothing)
    if not draws.apply:
        return images, targets1
    flipped = meshlib.flip_batch(images, mesh)
    if draws.use_cutmix:
        if draws.box is not None:
            y1, y2, x1, x2 = draws.box
            lam = float(_box_lam(h, w, y1, y2, x1, x2))
        else:
            y1, y2, x1, x2, lam = _cutmix_box(h, w, draws.lam_cut, draws.cy, draws.cx)
        box = torch.zeros((h, w), dtype=torch.float32, device=images.device)
        box[y1:y2, x1:x2] = 1.0
        box = box[None, :, :, None]
        mixed = images * (1.0 - box) + flipped * box
    else:
        lam = draws.lam_mix
        mixed = images * lam + flipped * float(np.float32(1.0) - np.float32(lam))
    targets = targets1 * lam + meshlib.flip_batch(targets1, mesh) * float(
        np.float32(1.0) - np.float32(lam))
    return mixed.to(images.dtype), targets


def _elem_on_device(draws: ElemDraws, device: torch.device) -> torch.Tensor:
    """The draws as one f32 tensor [7, B] on ``device``: apply, use_cutmix,
    lam, y1, y2, x1, x2 (integers below 2^24 are exact in f32). To a card
    through a pinned buffer and a copy that does not block the host."""
    host = torch.from_numpy(np.stack([np.asarray(a, np.float32)
                                      for a in dataclasses.astuple(draws)]))
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def mix_elem(
    images: torch.Tensor, labels: torch.Tensor, num_classes: int, label_smoothing: float,
    draws: ElemDraws, mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply per-sample draws (JAX ``_mix_per_elem``, mixup.py:120-133):
    images [B, H, W, C] → (mixed images, soft targets [B, num_classes] f32),
    each sample mixed with its partner B−1−i (of the global batch, under
    ``mesh``; ``draws`` are this rank's rows')."""
    _, h, w, _ = images.shape
    d = _elem_on_device(draws, images.device)
    apply, use_cutmix, lam = d[0] > 0, d[1] > 0, d[2]
    y1, y2, x1, x2 = (v[:, None, None] for v in d[3:])
    rows = torch.arange(h, device=images.device, dtype=torch.float32)[None, :, None]
    cols = torch.arange(w, device=images.device, dtype=torch.float32)[None, None, :]
    # the box cuts only where cutmix is both selected and applied
    box = ((rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
           & (use_cutmix & apply)[:, None, None]).float()
    one = torch.ones((), device=images.device)
    lam_t = torch.where(apply, lam, one)  # the targets' lambda
    # the pixels' mixup lambda: 1 for cutmix and unapplied samples
    lam_m = torch.where(apply & ~use_cutmix, lam, one)[:, None, None, None]
    flipped = meshlib.flip_batch(images, mesh)
    targets1 = one_hot_smooth(labels, num_classes, label_smoothing)
    mixed = images * lam_m + flipped * (1.0 - lam_m)
    mixed = mixed * (1.0 - box)[..., None] + flipped * box[..., None]
    targets = (targets1 * lam_t[:, None]
               + meshlib.flip_batch(targets1, mesh) * (1.0 - lam_t[:, None]))
    return mixed.to(images.dtype), targets


def mixup_cutmix(
    generator: torch.Generator,
    images: torch.Tensor,
    labels: torch.Tensor,
    num_classes: int,
    mixup_alpha: float = 0.8,
    cutmix_alpha: float = 1.0,
    prob: float = 1.0,
    switch_prob: float = 0.5,
    label_smoothing: float = 0.1,
    mode: str = "batch",
    cutmix_minmax: Optional[Sequence[float]] = None,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """images: [B, H, W, C]; labels: [B] int → (mixed images, soft targets),
    with the draws from ``generator``. Under ``mesh`` the batch is this
    rank's rows of the global batch split over the data axis, and every
    rank's ``generator`` has the same seed."""
    if cutmix_minmax is not None and len(cutmix_minmax) != 2:
        raise ValueError("cutmix_minmax must be (min, max)")
    b, h, w, _ = images.shape
    start, stop, total = (0, b, b) if mesh is None else mesh.batch_rows(b)
    rates = (mixup_alpha, cutmix_alpha, prob, switch_prob, cutmix_minmax)
    if mode == "elem":
        draws = draw_mixup_elem(generator, total, h, w, *rates)
        return mix_elem(images, labels, num_classes, label_smoothing, draws.rows(start, stop),
                        mesh)
    if mode == "pair":
        if total % 2 != 0:
            raise ValueError("mixup_mode='pair' requires an even batch size")
        draws = draw_mixup_elem(generator, total // 2, h, w, *rates)
        return mix_elem(images, labels, num_classes, label_smoothing,
                        draws.mirrored().rows(start, stop), mesh)
    if mode != "batch":
        raise ValueError(f"unknown mixup mode {mode!r}")
    draws = draw_mixup_batch(generator, h, w, *rates)
    return mix_batch(images, labels, num_classes, label_smoothing, draws, mesh)
