"""Embedding extraction and visualization.

Counterpart of uncertainty_vit_tpu/utils/embeddings.py (:20-83): the
``visualize_embeddings`` the reference imports but does not ship
(run_class_finetuning.py:44). The pooled pre-head features of a dataset
go to TensorBoard-projector TSVs, always, and to a 2-D PCA scatter where
matplotlib imports.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from uncertainty_vit_tpu_torch.evals.collect import pipelined_pairs


def extract_embeddings(model: nn.Module, batches: Iterable, max_items: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The pooled pre-head features [N, D] and labels of ``batches``:
    ``model.forward_features`` in eval mode, the head not run (the JAX
    package rebuilds the model with head_type='none' on the same weights).
    Stops pulling batches once ``max_items`` are in."""

    def forward(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model.forward_features(images)

    feats, labels, count = [], [], 0
    for f, lbls in pipelined_pairs((forward(b[0]), b[-1]) for b in batches):
        feats.append(f)
        labels.append(lbls)
        count += len(lbls)
        if max_items is not None and count >= max_items:
            break
    return np.concatenate(feats)[:max_items], np.concatenate(labels)[:max_items]


def pca_2d(feats: np.ndarray) -> np.ndarray:
    x = feats - feats.mean(0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:2].T


def visualize_embedding(model: nn.Module, batches: Iterable, output_dir: str,
                        max_items: int = 2000, write: bool = True) -> Optional[str]:
    """Write <output_dir>/embeddings.tsv and embeddings_labels.tsv (the
    TensorBoard projector's format), and embeddings_pca.png where matplotlib
    imports. Returns the directory written. With ``write`` False (a rank
    other than 0 of a seq group) it runs the same forwards, their
    collectives included, writes nothing and returns None."""
    tag = "embeddings"
    feats, labels = extract_embeddings(model, batches, max_items)
    if not write:
        return None
    os.makedirs(output_dir, exist_ok=True)
    np.savetxt(os.path.join(output_dir, f"{tag}.tsv"), feats, delimiter="\t", fmt="%.6f")
    np.savetxt(os.path.join(output_dir, f"{tag}_labels.tsv"), labels, fmt="%d")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return output_dir
    xy = pca_2d(feats)
    plt.figure(figsize=(8, 8))
    plt.scatter(xy[:, 0], xy[:, 1], c=labels, s=4, cmap="tab20", alpha=0.7)
    plt.title(f"{tag} (PCA)")
    plt.savefig(os.path.join(output_dir, f"{tag}_pca.png"), dpi=120)
    plt.close()
    return output_dir
