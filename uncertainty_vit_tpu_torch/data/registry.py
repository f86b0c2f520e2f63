"""Dataset dispatch: counterpart of uncertainty_vit_tpu/data/registry.py
(``build_dataset`` :25-82), after the reference's build_dataset
(datasets.py:131-218).

Returns (dataset, num_classes); the dataset yields raw uint8 images, and
the transform (train augmentation or the eval resize and crop) runs on the
device downstream.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from uncertainty_vit_tpu_torch.data import datasets as D

NB_CLASSES = {
    "CIFAR100": 100,
    "CIFAR10": 10,
    "SVHN": 10,
    "tiny_IMNET": 200,
    "IMNET": 1000,
}


def build_dataset(
    is_train: bool,
    data_set: str,
    data_path: str,
    *,
    semi_supervised_ratio: float = 0.0,
    triplet: bool = False,
    decode_size: Optional[int] = None,
    data_set_filter_file: Optional[str] = None,
    seed: int = 0,
    letterbox: bool = False,
) -> Tuple[object, int]:
    """data_set ∈ CIFAR100 | CIFAR10 | SVHN | tiny_IMNET | IMNET |
    image_folder. ``semi_supervised_ratio`` keeps the SSL labeled split of
    the CIFAR100 train set (dist_datasets.py:227-235). ``triplet=True`` wraps
    the dataset, after that split, in the stochastic finetune's (img, pos,
    neg, label) ``TripletDataset`` (dist_datasets.build_dataset), seeded
    with ``seed``."""
    if data_set.startswith("CIFAR100"):
        ds = D.load_cifar(data_path, cifar100=True, train=is_train)
        nb = 100
        if is_train and semi_supervised_ratio:
            labeled_idx, _ = D.ssl_split(
                ds.labels, int(len(ds) * semi_supervised_ratio), nb, seed
            )
            ds = D.Subset(ds, labeled_idx)
    elif data_set.startswith("CIFAR10"):
        ds = D.load_cifar(data_path, cifar100=False, train=is_train)
        nb = 10
    elif data_set == "SVHN":
        ds = D.load_svhn(
            os.path.join(data_path, "train" if is_train else "test"),
            "train" if is_train else "test",
        )
        nb = 10
    elif data_set.startswith("tiny_IMNET"):
        ds = D.TinyImageNet(
            data_path, mode="train" if is_train else "val", decode_size=decode_size
        )
        nb = 200
    elif data_set in ("IMNET", "image_folder"):
        is_valid_file = None
        if is_train and data_set_filter_file:
            with open(data_set_filter_file) as ff:
                allowed = {line.rstrip() for line in ff}
            is_valid_file = lambda p: os.path.basename(p) in allowed
        root = os.path.join(data_path, "train" if is_train else "val")
        ds = D.ImageFolder(root, decode_size=decode_size, is_valid_file=is_valid_file,
                           letterbox=letterbox and decode_size is not None)
        nb = len(ds.classes) if data_set == "image_folder" else 1000
    else:
        raise ValueError(f"unknown data_set: {data_set}")
    if triplet:
        ds = D.TripletDataset(ds, seed=seed)
    return ds, nb
