"""Dataset adapters (host side, torchvision-free).

Counterpart of uncertainty_vit_tpu/data/datasets.py (:35-316), a copy of
its readers, which yield raw uint8 HWC images and int labels; every
transform runs on the device downstream (``ops/augment.py``):
  - CIFAR-10/100 (python pickle batches) and the SSL labeled split
    (``ssl_split``, FixMatch-style equal per-class subsets)
  - SVHN (.mat via scipy)
  - ImageFolder (class-sorted directories, corrupt-file retry like
    dataset_folder.py:164-171; PIL imported when an image is decoded, the
    native JPEG decoder of ``utils/native.py`` for whole batches)
  - TinyImageNet-200 (wnids / val_annotations parsing, tin.py:32-90)
  - TinyImageNet-C (tin.py:169-259) and the CIFAR-C / -P ``.npy`` tensors
    (``load_cifar_c``, ``load_cifar_p``)
  - the triplet wrapper of the stochastic (dist) finetune (``TripletDataset``,
    dist_datasets.py:31-44, 143-148)
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")


def letterbox_canvas(decode_size: int) -> int:
    """Square canvas side for letterboxed decode: 4/3 of the shorter side
    (the RRC aspect range is 3/4..4/3, so wider margins are never sampled
    anyway), rounded up to the 8-row sublane quantum."""
    return -(-(decode_size * 4 // 3) // 8) * 8


class ArrayDataset:
    """In-memory uint8 images [N, H, W, C] + labels [N]."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        assert len(images) == len(labels)
        self.images = images
        self.labels = np.asarray(labels, np.int64)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        return self.images[idx], int(self.labels[idx])


# ---------------------------------------------------------------------------
# CIFAR
# ---------------------------------------------------------------------------

def _load_cifar_batch(path: str, labels_key: bytes) -> Tuple[np.ndarray, List[int]]:
    with open(path, "rb") as f:
        entry = pickle.load(f, encoding="bytes")
    data = entry[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return data, list(entry[labels_key])


def load_cifar(root: str, cifar100: bool, train: bool) -> ArrayDataset:
    if cifar100:
        base = os.path.join(root, "cifar-100-python")
        files = ["train"] if train else ["test"]
        key = b"fine_labels"
    else:
        base = os.path.join(root, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        key = b"labels"
    images, labels = [], []
    for fn in files:
        d, l = _load_cifar_batch(os.path.join(base, fn), key)
        images.append(d)
        labels.extend(l)
    return ArrayDataset(np.concatenate(images), np.asarray(labels))


def ssl_split(
    labels: Sequence[int], num_labeled: int, num_classes: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """x_u_split semantics (the reference's missing `cifar_semi` module,
    datasets.py:29): equal per-class labeled subsets; everything is kept in
    the unlabeled pool."""
    labels = np.asarray(labels)
    per_class = num_labeled // num_classes
    rng = np.random.RandomState(seed)
    labeled = []
    for c in range(num_classes):
        idx = np.where(labels == c)[0]
        if len(idx) == 0:
            continue
        labeled.append(rng.choice(idx, min(per_class, len(idx)), replace=False))
    labeled_idx = np.concatenate(labeled)
    rng.shuffle(labeled_idx)
    return labeled_idx, np.arange(len(labels))


class Subset:
    def __init__(self, base, indices: Sequence[int]):
        self.base = base
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.base[int(self.indices[i])]

    @property
    def labels(self):
        return np.asarray(self.base.labels)[self.indices]


# ---------------------------------------------------------------------------
# SVHN
# ---------------------------------------------------------------------------

def load_svhn(root: str, split: str) -> ArrayDataset:
    import scipy.io as sio

    mat = sio.loadmat(os.path.join(root, f"{split}_32x32.mat"))
    images = np.transpose(mat["X"], (3, 0, 1, 2))  # HWCN → NHWC
    labels = mat["y"].astype(np.int64).squeeze()
    labels[labels == 10] = 0  # torchvision convention
    return ArrayDataset(images, labels)


# ---------------------------------------------------------------------------
# ImageFolder
# ---------------------------------------------------------------------------

def find_classes(directory: str) -> Tuple[List[str], dict]:
    classes = sorted(
        e.name for e in os.scandir(directory) if e.is_dir()
    )
    return classes, {c: i for i, c in enumerate(classes)}


class ImageFolder:
    """Class-per-directory image dataset; decodes to uint8 RGB with an
    optional fixed decode size (host resize, keeping device shapes static).

    Corrupt files are tolerated by retrying a random other index
    (dataset_folder.py:164-171)."""

    def __init__(
        self,
        root: str,
        decode_size: Optional[int] = None,
        is_valid_file: Optional[Callable[[str], bool]] = None,
        letterbox: bool = False,
    ):
        self.root = root
        self.decode_size = decode_size
        # letterbox: aspect-preserving decode onto a zero-filled square
        # canvas with per-sample valid extents, so the on-device RRC samples
        # the FULL image like torchvision's (the default square center-crop
        # canvas can never see content outside the center — ADVICE r1 #4).
        self.letterbox = letterbox
        classes, class_to_idx = find_classes(root)
        self.classes = classes
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir, followlinks=True)):
                for fn in sorted(files):
                    if fn.lower().endswith(IMG_EXTENSIONS):
                        path = os.path.join(dirpath, fn)
                        if is_valid_file is None or is_valid_file(path):
                            self.samples.append((path, class_to_idx[c]))
        self.labels = np.asarray([s[1] for s in self.samples])

    def __len__(self):
        return len(self.samples)

    def _decode(self, path: str):
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("RGB")
            if self.decode_size is not None and self.letterbox:
                s = self.decode_size
                canvas = letterbox_canvas(s)
                w, h = im.size
                if w <= h:
                    nw, nh = s, max(int(round(s * h / w)), s)
                else:
                    nh, nw = s, max(int(round(s * w / h)), s)
                im = im.resize((nw, nh), Image.BILINEAR)
                ch, cw = min(nh, canvas), min(nw, canvas)
                top, left = (nh - ch) // 2, (nw - cw) // 2
                im = im.crop((left, top, left + cw, top + ch))
                out = np.zeros((canvas, canvas, 3), np.uint8)
                out[:ch, :cw] = np.asarray(im, dtype=np.uint8)
                return out, np.asarray([ch, cw], np.int32)
            if self.decode_size is not None:
                # resize shorter side then center crop to a square canonical
                # size; the device RRC then crops from this canvas
                w, h = im.size
                s = self.decode_size
                if w <= h:
                    nw, nh = s, max(int(round(s * h / w)), s)
                else:
                    nh, nw = s, max(int(round(s * w / h)), s)
                # BILINEAR to match the native C++ decode path (utils/native.py)
                im = im.resize((nw, nh), Image.BILINEAR)
                left, top = (nw - s) // 2, (nh - s) // 2
                im = im.crop((left, top, left + s, top + s))
            return np.asarray(im, dtype=np.uint8)

    def __getitem__(self, idx: int):
        for _ in range(5):
            path, label = self.samples[idx]
            try:
                decoded = self._decode(path)
                if self.letterbox and self.decode_size is not None:
                    img, valid_hw = decoded
                    return img, valid_hw, label
                return decoded, label
            except Exception:
                idx = random.randrange(len(self.samples))
        raise RuntimeError(f"too many corrupt images near {path}")

    def native_batch_decode(self, indices, num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        """GIL-free batched JPEG decode via the C++ runtime (utils/native.py);
        non-JPEG or corrupt files fall back to PIL / random resampling
        (dataset_folder.py:164-171 semantics). Requires decode_size."""
        from uncertainty_vit_tpu_torch.utils import native

        assert self.decode_size is not None
        indices = list(int(i) for i in indices)
        paths = [self.samples[i][0] for i in indices]
        labels = np.asarray([self.samples[i][1] for i in indices], np.int64)

        jpeg_mask = [p.lower().endswith((".jpg", ".jpeg")) for p in paths]
        side = (
            letterbox_canvas(self.decode_size) if self.letterbox else self.decode_size
        )
        out = np.empty((len(paths), side, side, 3), np.uint8)
        valid_hw = np.full((len(paths), 2), side, np.int32)
        ok = np.zeros(len(paths), bool)
        if native.available() and any(jpeg_mask):
            jpeg_pos = [i for i, m in enumerate(jpeg_mask) if m]
            if self.letterbox:
                batch, vhw, good = native.decode_jpeg_batch_letterbox(
                    [paths[i] for i in jpeg_pos], self.decode_size, side,
                    num_threads,
                )
            else:
                batch, good = native.decode_jpeg_batch(
                    [paths[i] for i in jpeg_pos], self.decode_size, num_threads
                )
                vhw = None
            for j, pos in enumerate(jpeg_pos):
                if good[j]:
                    out[pos] = batch[j]
                    if vhw is not None:
                        valid_hw[pos] = vhw[j]
                    ok[pos] = True
        for i in range(len(paths)):
            if not ok[i]:
                item = self[indices[i]]  # PIL fallback + corrupt retry
                if self.letterbox:
                    out[i], valid_hw[i], labels[i] = item
                else:
                    out[i], labels[i] = item
        if self.letterbox:
            return out, valid_hw, labels
        return out, labels


# ---------------------------------------------------------------------------
# TinyImageNet
# ---------------------------------------------------------------------------

class TinyImageNet(ImageFolder):
    """TinyImageNet-200 layout (tin.py:32-90): train/<wnid>/images/*.JPEG;
    val/images/*.JPEG with val_annotations.txt; class ids from wnids.txt."""

    def __init__(self, root: str, mode: str = "train", decode_size: Optional[int] = None):
        self.root = root
        self.decode_size = decode_size
        # the JAX class leaves this unset, so its decode at a decode_size
        # fails on the attribute (every image counts as corrupt)
        self.letterbox = False
        with open(os.path.join(root, "wnids.txt")) as f:
            wnids = [l.strip() for l in f if l.strip()]
        self.classes = sorted(wnids)
        class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        if mode == "train":
            for wnid in self.classes:
                imgdir = os.path.join(root, "train", wnid, "images")
                if not os.path.isdir(imgdir):
                    continue
                for fn in sorted(os.listdir(imgdir)):
                    if fn.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append((os.path.join(imgdir, fn), class_to_idx[wnid]))
        else:
            ann = os.path.join(root, "val", "val_annotations.txt")
            with open(ann) as f:
                for line in f:
                    parts = line.split("\t")
                    if len(parts) >= 2:
                        fn, wnid = parts[0], parts[1]
                        self.samples.append(
                            (os.path.join(root, "val", "images", fn), class_to_idx[wnid])
                        )
        self.labels = np.asarray([s[1] for s in self.samples])


class TinyImageNetC(ImageFolder):
    """TinyImageNet-C: <root>/<distortion>/<severity>/<wnid>/*.JPEG
    (tin.py:169-259; JAX datasets.py:316-388). Class ids follow the sorted
    wnids of ``_find_wnids``, so that they line up with the finetuned head."""

    def __init__(self, root: str, distortion: str, severity: int,
                 wnids_path: Optional[str] = None, decode_size: Optional[int] = None):
        self.root = root
        self.decode_size = decode_size
        # the JAX class leaves this unset, so its decode at a decode_size
        # fails on the attribute (every image counts as corrupt)
        self.letterbox = False
        base = os.path.join(root, distortion, str(severity))
        self.classes = sorted(self._find_wnids(root, wnids_path, base))
        class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        for wnid in sorted(os.listdir(base)):
            if wnid not in class_to_idx:
                continue
            cdir = os.path.join(base, wnid)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fn), class_to_idx[wnid]))
        self.labels = np.asarray([s[1] for s in self.samples])

    @staticmethod
    def _find_wnids(root: str, wnids_path: Optional[str], severity_dir: str) -> List[str]:
        """The class ids, from the first that exists of: an explicit
        --wnids_path (which must exist), the corruption root's wnids.txt, a
        sibling clean TinyImageNet directory's (the reference hard-codes
        one, tin.py:175-176). With none, raise: class ids derived from the
        directory listing can silently misalign with the head's order."""
        if wnids_path:
            with open(wnids_path) as f:
                return [line.strip() for line in f if line.strip()]
        candidates = [os.path.join(root, "wnids.txt")]
        parent = os.path.dirname(os.path.abspath(root))
        for sib in ("tiny-imagenet-200", "tiny-imagenet", "tiny_imagenet"):
            candidates.append(os.path.join(parent, sib, "wnids.txt"))
        for cand in candidates:
            if os.path.exists(cand):
                with open(cand) as f:
                    return [line.strip() for line in f if line.strip()]
        raise FileNotFoundError(
            "TinyImageNet-C class ids need a wnids.txt to align with the "
            "finetuned head's class order, but none was found (searched: "
            + ", ".join(candidates)
            + "). Pass --wnids_path pointing at the clean TinyImageNet-200 "
            "wnids.txt (the reference hard-codes that path, tin.py:175-176)."
        )


# ---------------------------------------------------------------------------
# Corruption / perturbation tensors (JAX datasets.py:389-401)
# ---------------------------------------------------------------------------

def load_cifar_c(root: str, distortion: str, severity: int) -> ArrayDataset:
    """CIFAR-10/100-C: <root>/<distortion>.npy [50000, 32, 32, 3] (5
    severities × 10k) and <root>/labels.npy; severity s is rows
    [(s − 1)·10000, s·10000)."""
    data = np.load(os.path.join(root, f"{distortion}.npy"))
    labels = np.load(os.path.join(root, "labels.npy"))
    lo, hi = (severity - 1) * 10000, severity * 10000
    return ArrayDataset(data[lo:hi], labels[lo:hi])


def load_cifar_p(root: str, perturbation: str) -> np.ndarray:
    """CIFAR-P: <root>/<perturbation>.npy, uint8 videos [N, T, 32, 32, 3]
    (uncertainty_evaluations.py:784-799)."""
    return np.load(os.path.join(root, f"{perturbation}.npy"))


# ---------------------------------------------------------------------------
# The triplet wrapper of the stochastic finetune (JAX datasets.py:408-429)
# ---------------------------------------------------------------------------

class TripletDataset:
    """(img, pos_img, neg_img, label): pos is the same image (the eval
    transform applies to it on the device), neg an image of another class
    drawn from ``random.Random(seed)`` (dist_datasets.py:31-44, 143-148). The
    index of every other class's items is built once. ``__getitem__`` draws
    the stream's next negative at each call, as the JAX dataset does (whose
    loader threads so interleave the draws as they run).

    ``set_epoch`` (which ``BatchLoader.set_epoch`` calls) restarts the
    stream: at epoch 0 it is ``random.Random(seed)``, the JAX dataset's, and
    at epoch e > 0 one seeded from (seed, e), so that a run resumed at an
    epoch draws the negatives an uninterrupted run draws there (the JAX
    dataset's one stream restarts from its seed at a resume, ROADMAP.md
    §3).

    ``BatchLoader`` keys the negatives on one process's reads rather than
    on the order of its calls: at each epoch it hands ``plan`` the indices
    one process reads, in order (on a data axis every data rank's batches of
    each global batch), read p takes the epoch stream's draw p, and the
    loader loads each item through ``item_at`` with its read's place. So
    the draws do not depend on which thread loads an item, and a data
    rank's triplets are one process's."""

    def __init__(self, base, seed: int = 0):
        self.base = base
        self.seed = seed
        self.labels = np.asarray(base.labels)
        self.rng = random.Random(seed)
        self._stream_seed = seed
        self._by_label = {int(c): np.where(self.labels != c)[0] for c in np.unique(self.labels)}
        self._negatives: Optional[np.ndarray] = None

    def set_epoch(self, epoch: int) -> None:
        seed = self.seed if epoch == 0 else int(
            np.random.SeedSequence([self.seed, epoch]).generate_state(1, np.uint64)[0])
        self._stream_seed = seed
        self.rng = random.Random(seed)

    def _negative(self, rng: random.Random, label) -> int:
        others = self._by_label[int(label)]
        return int(others[rng.randrange(len(others))])

    def plan(self, order: np.ndarray) -> None:
        """The negatives of one process's reads ``order`` (dataset indices in
        reading order) from the epoch's stream, each read's the next draw,
        for ``item_at``."""
        rng = random.Random(self._stream_seed)
        self._negatives = np.array([self._negative(rng, label) for label in self.labels[order]],
                                   np.int64)

    def item_at(self, idx: int, position: int):
        """Item ``idx`` read at ``position`` of the planned order: its
        negative is that read's (``plan``)."""
        img, label = self.base[idx]
        neg_img, _ = self.base[int(self._negatives[position])]
        return img, img.copy(), neg_img, label

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx: int):
        img, label = self.base[idx]
        neg_img, _ = self.base[self._negative(self.rng, label)]
        return img, img.copy(), neg_img, label
