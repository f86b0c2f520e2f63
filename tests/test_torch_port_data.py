"""PyTorch port: the host data path (datasets, dataset registry, batch
loader, native assembly and decode, device prefetch) against the JAX
package's, on data written here from a seed.

Everything here is uint8 images, int labels and index orders, so every
comparison is exact: bit for bit.
"""

import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from uncertainty_vit_tpu.data import datasets as JD
from uncertainty_vit_tpu.data import pipeline as JP
from uncertainty_vit_tpu.data import registry as JR
from uncertainty_vit_tpu_torch.data import datasets as TD
from uncertainty_vit_tpu_torch.data import pipeline as TP
from uncertainty_vit_tpu_torch.data import registry as TR
from uncertainty_vit_tpu_torch.utils import native as TN

N_TRAIN, N_TEST = 50, 23  # 23: uneven against every batch size and host count below


def _cifar_batch(path, n, key, rs):
    data = rs.randint(0, 256, (n, 3072), dtype=np.uint8)
    with open(path, "wb") as f:
        pickle.dump({b"data": data, key: rs.randint(0, 10, n).tolist()}, f)


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    """CIFAR-100 (train, test) and CIFAR-10 (5 train batches, test) pickles
    in the reference's layout."""
    root = tmp_path_factory.mktemp("cifar")
    rs = np.random.RandomState(0)
    c100 = root / "cifar-100-python"
    c100.mkdir()
    _cifar_batch(c100 / "train", N_TRAIN, b"fine_labels", rs)
    _cifar_batch(c100 / "test", N_TEST, b"fine_labels", rs)
    c10 = root / "cifar-10-batches-py"
    c10.mkdir()
    for i in range(1, 6):
        _cifar_batch(c10 / f"data_batch_{i}", 7, b"labels", rs)
    _cifar_batch(c10 / "test_batch", N_TEST, b"labels", rs)
    return str(root)


def _write_images(root, ext, sizes, seed=0):
    """class_a / class_b directories of seeded RGB images of the given
    (w, h) sizes, written with PIL."""
    rs = np.random.RandomState(seed)
    for c in ("class_b", "class_a"):
        os.makedirs(os.path.join(root, c), exist_ok=True)
        for i, (w, h) in enumerate(sizes):
            im = Image.fromarray(rs.randint(0, 256, (h, w, 3), dtype=np.uint8))
            im.save(os.path.join(root, c, f"img{i}.{ext}"), quality=90)
    return root


def _same_dataset(a, b):
    assert len(a) == len(b)
    assert np.array_equal(np.asarray(a.labels), np.asarray(b.labels))
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert np.array_equal(np.asarray(u), np.asarray(v)), i


@pytest.mark.parametrize("cifar100", [True, False], ids=["cifar100", "cifar10"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_load_cifar_equals_jax(cifar_root, cifar100, train):
    """The (N, 3, 32, 32) → NHWC reshape and the labels, bit for bit."""
    got = TD.load_cifar(cifar_root, cifar100=cifar100, train=train)
    want = JD.load_cifar(cifar_root, cifar100=cifar100, train=train)
    assert got.images.shape == want.images.shape and got.images.shape[1:] == (32, 32, 3)
    assert np.array_equal(got.images, want.images)
    assert np.array_equal(got.labels, want.labels)


@pytest.mark.parametrize("data_set,is_train,ratio", [
    ("CIFAR100", False, 0.0), ("CIFAR100", True, 0.0), ("CIFAR100", True, 0.4),
    ("CIFAR10", True, 0.0), ("CIFAR10", False, 0.0),
])
def test_build_dataset_equals_jax(cifar_root, data_set, is_train, ratio):
    """The registry's dataset and class count, the SSL labeled split of
    CIFAR100 train included."""
    got, nb = TR.build_dataset(is_train, data_set, cifar_root, semi_supervised_ratio=ratio,
                               seed=3)
    want, jnb = JR.build_dataset(is_train, data_set, cifar_root, semi_supervised_ratio=ratio,
                                 seed=3)
    assert nb == jnb
    _same_dataset(got, want)


def test_build_dataset_refuses_what_is_not_ported(cifar_root):
    """An unknown data set raises; triplet=True, ported now, wraps the
    dataset in the triplet dataset as JAX's does (its negatives are held
    in tests/test_torch_port_dist.py)."""
    got, _ = TR.build_dataset(True, "CIFAR100", cifar_root, triplet=True, seed=1)
    want, _ = JR.build_dataset(True, "CIFAR100", cifar_root, triplet=True, seed=1)
    assert isinstance(got, TD.TripletDataset) and isinstance(want, JD.TripletDataset)
    _same_dataset(got, want)
    with pytest.raises(ValueError, match="unknown data_set"):
        TR.build_dataset(False, "MNIST", cifar_root)


LOADER_CASES = [
    # (shuffle, drop_last, batch, pad_shards)
    (True, True, 8, None),     # the train loader
    (False, False, 8, None),   # the eval loader: uneven, unpadded shards
    (True, False, 7, None),
    (False, True, 5, True),
    (False, False, 6, False),
]


@pytest.mark.parametrize("num_workers", [0, 3])
@pytest.mark.parametrize("num_hosts", [1, 3])
@pytest.mark.parametrize("shuffle,drop_last,batch,pad", LOADER_CASES)
def test_batch_loader_equals_jax(cifar_root, shuffle, drop_last, batch, pad, num_hosts,
                                 num_workers):
    """Every host's batches over 3 epochs, bit for bit: the index order
    (RandomState(seed + epoch)), the host shards, padding and drop_last,
    the prefetching threads."""
    ds = TD.load_cifar(cifar_root, cifar100=True, train=False)
    jds = JD.load_cifar(cifar_root, cifar100=True, train=False)
    for host in range(num_hosts):
        kw = dict(shuffle=shuffle, seed=5, drop_last=drop_last, num_workers=num_workers,
                  host_id=host, num_hosts=num_hosts, pad_shards=pad)
        got, want = TP.BatchLoader(ds, batch, **kw), JP.BatchLoader(jds, batch, **kw)
        orders = []
        for epoch in range(3):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert len(got) == len(want)
            assert np.array_equal(got._indices(), want._indices())
            orders.append(got._indices())
            gb, wb = list(got), list(want)
            assert len(gb) == len(wb) == len(got)
            for g, w in zip(gb, wb):
                assert len(g) == len(w) == 2
                assert g[0].dtype == np.uint8 and g[1].dtype == np.int64
                assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
        if shuffle:
            assert not np.array_equal(orders[0], orders[1])


def test_eval_shards_cover_the_split_once(cifar_root):
    """The eval loader's default unpadded shards: over 3 hosts the union is
    the test split exactly once, though 23 does not divide by 3."""
    ds = TD.load_cifar(cifar_root, cifar100=True, train=False)
    seen = np.concatenate([
        TP.BatchLoader(ds, 4, shuffle=False, drop_last=False, num_workers=0, host_id=h,
                       num_hosts=3)._indices() for h in range(3)])
    assert sorted(seen.tolist()) == list(range(N_TEST))


def test_host_shard_without_distributed():
    assert TP.host_shard() == (0, 1)


@pytest.mark.parametrize("decode_size", [None, 24])
def test_image_folder_pngs_equal_jax(tmp_path, decode_size):
    """ImageFolder over PIL-written PNGs of mixed aspect: the class order,
    the samples, and each decode (PIL; at a decode size the shorter side
    resized and centre-cropped), through __getitem__ and through the batch
    loader."""
    root = _write_images(str(tmp_path / "train"), "png", [(20, 30), (40, 24), (32, 32)])
    got, want = TD.ImageFolder(root, decode_size), JD.ImageFolder(root, decode_size)
    assert got.classes == want.classes == ["class_a", "class_b"]
    assert got.samples == want.samples
    _same_dataset(got, want)
    if decode_size is not None:
        kw = dict(shuffle=False, drop_last=False, num_workers=2)
        for g, w in zip(TP.BatchLoader(got, 4, **kw), JP.BatchLoader(want, 4, **kw)):
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native loader with a library of its own, built by
    that loader from the same source into a temporary directory: the one it
    builds next to the source may be in the middle of another test
    process's build, and a failed load makes it fall back to PIL."""
    from uncertainty_vit_tpu.utils import native as JN

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "_LIB", str(tmp_path_factory.mktemp("jax_native") / "libuvit_io.so"))
        mp.setattr(JN, "_lib", None)
        mp.setattr(JN, "_tried", False)
        assert JN.available()
        yield JN


@pytest.mark.parametrize("letterbox", [False, True])
def test_image_folder_native_jpeg_decode_equals_jax(tmp_path, letterbox, jax_native):
    """The batched JPEG decode of both packages' native libraries (built
    from the same source), plain and letterboxed, with a PNG in the batch
    going through PIL."""
    root = _write_images(str(tmp_path / "val"), "jpg", [(40, 30), (28, 44)])
    Image.fromarray(np.full((16, 16, 3), 7, np.uint8)).save(
        os.path.join(root, "class_a", "z.png"))
    got = TD.ImageFolder(root, decode_size=24, letterbox=letterbox)
    want = JD.ImageFolder(root, decode_size=24, letterbox=letterbox)
    idx = list(range(len(got)))
    for g, w in zip(got.native_batch_decode(idx, 2), want.native_batch_decode(idx, 2)):
        assert np.array_equal(g, w)


def _save(path, seed, size=12):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rs = np.random.RandomState(seed)
    Image.fromarray(rs.randint(0, 256, (size, size, 3), dtype=np.uint8)).save(path)


def test_tiny_imagenet_layouts(tmp_path):
    """TinyImageNet's train and val layouts: classes, samples and labels
    equal to the JAX class's, and each image decoded as PIL reads it (at a
    decode size, resized and cropped as ImageFolder's). The JAX class never
    sets ``letterbox``, so its every read fails on the attribute and counts
    as a corrupt image; the port's sets it."""
    root = str(tmp_path / "tin")
    os.makedirs(root)
    with open(os.path.join(root, "wnids.txt"), "w") as f:
        f.write("n02\nn01\n")
    for i, w in enumerate(("n01", "n02")):
        _save(os.path.join(root, "train", w, "images", f"{w}_0.png"), i)
        _save(os.path.join(root, "val", "images", f"val_{i}.png"), 10 + i)
    with open(os.path.join(root, "val", "val_annotations.txt"), "w") as f:
        f.write("val_0.png\tn02\t0\t0\t1\t1\nval_1.png\tn01\t0\t0\t1\t1\n")
    for mode in ("train", "val"):
        got, want = TD.TinyImageNet(root, mode), JD.TinyImageNet(root, mode)
        assert got.classes == want.classes == ["n01", "n02"]
        assert got.samples == want.samples and len(got) == 2
        assert np.array_equal(got.labels, want.labels)
        for i, (path, label) in enumerate(got.samples):
            img, lbl = got[i]
            assert lbl == label and np.array_equal(img, np.asarray(Image.open(path)))
        with pytest.raises(RuntimeError, match="corrupt"):
            want[0]
    tin, nb = TR.build_dataset(False, "tiny_IMNET", root, decode_size=8)
    folder = TD.ImageFolder(str(tmp_path), decode_size=8)  # the same decode
    assert nb == 200
    img, label = tin[0]
    assert img.shape == (8, 8, 3) and label == 1
    assert np.array_equal(img, folder._decode(tin.samples[0][0]))


def test_assemble_batch_equals_np_stack():
    """The native assembly against np.stack: uint8 images, a non-contiguous
    view among them, and int32 extents."""
    assert TN.available()  # g++ and libjpeg are on the CI host
    rs = np.random.RandomState(1)
    images = [rs.randint(0, 256, (9, 7, 3), dtype=np.uint8) for _ in range(5)]
    images[2] = rs.randint(0, 256, (7, 9, 3), dtype=np.uint8).transpose(1, 0, 2)
    got = TN.assemble_batch(images, num_threads=3)
    assert got.dtype == np.uint8 and np.array_equal(got, np.stack(images))
    ext = [np.asarray([i, 2 * i], np.int32) for i in range(4)]
    assert np.array_equal(TN.assemble_batch(ext), np.stack(ext))
    with pytest.raises(ValueError, match="equal shapes"):
        TN.assemble_batch([images[0], images[0][:3]])


def test_native_library_builds_under_build(tmp_path):
    """The library is compiled into build/native/ of the checkout, keyed by
    a hash of the source and flags, never next to the source."""
    assert TN.available()
    built = list(TN.BUILD_DIR.glob("libuvit_io-*.so"))
    assert built and all(p.parent.parent.name == "build" for p in built)
    assert TN.BUILD_DIR.parent.parent == TN.SRC.parent.parent


def test_device_prefetch_on_the_cpu(cifar_root):
    """Arrays become tensors on the device, other items pass through, the
    batches and their order are the loader's, and len is kept."""
    ds = TD.load_cifar(cifar_root, cifar100=True, train=False)
    loader = TP.BatchLoader(ds, 6, shuffle=True, seed=2, drop_last=False, num_workers=2)
    for size in (1, 2, 5):
        pre = TP.device_prefetch(loader, "cpu", size=size)
        assert len(pre) == len(loader) == 4
        got = list(pre)
        want = list(loader)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in g)
            assert torch.equal(g[0], torch.from_numpy(w[0]))
            assert torch.equal(g[1], torch.from_numpy(w[1]))
    mixed = list(TP.device_prefetch([(np.zeros(3, np.uint8), 5)], "cpu"))
    assert mixed[0][1] == 5 and torch.equal(mixed[0][0], torch.zeros(3, dtype=torch.uint8))


def test_without_the_native_library_the_loader_stacks_with_numpy(tmp_path, monkeypatch):
    """Where the library cannot be built (here: a source g++ refuses), the
    loader's assembly is np.stack, the decoders raise, and BUILD_ERROR says
    why."""
    bad = tmp_path / "uvit_io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "SRC", bad)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_tried", False)
    monkeypatch.setattr(TN, "BUILD_ERROR", None)
    assert not TN.available()
    assert "g++ failed" in TN.BUILD_ERROR
    assert not list((tmp_path / "build").glob("*"))  # no partial library left
    arrays = [np.full((2, 2, 3), i, np.uint8) for i in range(3)]
    assert np.array_equal(TN.assemble_batch(arrays), np.stack(arrays))
    with pytest.raises(RuntimeError, match="unavailable"):
        TN.decode_jpeg_batch(["x.jpg"], 8)
