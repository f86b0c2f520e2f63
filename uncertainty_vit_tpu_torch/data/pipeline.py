"""Host input pipeline: a sharded, shuffled, prefetching batch loader, and
the copy of its batches onto a device.

Counterpart of uncertainty_vit_tpu/data/pipeline.py (``BatchLoader``
:20-150, ``device_prefetch`` :151-183), which replaces the reference's
DataLoader + DistributedSampler (run_cyclical.py:474-494). ``BatchLoader``
is a copy: each process takes its shard of the dataset (``host_shard``:
its rank and the world size of torch.distributed when that is started, else
0 and 1), an epoch reshuffles with ``RandomState(seed + epoch)`` like
DistributedSampler.set_epoch, and a pool of threads decodes and assembles
batches ahead of the consumer. Batches are raw uint8 [B, H, W, C] and int
labels (numpy); the transforms run on the device.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator, Tuple

import numpy as np
import torch
import torch.distributed as dist


def global_order(idx: np.ndarray, hosts: int, batch: int) -> Tuple[np.ndarray, np.ndarray]:
    """(indices, slots): the order in which one process reads the global
    batches of ``hosts`` hosts whose padded shards of ``idx`` each give
    batches of ``batch``: global batch k is host 0's batch k, then host
    1's, .... ``slots`` holds each read's place in the padded ``idx``, where
    host d's shard is slots d, d + hosts, d + 2·hosts, ...."""
    n = len(idx)
    per_host = -(-n // hosts)
    padded = np.concatenate([idx, idx[: per_host * hosts - n]])
    shards = [np.arange(d, per_host * hosts, hosts) for d in range(hosts)]
    slots = np.concatenate([s[k:k + batch] for k in range(0, per_host, batch) for s in shards])
    return padded[slots], slots


def host_shard(mesh=None) -> Tuple[int, int]:
    """(host_id, num_hosts) of this process: its rank and the world size
    when torch.distributed is started, else (0, 1). Under a
    ``parallel.mesh.Mesh`` the ranks of one data index read the same
    images (the seq ranks split their tokens): (its data index, the data
    axis's size), the JAX loader's (process_index, process_count) of a
    process that holds one data index (JAX cli/builders.py:353-361)."""
    if mesh is not None:
        return mesh.index("data"), mesh.size("data")
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class BatchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 8,
        host_id: int = 0,
        num_hosts: int = 1,
        prefetch: int = 4,
        pad_shards: bool | None = None,
        hosts_per_batch: int = 1,
    ):
        if hosts_per_batch > 1 and (num_hosts > 1 or batch_size % hosts_per_batch):
            raise ValueError(f"hosts_per_batch {hosts_per_batch} reads one host's batches of "
                             f"{batch_size}")
        self.hosts_per_batch = hosts_per_batch
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch
        # Shard-padding policy. Training (shuffle or drop_last) needs equal
        # shard sizes so every host dispatches the same number of lockstep
        # steps — pad by wrapping, like DistributedSampler. Eval loops are
        # host-local (evals/classification.py collects logits per host, no
        # in-loop collectives), and padded duplicates would skew the global
        # metrics — so the eval configuration defaults to UNEVEN, unpadded
        # shards: the union over hosts is the dataset exactly once.
        if pad_shards is None:
            pad_shards = shuffle or drop_last
        self.pad_shards = pad_shards
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The epoch's shuffle; a dataset with a ``set_epoch`` of its own (the
        triplet dataset's negatives) is told too."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        if self.hosts_per_batch > 1:
            return self._global_order(idx)
        # per-host shard (DistributedSampler semantics: pad to equal shards;
        # eval default is unpadded/uneven — see pad_shards in __init__)
        if self.num_hosts > 1:
            if self.pad_shards:
                per_host = (n + self.num_hosts - 1) // self.num_hosts
                padded = np.concatenate([idx, idx[: per_host * self.num_hosts - n]])
                idx = padded[self.host_id :: self.num_hosts]
            else:
                idx = idx[self.host_id :: self.num_hosts]
        return idx

    def _global_order(self, idx: np.ndarray) -> np.ndarray:
        """``hosts_per_batch`` = h: the order in which one host reads the
        global batches of h hosts whose padded shards (``pad_shards``
        forced, as on a data axis) each give batches of batch_size / h
        (``global_order``). One process so reads what a mesh of h data
        ranks reads (the tests' and the smoke's one-process reference)."""
        return global_order(idx, self.hosts_per_batch,
                            self.batch_size // self.hosts_per_batch)[0]

    def _read_plan(self) -> Tuple[np.ndarray, np.ndarray]:
        """(order, positions): the dataset indices that one process reads
        in this epoch, in order, where this host's padded shard of them is
        its data rank's share (``global_order``: one process's global
        batches of every host's batches), and the place in ``order`` of each
        of this host's indices, in its reading order. One host reads order
        itself."""
        if self.num_hosts == 1:
            order = self._indices()
            return order, np.arange(len(order))
        if not self.pad_shards:
            raise ValueError("reads keyed on one process's order need padded shards")
        n = len(self.dataset)
        idx = np.random.RandomState(self.seed + self.epoch).permutation(n) if self.shuffle \
            else np.arange(n)
        order, slots = global_order(idx, self.num_hosts, self.batch_size)
        place = np.empty_like(slots)
        place[slots] = np.arange(len(slots))
        return order, place[self.host_id::self.num_hosts]

    def real_count(self) -> int:
        """The samples of this host's shard that are not padding: a prefix
        of the shard, since the wrapped duplicates close the last hosts'
        shards (the dataset's own count on one host)."""
        n = len(self.dataset)
        return n if self.num_hosts == 1 else len(range(self.host_id, n, self.num_hosts))

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_batch(self, batch_idx: np.ndarray, positions=None):
        """One batch of the dataset's items; with ``positions`` (a dataset
        whose draws are keyed on one process's reads, one with ``plan``)
        item i is ``dataset.item_at(i, its read position)``."""
        if positions is not None:
            items = [self.dataset.item_at(int(i), int(p)) for i, p in zip(batch_idx, positions)]
            return self._assemble(items)
        # fast path: GIL-free batched decode in the C++ IO runtime
        if hasattr(self.dataset, "native_batch_decode") and getattr(
            self.dataset, "decode_size", None
        ):
            return self.dataset.native_batch_decode(
                batch_idx, num_threads=max(self.num_workers, 1)
            )

        return self._assemble([self.dataset[int(i)] for i in batch_idx])

    @staticmethod
    def _assemble(items):
        cols = list(zip(*items))
        from uncertainty_vit_tpu_torch.utils import native

        out = []
        for col in cols[:-1]:
            out.append(native.assemble_batch(list(col)))
        out.append(np.asarray(cols[-1], np.int64))
        return tuple(out)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        idx = self._indices()
        nb = len(self)
        cut = [slice(i * self.batch_size, (i + 1) * self.batch_size) for i in range(nb)]
        if hasattr(self.dataset, "plan"):
            # the dataset's draws keyed on one process's reads (the triplet
            # negatives): whatever host or thread loads an item
            order, positions = self._read_plan()
            self.dataset.plan(order)
            batches = [(idx[c], positions[c]) for c in cut]
        else:
            batches = [(idx[c], None) for c in cut]

        if self.num_workers <= 0:
            for b in batches:
                yield self._load_batch(*b)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                import concurrent.futures as cf

                with cf.ThreadPoolExecutor(self.num_workers) as pool:
                    futures = []
                    for b in batches:
                        if stop.is_set():
                            return
                        futures.append(pool.submit(self._load_batch, *b))
                        # keep a bounded window of in-flight batches
                        while len(futures) > self.prefetch:
                            q.put(("ok", futures.pop(0).result()))
                            if stop.is_set():
                                return
                    for f in futures:
                        if stop.is_set():
                            return
                        q.put(("ok", f.result()))
            except Exception as e:  # surface worker errors on the consumer
                q.put(("err", e))
            finally:
                q.put(("done", None))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "ok":
                    yield payload
                elif kind == "err":
                    raise payload
                else:
                    return
        finally:
            stop.set()


class device_prefetch:
    """Copies each batch's numpy arrays onto ``device`` one or more batches
    ahead of the consumer, so the copy of batch i+1 overlaps the work on
    batch i (the reference's pin_memory + non_blocking copies,
    run_cyclical.py:58-60). On a CUDA device an array goes through a pinned
    host tensor and a ``non_blocking`` copy; the host tensor may then go out
    of scope, because PyTorch's caching host allocator records an event
    behind every copy out of a pinned block and reuses the block only once
    that event has completed. Other items of a batch (ints) pass through.
    Keeps the wrapped loader's ``len``."""

    def __init__(self, iterable, device, size: int = 2):
        self.iterable = iterable
        self.device = torch.device(device)
        self.size = size

    def __len__(self):
        return len(self.iterable)

    def _put(self, item):
        cuda = self.device.type == "cuda"
        out = []
        for x in item:
            if isinstance(x, np.ndarray):
                host = torch.from_numpy(x)
                x = (host.pin_memory() if cuda else host).to(self.device, non_blocking=cuda)
            out.append(x)
        return tuple(out)

    def __iter__(self):
        ahead: "collections.deque" = collections.deque()
        for item in self.iterable:
            ahead.append(self._put(item))
            if len(ahead) >= self.size:
                yield ahead.popleft()
        while ahead:
            yield ahead.popleft()
