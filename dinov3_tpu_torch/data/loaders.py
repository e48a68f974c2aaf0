"""Dataset factory and the threaded host loader (``dinov3_tpu/data/loaders.py``).

``DataLoader``: ``num_workers`` threads decode and augment samples (PIL
and numpy release the GIL in their loops), batches are collated in order
on a producer thread and up to ``prefetch_batches`` wait ready. Closing
the iterator stops and joins the producer. ``BackgroundIterator`` is that
producer for any iterable (the synthetic stream uses it too).

The dataset strings are the JAX package's (``"Folder:root=/data"``); the
image folder, the synthetic images, ImageNet, ImageNet-22k and web shards
are ported, ADE20K and the captions wait (ROADMAP M12). Nothing here
imports PIL: the datasets are imported when one is made.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from enum import Enum
from typing import Any, Callable, Iterable, Iterator, Optional

from dinov3_tpu_torch.data.samplers import (
    EpochSampler,
    InfiniteSampler,
    ShardedInfiniteSampler,
)
from dinov3_tpu_torch.logging_utils import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


class SamplerType(Enum):
    EPOCH = "epoch"
    INFINITE = "infinite"
    SHARDED_INFINITE = "sharded_infinite"


# ------------------------------------------------------- dataset strings


def _parse_dataset_str(dataset_str: str) -> tuple[str, dict]:
    tokens = dataset_str.split(":")
    name = tokens[0]
    kwargs = {}
    for token in tokens[1:]:
        key, sep, value = token.partition("=")
        if not sep:
            raise ValueError(f"malformed dataset string token {token!r}")
        kwargs[key] = value
    return name, kwargs


def resolve_dataset_str(cfg, dataset_str: str | None = None) -> str:
    """Apply ``cfg.data.root`` / ``cfg.data.backend`` to a dataset string.
    Synthetic takes no root: with ``backend=folder`` the string becomes
    ``Folder:root=<root>``; other backends drop the root with a warning."""
    dataset_str = dataset_str or cfg.train.dataset_path
    root = cfg.data.get("root")
    if not root or ":root=" in dataset_str:
        return dataset_str
    if dataset_str.split(":")[0] == "Synthetic":
        if cfg.data.backend == "folder":
            return f"Folder:root={root}"
        logger.warning("data.root=%s ignored: dataset %r is synthetic and "
                       "data.backend=%r is not 'folder'", root, dataset_str,
                       cfg.data.backend)
        return dataset_str
    return f"{dataset_str}:root={root}"


# datasets of the JAX package that wait, by their dataset-string names
_WAITING_DATASETS = ("ADE20K", "CocoCaptions")


def make_dataset(dataset_str: str, transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None, seed: int = 0):
    """``"ImageNet:split=TRAIN:root=/data/in1k"`` -> dataset instance
    (``Folder``, ``Synthetic``, ``ImageNet``, ``ImageNet22k`` or
    ``WebShards``); ``size``, ``image_size`` and ``n_classes`` are read as
    ints."""
    name, kwargs = _parse_dataset_str(dataset_str)
    if name in _WAITING_DATASETS:
        raise NotImplementedError(
            f"dataset {name!r}: ADE20K and captions wait with their tokenizer "
            "(ROADMAP M12)")
    from dinov3_tpu_torch.data import datasets as D

    registry = {"Folder": D.ImageFolder, "Synthetic": D.SyntheticImages,
                "ImageNet": D.ImageNet, "ImageNet22k": D.ImageNet22k,
                "WebShards": D.WebShards}
    if name not in registry:
        raise ValueError(f"unknown dataset {name!r} (have {sorted(registry)})")
    for int_key in ("size", "image_size", "n_classes"):
        if int_key in kwargs:
            kwargs[int_key] = int(kwargs[int_key])
    logger.info('making dataset "%s"', dataset_str)
    return registry[name](transform=transform, target_transform=target_transform,
                          seed=seed, **kwargs)


def make_sampler(dataset, type: SamplerType = SamplerType.SHARDED_INFINITE,
                 shuffle: bool = True, seed: int = 0, rank: int = 0,
                 world_size: int = 1, advance: int = 0):
    cls = {SamplerType.EPOCH: EpochSampler,
           SamplerType.INFINITE: InfiniteSampler,
           SamplerType.SHARDED_INFINITE: ShardedInfiniteSampler}[type]
    sampler = cls(size=len(dataset), rank=rank, world_size=world_size,
                  shuffle=shuffle, seed=seed)
    if advance:
        sampler.advance(advance)
    return sampler


# ------------------------------------------------------------- iterators


_END = object()


class _Raised:
    def __init__(self, error: BaseException):
        self.error = error


class BackgroundIterator:
    """Iterates ``source`` on a producer thread, up to ``depth`` items
    ahead, applying ``transform`` there. ``close()`` (called on exhaustion
    and on an error too) stops the producer, closes the source and joins
    the thread."""

    def __init__(self, source: Iterable, depth: int = 2,
                 transform: Callable | None = None):
        self._source = source
        self._transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="dinov3-data-producer")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        it = iter(self._source)
        try:
            for item in it:
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put(item):
                    return
            self._put(_END)
        except Exception as e:  # handed to the consumer, raised there
            self._put(_Raised(e))
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        while True:
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    self.close()
                    raise StopIteration from None
        if item is _END:
            self.close()
            raise StopIteration
        if isinstance(item, _Raised):
            self.close()
            raise item.error
        return item

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def close(self, timeout: float = 30.0) -> None:
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)


class DataLoader:
    """``num_workers`` threads map ``dataset[i]``; batches are collated in
    sampler order; up to ``prefetch_batches`` wait ready. Iterating
    returns a ``BackgroundIterator``: close it to stop the workers."""

    def __init__(self, dataset, sampler, batch_size: int,
                 collate_fn: Callable[[list], Any], num_workers: int = 8,
                 prefetch_batches: int = 2, drop_last: bool = True):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.drop_last = drop_last

    def _index_batches(self) -> Iterator[list[int]]:
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def _batches(self) -> Iterator[Any]:
        """Collated batches in order, a window of ``prefetch_batches``
        batches in flight on the pool."""
        pool = ThreadPoolExecutor(self.num_workers)
        try:
            index_iter = self._index_batches()
            pending = []
            for idxs in index_iter:
                pending.append([pool.submit(self.dataset.__getitem__, i) for i in idxs])
                if len(pending) < self.prefetch_batches:
                    continue
                yield self.collate_fn([f.result() for f in pending.pop(0)])
            while pending:
                yield self.collate_fn([f.result() for f in pending.pop(0)])
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def __iter__(self) -> BackgroundIterator:
        return BackgroundIterator(self._batches(), depth=self.prefetch_batches)


def make_data_loader(dataset, batch_size: int, collate_fn: Callable, *,
                     num_workers: int = 8, shuffle: bool = True, seed: int = 0,
                     rank: int = 0, world_size: int = 1,
                     sampler_type: SamplerType = SamplerType.SHARDED_INFINITE,
                     sampler_advance: int = 0, drop_last: bool = True,
                     prefetch_batches: int = 2) -> DataLoader:
    sampler = make_sampler(dataset, sampler_type, shuffle=shuffle, seed=seed,
                           rank=rank, world_size=world_size,
                           advance=sampler_advance)
    return DataLoader(dataset, sampler, batch_size, collate_fn,
                      num_workers=num_workers, prefetch_batches=prefetch_batches,
                      drop_last=drop_last)
