"""A dataset held in device memory: training epochs without the host.

The port's copy of the JAX package's ``data/device_cache.py``, for one
device.  The streaming :class:`~.pipeline.Loader` is bounded by the host:
JPEG decode, Python collation and the copy of every batch to the card.
Where the decoded dataset fits the card (600x600x3 u8 is 1.08 MB an image),
this cache decodes it once, keeps every leaf on the device (u8 images
with the u8 wire) and builds each batch with a gather on the
device.  The augmentation still changes every epoch: it runs on the device
inside the train step (``Config.device_augment``,
:mod:`.device_transforms`), drawing from the step's generator.

Over several processes (a data mesh, ``parallel/``) every rank holds the
whole decoded dataset on its own card and, each epoch, gathers the rows
the streaming Loader would give it: the same seeded order, its strided
slice (``shard_count`` / ``shard_index``: its data index's).  This is the
counterpart of the JAX package's single-controller cache sharded over the
mesh; the size check applies to each card.  With image rows over the
model axis (``spatial``) the cache stays whole on every card, as the JAX
package replicates it then, and the ranks of a model group gather the same
batches: each train step augments them for the data index and only then
takes its rows (``nets/detector.py:FasterRCNN.features``).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from two_stage_object_detection_tpu_torch.config import resolve_device
from two_stage_object_detection_tpu_torch.data.pipeline import (
    DetectionDataset, epoch_order)

log = logging.getLogger(__name__)


class DeviceDatasetCache:
    """Loader in place of :class:`~.pipeline.Loader` that serves batches
    from device memory.

    Iterates dicts of device tensors with the Loader's shapes, ``image [B,
    H, W, 3]`` (u8 if the dataset uses the u8 wire), ``boxes [B, G, 4]``,
    ``labels [B, G]``, ``valid [B, G]``, and its epoch semantics: each
    ``__iter__`` is one epoch of :func:`~.pipeline.epoch_order`.

    Needs ``dataset.decode_only``: the cache holds the deterministic decode
    and resize, so the augmentation has to run on the device; a host
    augmentation would freeze one draw into every epoch.  ``max_bytes``
    gates residency: above it the constructor raises :class:`MemoryError`,
    and ``train.build_loaders`` falls back to the streaming Loader.

    Building it decodes every image once on ``num_workers`` threads, then
    copies each leaf to ``device`` in one piece.
    """

    def __init__(self, dataset: DetectionDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 max_bytes: int = 8 << 30, num_workers: int = 8,
                 device="cuda", shard_count: int = 1, shard_index: int = 0):
        if not dataset.decode_only:
            raise ValueError(
                "DeviceDatasetCache requires decode_only=True datasets: the "
                "cache is epoch-invariant, so augmentation must run on "
                "device (Config.device_augment)")
        n = len(dataset)
        if not n:
            raise ValueError("DeviceDatasetCache of an empty dataset")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.device = resolve_device(device)
        self.shard_count, self.shard_index = shard_count, shard_index

        first = dataset.get(0, 0)
        per_sample = sum(np.asarray(v).nbytes for v in first.values())
        total = per_sample * n
        if total > max_bytes:
            raise MemoryError(
                f"the dataset needs {total / 1e9:.2f} GB resident "
                f"(> max_bytes {max_bytes / 1e9:.2f} GB); use the streaming "
                f"Loader or raise Config.cache_device_max_bytes")
        with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
            samples = [first] + list(pool.map(lambda i: dataset.get(i, 0),
                                              range(1, n)))
        self._data = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
                      .to(self.device) for k in first}
        self.n = n
        self.nbytes = total
        log.info("device cache: %d images, %d bytes on %s", n, total,
                 self.device, extra={"cache_images": n, "cache_bytes": total})

    def __len__(self) -> int:
        return len(self._order(self.epoch, self.shuffle))

    def _order(self, epoch: int, shuffle: bool) -> np.ndarray:
        order = epoch_order(self.n, epoch, self.seed, shuffle,
                            self.shard_count, self.shard_index,
                            min_len=self.batch_size)
        nb = max(len(order) // self.batch_size, 1)
        return order[:nb * self.batch_size].reshape(nb, self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        idx = torch.from_numpy(self._order(self.epoch, self.shuffle)).to(
            self.device, non_blocking=True)
        for sel in idx:
            yield {k: v[sel] for k, v in self._data.items()}
        self.epoch += 1

    def epoch_indices(self) -> np.ndarray:
        """One epoch's batch indices ``[n_batches, B]``; advances the epoch.
        For ``nets.trainer.train_macro_step_resident`` with :attr:`data`."""
        order = self._order(self.epoch, self.shuffle)
        self.epoch += 1
        return order

    def all_indices(self) -> np.ndarray:
        """Every sample of this rank's share in order, ``[n_batches, B]``
        (no shuffle, no epoch advance), for
        ``nets.trainer.eval_scan_resident``."""
        return self._order(0, False)

    @property
    def data(self) -> Dict[str, torch.Tensor]:
        """The leaves held on the device, ``{name: [N, ...]}``."""
        return self._data

    def close(self) -> None:
        """The Loader's interface; nothing to stop."""
