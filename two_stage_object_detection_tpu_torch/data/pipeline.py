"""Dataset, per-epoch sample order, and a double-buffered batch loader.

The port's copy of the JAX package's ``data/pipeline.py``, with the same
augmentation streams, so that for a seed and an epoch both packages produce
the same batches bit for bit:

* a :class:`DetectionDataset` producing *fixed-shape* samples: images
  resized to the configured input size and GT padded to ``max_gt_boxes``
  with a validity mask;
* :func:`epoch_order`, the seeded per-epoch order;
* a :class:`Loader` that decodes/augments on a worker pool and keeps a small
  queue of ready host batches, overlapping input preparation with device
  compute.

Placement on the card (``Loader(device_put=...)``, :class:`DevicePut`): the
producer thread stacks each batch into pinned host memory, and the
consumer's thread enqueues the copy with ``non_blocking=True`` on its own
current stream, the stream its train step then runs on.  So the copy can
never be read before it lands (stream order), the host does not wait for
it, and the pinned block is not reused before the copy is done (PyTorch's
pinned-memory allocator records the copy's event).  The JAX package calls
its ``device_put`` on the producer thread; a copy issued on another
thread's stream here would need an event for the consumer to wait on.

PIL is imported inside the functions that decode with it.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np

from two_stage_object_detection_tpu_torch.data.coco import (
    CocoIndex, pack_polygon)
from two_stage_object_detection_tpu_torch.data.transforms import (
    eval_transform, train_transform)


class DetectionDataset:
    """Fixed-shape detection samples from a :class:`CocoIndex`.

    ``decode_only=True``: the host does just the C++ decode+resize
    (``native/preprocess.cpp`` fused ``decode_resize_normalize``) and box
    rescale; the train step then augments on the device
    (``Config.device_augment``, :mod:`.device_transforms`), and
    :class:`~.device_cache.DeviceDatasetCache` holds these samples.

    ``cache=True``: decoded images are kept in RAM as u8 (the FFCV/DALI
    recipe), so epochs after the first skip JPEG decode entirely — the
    dominant host cost.  In ``decode_only`` mode the *resized* image is
    cached (1 byte/px at input size); in host-augment mode the
    original-resolution decode is cached and augmentation still runs per
    epoch.  u8 re-quantisation deviates <=1/510 per pixel — far below the
    photometric augmentation noise.  Insertion stops at ``cache_max_bytes``
    (no eviction: steady-state behavior stays predictable).  The reference
    re-decodes every epoch in its DataLoader workers
    (dataset/dataloader.py:33-48).

    ``max_vertices > 0`` (Mask R-CNN; the index loaded with
    ``load_coco(polygons=True)``): each sample also holds ``polys [G, V,
    2]`` f32 and ``poly_edges [G, V]`` bool (``V = max_vertices``,
    :func:`~.coco.pack_polygon`), each object's rings moved with its box
    through the transforms (their ``polys``), in the boxes' slots.
    """

    def __init__(self, index: CocoIndex, input_size=(600, 600),
                 max_gt: int = 100, train: bool = True, seed: int = 0,
                 decode_only: bool = False, cache: bool = False,
                 cache_max_bytes: int = 4 << 30,
                 uint8_images: bool = False, max_vertices: int = 0):
        self.index = index
        self.max_vertices = max_vertices
        self.input_size = tuple(input_size)
        self.max_gt = max_gt
        self.train = train
        self.seed = seed
        self.decode_only = decode_only
        self._cache = {} if cache else None
        self._cache_bytes = 0
        self.cache_max_bytes = cache_max_bytes
        self._cache_lock = threading.Lock()
        # wire format: emit images as u8 [0,255]; the jitted steps convert
        # to f32 on device (Config.transfer_uint8) — 4x less host->device
        # traffic, <=1/510 per-pixel quantisation
        self.uint8_images = uint8_images

    def __getstate__(self):
        # locks don't pickle (spawn-mode process workers ship the dataset);
        # each worker process gets its own lock + private cache anyway
        d = self.__dict__.copy()
        d["_cache_lock"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._cache_lock = threading.Lock()

    def _cache_put(self, i: int, value, nbytes: int) -> None:
        # the lock makes the byte-cap check-then-add atomic: concurrent
        # loader workers could otherwise all pass the check before any
        # adds, overshooting cache_max_bytes by up to num_workers samples
        # (and the unlocked += lost updates, under-counting).  Process
        # workers each hold their own copy (documented).
        if self._cache is None:
            return
        with self._cache_lock:
            if self._cache_bytes + nbytes <= self.cache_max_bytes:
                self._cache[i] = value
                self._cache_bytes += nbytes

    def __len__(self):
        return len(self.index.records)

    def load_image(self, rec, i: Optional[int] = None) -> np.ndarray:
        from two_stage_object_detection_tpu_torch.data import native

        if self._cache is not None and i is not None and i in self._cache:
            return self._cache[i].astype(np.float32) / 255.0
        u8 = native.decode(rec["image_path"])     # C++ libjpeg/libpng path
        if u8 is None:
            from PIL import Image
            img = Image.open(rec["image_path"]).convert("RGB")
            u8 = np.asarray(img, np.uint8)
        if i is not None:
            self._cache_put(i, u8, u8.nbytes)
        return u8.astype(np.float32) / 255.0

    def _decode_resized(self, rec, i: Optional[int] = None):
        """Fused decode+resize -> (img f32 [H,W,3], boxes scaled, labels,
        the kept boxes' rings scaled as they are, none without
        ``max_vertices``)."""
        from two_stage_object_detection_tpu_torch.data import native
        from two_stage_object_detection_tpu_torch.data.transforms import (
            sanitize_boxes)

        if self._cache is not None and i is not None and i in self._cache:
            u8, boxes, labels, polys = self._cache[i]
            if self.uint8_images:      # u8 wire format: no f32 roundtrip
                return u8, boxes, labels, polys
            return u8.astype(np.float32) / 255.0, boxes, labels, polys
        out = native.decode_resize(rec["image_path"], self.input_size)
        if out is not None:
            img, oh, ow = out
        else:
            from PIL import Image
            pil = Image.open(rec["image_path"]).convert("RGB")
            ow, oh = pil.size
            h1, w1 = self.input_size
            img = np.asarray(pil.resize((w1, h1), Image.BILINEAR),
                             np.float32) / 255.0
        h1, w1 = self.input_size
        boxes = rec["boxes"] * np.array([w1 / ow, h1 / oh, w1 / ow, h1 / oh],
                                        np.float32)
        rings = ([[r * np.array([w1 / ow, h1 / oh], np.float32) for r in rr]
                  for rr in rec["polys"]] if self.max_vertices
                 else [[] for _ in boxes])
        boxes, labels, polys = sanitize_boxes(boxes, rec["labels"],
                                              self.input_size, polys=rings)
        # quantize only when a cache exists to receive it: without the
        # _cache guard every no-cache access paid a full-image
        # rint+clip+astype (~1.1M px) just to throw the result away
        if self._cache is not None and i is not None:
            u8 = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
            self._cache_put(i, (u8, boxes, labels, polys),
                            u8.nbytes + boxes.nbytes)
        return img, boxes, labels, polys

    def __getitem__(self, i: int):
        return self.get(i, 0)

    def get(self, i: int, epoch: int = 0):
        """Sample ``i`` with the augmentation stream of ``epoch``.

        The epoch enters the rng derivation so each image draws *fresh*
        augmentations every epoch (the reference gets this implicitly from
        torch's global-rng DataLoader workers) — essential once ``cache``
        removes the decode, or training would see identical pixels each
        epoch modulo shuffle order.
        """
        rec = self.index.records[i]
        if self.decode_only:
            img, boxes, labels, polys = self._decode_resized(rec, i)
        else:
            img = self.load_image(rec, i)
            boxes = rec["boxes"]
            labels = rec["labels"]
            rng = np.random.RandomState(
                (self.seed * 100003 + epoch * 7919 + i) % (2 ** 31))
            tf = train_transform if self.train else eval_transform
            if self.max_vertices:
                img, boxes, labels, polys = tf(img, boxes, labels, rng,
                                               size=self.input_size,
                                               polys=rec["polys"])
            else:
                img, boxes, labels = tf(img, boxes, labels, rng,
                                        size=self.input_size)

        g = self.max_gt
        out_boxes = np.zeros((g, 4), np.float32)
        out_labels = np.zeros((g,), np.int32)
        out_valid = np.zeros((g,), bool)
        n = min(len(boxes), g)
        out_boxes[:n] = boxes[:n]
        out_labels[:n] = labels[:n]
        out_valid[:n] = True
        if self.uint8_images:
            if img.dtype != np.uint8:
                img = np.clip(np.rint(img * 255.0), 0, 255).astype(np.uint8)
        else:
            img = img.astype(np.float32)
        out = {"image": img, "boxes": out_boxes,
               "labels": out_labels, "valid": out_valid}
        if self.max_vertices:
            out["polys"], out["poly_edges"] = self._polygons(polys[:n])
        return out

    def _polygons(self, polys):
        """``(polys [G, V, 2], poly_edges [G, V])``: each kept box's rings
        packed into its slot."""
        g, v = self.max_gt, self.max_vertices
        out = np.zeros((g, v, 2), np.float32)
        edges = np.zeros((g, v), bool)
        for slot, rings in enumerate(polys):
            out[slot], edges[slot] = pack_polygon(rings, v)
        return out, edges


def epoch_order(n: int, epoch: int, seed: int, shuffle: bool,
                shard_count: int = 1, shard_index: int = 0,
                min_len: int = 1) -> np.ndarray:
    """Deterministic per-epoch sample order, shared by :class:`Loader` and
    :class:`~.device_cache.DeviceDatasetCache`.

    Every host shuffles the SAME seeded global permutation and takes a
    disjoint strided slice, so across ``shard_count`` processes each epoch
    covers the dataset exactly once with no coordination traffic.  Short
    orders are tiled up to ``min_len`` (one full batch).

    Shards are EQUAL length: the tail remainder (< shard_count samples) is
    dropped each epoch so every process dispatches the same number of
    collective train steps — a ragged shard would leave one process
    issuing a step its peers never join (SPMD hang).  The dropped tail
    rotates with the shuffle, so over epochs coverage is still complete.
    When ``n < shard_count`` every process keeps the full (tiny) order —
    duplicated samples, but aligned step counts."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(order)
    if shard_count > 1 and n >= shard_count:
        usable = (n // shard_count) * shard_count
        order = order[:usable][shard_index::shard_count]
    if len(order) < min_len:
        order = np.resize(order, min_len)
    return order


# Process-pool worker state: the dataset is shipped once per worker via the
# pool initializer.  Workers are spawned, not forked: the parent runs
# threads (torch's, the loader's producer), and children only run
# numpy/PIL/C++ decode.
_WORKER_DS: Optional[DetectionDataset] = None


def _init_worker(ds: DetectionDataset) -> None:
    global _WORKER_DS
    _WORKER_DS = ds


def _worker_getitem(args):
    i, epoch = args
    return _WORKER_DS.get(i, epoch)


class Loader:
    """Batch loader with a background producer and a worker pool.

    Iterates dicts of stacked numpy arrays: ``image [B,H,W,3]``,
    ``boxes [B,G,4]``, ``labels [B,G]``, ``valid [B,G]``.  ``drop_last`` is
    implied: the batch shape is static (pad-free), matching compiled graphs.

    ``worker_mode``: ``"thread"`` (default — the C++ decode/resize releases
    the GIL) or ``"process"`` (reference parity with DataLoader worker
    processes, ``dataset/dataloader.py:63-74``; sidesteps the GIL when
    Python-side augmentation dominates).  ``persistent_workers`` keeps the
    pool alive across epochs (reference ``configs/config.json``).

    ``device_put``: applied to each batch on the consumer's thread, after
    its ``prepare`` (if it has one) on the producer thread; see
    :class:`DevicePut` and the module docstring.  ``None`` yields the host
    batches.

    ``shard_count`` / ``shard_index``: the rank's share of every epoch
    over several processes, :func:`epoch_order`'s strided slice of the
    same seeded order (equal lengths on every rank).
    """

    def __init__(self, dataset: DetectionDataset, batch_size: int,
                 shuffle: bool = True, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 0,
                 device_put: Optional[Callable] = None,
                 worker_mode: str = "thread",
                 persistent_workers: bool = True,
                 shard_count: int = 1, shard_index: int = 0):
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} out of range for "
                             f"shard_count {shard_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.prefetch = max(prefetch, 1)
        self.seed = seed
        self.epoch = 0
        self.device_put = device_put
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', "
                             f"got {worker_mode!r}")
        self.worker_mode = worker_mode
        self.persistent_workers = persistent_workers
        self.shard_count = shard_count
        self.shard_index = shard_index
        self._pool = None

    def _make_pool(self):
        if self.worker_mode == "process":
            return ProcessPoolExecutor(
                self.num_workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_worker, initargs=(self.dataset,))
        return ThreadPoolExecutor(self.num_workers)

    def _get_pool(self):
        if self.persistent_workers:
            if self._pool is None:
                self._pool = self._make_pool()
            return self._pool, False
        return self._make_pool(), True

    def _map_fn(self, epoch: int):
        if self.worker_mode == "process":
            return _worker_getitem, (lambda i: (i, epoch))
        return (lambda i: self.dataset.get(i, epoch)), (lambda i: i)

    def close(self):
        """Shut down a persistent worker pool (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        n = len(self.dataset)
        if self.shard_count > 1 and n >= self.shard_count:
            n //= self.shard_count
        return max(n // self.batch_size, 1)

    def _epoch_order(self):
        return epoch_order(len(self.dataset), self.epoch, self.seed,
                           self.shuffle, self.shard_count, self.shard_index,
                           min_len=self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        order = self._epoch_order()
        n_batches = max(len(order) // self.batch_size, 1)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        pool, own_pool = self._get_pool()
        map_fn, pack = self._map_fn(self.epoch)
        put = self.device_put
        prepare = getattr(put, "prepare", None)

        def produce():
            try:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                    samples = list(pool.map(map_fn, [pack(i) for i in idxs]))
                    batch = {k: np.stack([s[k] for s in samples])
                             for k in samples[0]}
                    if prepare is not None:
                        batch = prepare(batch)
                    q.put(batch)
            except BaseException as e:      # re-raised on the consumer's side
                q.put(_Failed(e))
                return
            finally:
                if own_pool:
                    pool.shutdown()
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, _Failed):
                    raise batch.error
                yield batch if put is None else put(batch)
        finally:
            stop.set()
            while t.is_alive():             # unblock a producer on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
        self.epoch += 1


class _Failed:
    """A producer-side exception, carried through the queue."""

    def __init__(self, error: BaseException):
        self.error = error


class DevicePut:
    """Places host batches on ``device`` for :class:`Loader`.

    ``prepare`` (producer thread): numpy arrays to tensors, in pinned host
    memory when ``device`` is a CUDA device.  ``__call__`` (consumer's
    thread): the copies, ``non_blocking`` on the consumer's current stream.
    On the CPU both are plain conversions.
    """

    scheme = ("pinned host memory (producer thread), non_blocking copy on "
              "the consumer's stream")

    def __init__(self, device):
        import torch
        self.device = torch.device(device)

    def prepare(self, batch: dict) -> dict:
        import torch
        out = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items()}
        if self.device.type == "cuda":
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def __call__(self, batch: dict) -> dict:
        return {k: v.to(self.device, non_blocking=True)
                for k, v in batch.items()}
