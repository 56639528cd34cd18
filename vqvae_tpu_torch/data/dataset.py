"""Host-side input pipeline: image-folder dataset and prefetching batch
loader (counterpart of ``vqvae_tpu/data/dataset.py``; the reference's torch
DataLoader / Lightning DataModule, data/datasets.py:8-28 and
data/datamodules.py:7-76, and its FFCV path, common_utils.py:38-103).

- ``ImageFolderDataset``: rglob of png/jpg/bmp/JPEG (the reference's
  extension set, datasets.py:12-13), PIL decode -> RGB -> bilinear resize to
  (image_size, image_size) -> uint8 HWC numpy. PIL is imported only when an
  image is decoded, so the packed path runs without it.
- ``Loader``: the JAX package's per-epoch order (the same ``RandomState``
  permutation for a seed and epoch), threaded decode with a prefetch queue,
  drop_last for train and a zero-padded, masked final batch for eval.
  Batches stay uint8 on the host; the Trainer copies them to the card
  through pinned memory.
- ``PackedDataset`` (``data/packed.py``): the packed-record format.

Sharding takes an explicit ``shard_rank`` / ``shard_count`` (default 0 / 1):
shard r iterates samples r::count of the shared order.
"""

from __future__ import annotations

import pathlib
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

EXTENSIONS = ("*.png", "*.jpg", "*.bmp", "*.JPEG")


def _load_pil(path: str, image_size: int) -> np.ndarray:
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


class ImageFolderDataset:
    """Recursive image-folder dataset (reference data/datasets.py:8-28)."""

    def __init__(self, folder: str, image_size: int):
        root = pathlib.Path(folder)
        if not root.is_dir():
            raise FileNotFoundError(f"dataset path not found: {folder}")
        samples = []
        for ext in EXTENSIONS:
            samples.extend(root.rglob(ext))
        self.samples = sorted(samples)
        if not self.samples:
            raise FileNotFoundError(f"no images found under {folder}")
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> np.ndarray:
        return _load_pil(str(self.samples[idx]), self.image_size)


class Loader:
    """Threaded prefetching batch loader over an indexable dataset.

    Yields dicts {"image": (B,H,W,C) uint8, "mask": (B,) bool}. For
    ``drop_last=False`` the final short batch is zero-padded to the static
    batch size with mask=False rows, as in the JAX package (one batch shape
    for every step; the reference batches dynamically, datamodules.py:57-76).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 4, shard_rank: int = 0, shard_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.epoch = 0
        # multi-host sharding: host r iterates samples r::count of the
        # (identically seeded) global order, equal-length on every host so
        # per-step collectives stay in lockstep. Without this every host
        # would feed the SAME rows and the global batch would be
        # `shard_count` duplicates of one per-host batch.
        #
        # drop_last (train): truncate to n // shard_count per host.
        # keep_last (eval): pad the GLOBAL order to a multiple of shard_count
        # with sentinel -1 rows (zero image, mask=False) so EVERY image is
        # evaluated exactly once on exactly one host — unlike the reference's
        # single-GPU eval (evaluate.py:56) this loses nothing at any host
        # count / dataset size.
        self.shard_rank = int(shard_rank)
        self.shard_count = max(1, int(shard_count))

    def _shard_len(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.shard_count
        return -(-n // self.shard_count)  # ceil: padded, lossless

    def __len__(self) -> int:
        n = self._shard_len()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState((self.seed * 100003 + self.epoch) % (2 ** 31))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.shard_count > 1:
            if self.drop_last:
                # same truncated length on every host (train: the final
                # partial batch is dropped anyway)
                order = order[self.shard_rank::self.shard_count][:self._shard_len()]
            else:
                # lossless eval sharding: pad the global order with -1
                # sentinels to shard_count * ceil(n / shard_count), then
                # stride — every host sees the same number of slots, padded
                # slots become mask=False rows
                total = self._shard_len() * self.shard_count
                if total > n:
                    order = np.concatenate(
                        [order, np.full(total - n, -1, order.dtype)])
                order = order[self.shard_rank::self.shard_count]
        return order

    def __iter__(self) -> Iterator[dict]:
        order = self._order()
        n_batches = len(self)
        bs = self.batch_size
        # vectorized batch fetch only for the NATIVE packed reader (one C++
        # call per batch with its own thread pool). The pure-Python packed
        # fallback decodes read_batch sequentially — for it (and image
        # folders) the threaded per-item path parallelizes decode instead.
        batched = (hasattr(self.dataset, "read_batch")
                   and getattr(self.dataset, "is_native", False))

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that never deadlocks: re-checks `stop` so an
            abandoned iterator (consumer exception) can't park the producer
            in q.put forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def _make_batch(imgs_list, valid):
            # valid: per-fetched-row validity (False for -1 sentinel slots of
            # the lossless multi-host padding); short final batches are
            # additionally zero-padded to the static batch size
            mask = np.zeros((bs,), bool)
            mask[:len(imgs_list)] = valid
            if len(imgs_list) < bs:
                pad = bs - len(imgs_list)
                imgs_list = list(imgs_list) + [np.zeros_like(imgs_list[0])] * pad
            images = np.stack(imgs_list)
            images[~mask] = 0
            return {"image": images, "mask": mask}

        def produce():
            # exceptions (corrupt image, truncated pack file, ...) are
            # forwarded to the consumer instead of silently killing this
            # thread and hanging the training loop on q.get()
            try:
                if batched:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        idx = np.asarray(order[b * bs:(b + 1) * bs], np.int64)
                        valid = idx >= 0
                        imgs = list(self.dataset.read_batch(
                            np.where(valid, idx, 0)))
                        if not _put(("batch", _make_batch(imgs, valid))):
                            return
                else:
                    with ThreadPoolExecutor(self.num_workers) as pool:
                        for b in range(n_batches):
                            if stop.is_set():
                                return
                            idx = np.asarray(order[b * bs:(b + 1) * bs])
                            valid = idx >= 0
                            imgs = list(pool.map(self.dataset.__getitem__,
                                                 np.where(valid, idx, 0)))
                            if not _put(("batch", _make_batch(imgs, valid))):
                                return
            except BaseException as exc:  # noqa: BLE001 — forwarded, re-raised
                _put(("error", exc))
                return
            _put(("end", None))

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "end":
                    return
                if kind == "error":
                    raise RuntimeError(
                        "data loader worker failed") from payload
                yield payload
        finally:
            stop.set()


def get_loaders(loader_type: str, dirpath: str, image_size: int,
                batch_size: int, workers: int, seed: int,
                mode: str = "train", shard_rank: Optional[int] = None,
                shard_count: Optional[int] = None):
    """Loader factory (reference get_datamodule, common_utils.py:38-103):
    'standard' = image folders train/ validation/ test/; 'packed' (or
    'ffcv') = packed files train.pack / validation.pack / test.pack. This
    shard iterates samples ``shard_rank::shard_count``, by default this
    rank's shard of the process group (the whole set without one; JAX's
    default is ``process_index`` / ``process_count``). ``batch_size`` is the
    shard's batch."""
    import os

    from vqvae_tpu_torch.parallel.dist import world
    rank, size = world()
    shard_rank = rank if shard_rank is None else shard_rank
    shard_count = size if shard_count is None else shard_count
    if not os.path.isdir(dirpath):
        raise FileNotFoundError(f"dataset path not found: {dirpath}")
    dirpath = dirpath if dirpath.endswith("/") else dirpath + "/"

    def make_ds(subpath: str):
        if loader_type == "standard":
            return ImageFolderDataset(dirpath + subpath, image_size)
        elif loader_type in ("packed", "ffcv"):
            from vqvae_tpu_torch.data.packed import PackedDataset
            return PackedDataset(dirpath + subpath.rstrip("/") + ".pack",
                                 image_size)
        raise ValueError(f"loader type not recognized: {loader_type}")

    kw = dict(seed=seed, num_workers=workers, shard_rank=shard_rank,
              shard_count=shard_count)
    if mode == "train":
        train = Loader(make_ds("train/"), batch_size, shuffle=True,
                       drop_last=True, **kw)
        val = Loader(make_ds("validation/"), batch_size, shuffle=False,
                     drop_last=False, **kw)
        return train, val
    test = Loader(make_ds("test/"), batch_size, shuffle=False,
                  drop_last=False, **kw)
    return test
