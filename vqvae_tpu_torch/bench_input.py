"""Host input-pipeline throughput of the port's loaders: the packed reader
against image-folder decode (counterpart of ``tools/bench_input.py``).

    python -m vqvae_tpu_torch.bench_input [--image_size 256] [--n 2048]
        [--batch_size 32] [--workers 8] [--tmp DIR]

The loaders must not hold the card's train step back. Under ``--tmp``
(default ``<temp dir>/bench_input``) it writes at most 512 seeded JPEGs
(quality 90) of ``image_size``^2 and one ``.pack`` of ``n`` images decoded
from them (``data.packed.write_packed``; named by size and count, so that
another ``--n`` writes its own), then times one shuffled epoch of each (the
pack's ``n`` images, the folder's at most 512)
through ``vqvae_tpu_torch.data`` (``PackedDataset`` or
``ImageFolderDataset`` in a ``Loader`` with ``workers`` threads, drop_last)
on the host clock: images counted by the batches' masks over the seconds of
the epoch. It touches no device; compare its rates with the train step's
images/s on the card. Prints the JAX tool's two lines, the first with
whether the packed reader is the native one (``is_native``); ``main(argv)``
runs in process and returns ``{"packed", "folder"}`` (images/s),
``"native"`` and the images each epoch counted (``"packed_images"``,
``"folder_images"``).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--tmp", default=os.path.join(tempfile.gettempdir(), "bench_input"))
    return ap.parse_args(argv)


def timed(loader) -> tuple:
    """-> (images, images/s) of one epoch of ``loader``, host clock."""
    count = 0
    t0 = time.perf_counter()
    for batch in loader:
        count += int(batch["mask"].sum())
    return count, count / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import numpy as np
    from PIL import Image

    from vqvae_tpu_torch.data.dataset import ImageFolderDataset, Loader
    from vqvae_tpu_torch.data.packed import PackedDataset, write_packed

    size = args.image_size
    folder = os.path.join(args.tmp, f"imgs{size}")
    os.makedirs(folder, exist_ok=True)
    rs = np.random.RandomState(0)
    n_src = min(args.n, 512)  # reuse images; decode cost is per-read anyway
    for i in range(n_src):
        p = os.path.join(folder, f"i{i:04d}.jpg")
        if not os.path.exists(p):
            Image.fromarray(rs.randint(0, 255, (size, size, 3), np.uint8)
                            ).save(p, quality=90)

    pack = os.path.join(args.tmp, f"data{size}_{args.n}.pack")
    ds_folder = ImageFolderDataset(folder, size)
    if not os.path.exists(pack):
        write_packed(pack, (ds_folder[i % n_src] for i in range(args.n)), image_size=size)

    packed = PackedDataset(pack, size)
    try:
        lp = Loader(packed, args.batch_size, shuffle=True, drop_last=True,
                    num_workers=args.workers)
        lf = Loader(ds_folder, args.batch_size, shuffle=True, drop_last=True,
                    num_workers=args.workers)
        n_packed, r_packed = timed(lp)
        n_folder, r_folder = timed(lf)
        native = packed.is_native
    finally:
        packed.close()
    print(f"packed reader  (native={native}): {r_packed:9.0f} img/s")
    print(f"image folder (PIL jpeg decode + resize):    {r_folder:9.0f} img/s")
    return {"packed": r_packed, "folder": r_folder, "native": native,
            "packed_images": n_packed, "folder_images": n_folder}


if __name__ == "__main__":
    main()
