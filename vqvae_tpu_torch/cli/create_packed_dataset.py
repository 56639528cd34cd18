"""Pack image folders into .pack files (counterpart of the JAX package's
``create_packed_dataset.py``, with its flags; the reference's FFCV beton
writer, data/create_beton_file.py:10-22):

    python -m vqvae_tpu_torch.cli.create_packed_dataset --max_resolution 256 \
        --output_folder /data/packed --train_folder /data/imagenet/train \
        --val_folder /data/imagenet/validation --test_folder /data/imagenet/test

Writes train.pack / validation.pack / test.pack / predict.pack (HWC uint8,
resized to max_resolution; --compress for zlib records) in the format both
packages read. Decoding the folders needs PIL. ``main(argv)`` runs in process.
"""

from __future__ import annotations

import argparse
import os


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Pack an image dataset for fast data loading")
    parser.add_argument('--max_resolution', type=int, default=256)
    parser.add_argument('--output_folder', type=str, required=True)
    parser.add_argument('--train_folder', type=str, default=None)
    parser.add_argument('--val_folder', type=str, default=None)
    parser.add_argument('--test_folder', type=str, default=None)
    parser.add_argument('--predict_folder', type=str, default=None)
    parser.add_argument('--compress', action='store_true',
                        help='zlib-compress records (smaller files, slightly slower reads)')
    parser.add_argument('--workers', type=int, default=8)
    return parser.parse_args(argv)


def pack_split(folder: str, out_path: str, resolution: int, compress: bool, workers: int) -> int:
    from concurrent.futures import ThreadPoolExecutor

    from vqvae_tpu_torch.data.dataset import ImageFolderDataset
    from vqvae_tpu_torch.data.packed import write_packed

    ds = ImageFolderDataset(folder, resolution)

    def images():
        # bounded chunks, so that decoding never runs far ahead of the writer
        chunk = max(64, workers * 16)
        with ThreadPoolExecutor(workers) as pool:
            for start in range(0, len(ds), chunk):
                yield from pool.map(ds.__getitem__, range(start, min(start + chunk, len(ds))))

    n = write_packed(out_path, images(), resolution, compress=compress)
    print(f"wrote {out_path}: {n} records @ {resolution}x{resolution}")
    return n


def main(argv=None):
    args = get_args(argv)
    os.makedirs(args.output_folder, exist_ok=True)
    for name, folder in [("train", args.train_folder), ("validation", args.val_folder),
                         ("test", args.test_folder), ("predict", args.predict_folder)]:
        if folder is not None:
            pack_split(folder, f"{args.output_folder}/{name}.pack", args.max_resolution,
                       args.compress, args.workers)


if __name__ == '__main__':
    main()
