"""The port's data modules against the JAX package's on the CPU:
- ``write_packed`` writes a file byte-identical to JAX's (raw and zlib);
- each package's ``PackedDataset`` reads the other's file, and the port's
  native reader (``csrc/packio.cpp``) equals its Python mmap reader;
- ``Loader`` yields the JAX ``Loader``'s batches (order, zero padding, mask)
  for the same seed, epoch and shard, train and eval, 1 and 3 shards;
- ``ImageFolderDataset`` decodes as JAX's does, and ``get_loaders`` takes
  its shard explicitly (no ``jax.process_index()``) and refuses a missing
  path; the packer CLI writes what ``write_packed`` writes.
"""

import numpy as np
import pytest

from vqvae_tpu.data import dataset as jds
from vqvae_tpu.data import packed as jpk
from vqvae_tpu_torch.cli import create_packed_dataset
from vqvae_tpu_torch.data import dataset as tds
from vqvae_tpu_torch.data import packed as tpk

SIZE = 8


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)


@pytest.mark.parametrize("compress", [False, True])
def test_write_packed_is_byte_identical_and_cross_readable(tmp_path, compress):
    imgs = _images(11)
    ours, theirs = tmp_path / "ours.pack", tmp_path / "theirs.pack"
    assert tpk.write_packed(str(ours), iter(imgs), SIZE, compress=compress) == 11
    jpk.write_packed(str(theirs), iter(imgs), SIZE, compress=compress)
    assert ours.read_bytes() == theirs.read_bytes()
    idx = np.array([3, 0, 10, 3], np.int64)
    port = tpk.PackedDataset(str(theirs), SIZE)
    jax_side = jpk.PackedDataset(str(ours), SIZE)
    try:
        assert port.is_native and len(port) == len(jax_side) == 11
        np.testing.assert_array_equal(port.read_batch(idx), imgs[idx])
        np.testing.assert_array_equal(jax_side.read_batch(idx), imgs[idx])
        np.testing.assert_array_equal(port[7], imgs[7])
    finally:
        port.close()
        jax_side.close()


@pytest.mark.parametrize("compress", [False, True])
def test_native_reader_equals_python_reader(tmp_path, monkeypatch, compress):
    imgs = _images(9, seed=1)
    path = str(tmp_path / "x.pack")
    tpk.write_packed(path, iter(imgs), SIZE, compress=compress)
    native = tpk.PackedDataset(path)
    monkeypatch.setattr(tpk, "_library", lambda: None)
    python = tpk.PackedDataset(path)
    assert native.is_native and not python.is_native
    idx = np.random.RandomState(2).randint(0, 9, 20)
    np.testing.assert_array_equal(native.read_batch(idx), python.read_batch(idx))
    assert (native.count, native.h, native.w, native.c, native.mode) == (
        python.count, python.h, python.w, python.c, python.mode)
    with pytest.raises(ValueError, match="resolution"):
        tpk.PackedDataset(path, image_size=SIZE * 2)
    python.close()
    native.close()


class _Arrays:
    def __init__(self, n):
        self.imgs = _images(n, seed=3)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.imgs[i]


@pytest.mark.parametrize("shard_count", [1, 3])
@pytest.mark.parametrize("train", [True, False])
def test_loader_batches_equal_jax(train, shard_count):
    ds = _Arrays(23)
    n_valid = 0
    for rank in range(shard_count):
        kw = dict(batch_size=4, shuffle=train, drop_last=train, seed=7, num_workers=2,
                  shard_rank=rank, shard_count=shard_count)
        ours, theirs = tds.Loader(ds, **kw), jds.Loader(ds, **kw)
        assert len(ours) == len(theirs) > 0
        for epoch in (0, 3):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(ours), list(theirs)
            assert len(got) == len(want) == len(ours)
            for g, w in zip(got, want):
                assert g["image"].dtype == np.uint8
                np.testing.assert_array_equal(g["image"], w["image"])
                np.testing.assert_array_equal(g["mask"], w["mask"])
        n_valid += sum(int(b["mask"].sum()) for b in got)
        for b in got:
            assert not b["image"][~b["mask"]].any()   # padded rows are zero
    # eval sees every image once over the shards; train drops the remainders
    assert n_valid == (4 * (23 // shard_count // 4) * shard_count if train else 23)


def test_image_folder_and_get_loaders(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    imgs = _images(6, seed=4)
    for split in ("train", "validation"):
        (tmp_path / split).mkdir()
        for i, img in enumerate(imgs):
            Image.fromarray(np.kron(img, np.ones((2, 2, 1), np.uint8))).save(
                tmp_path / split / f"i{i}.png")
    ours, theirs = tds.ImageFolderDataset(str(tmp_path / "train"), SIZE), \
        jds.ImageFolderDataset(str(tmp_path / "train"), SIZE)
    assert len(ours) == 6
    for i in range(6):
        np.testing.assert_array_equal(ours[i], theirs[i])
    train, val = tds.get_loaders("standard", str(tmp_path), SIZE, 4, 1, 0)
    assert (train.shard_rank, train.shard_count, len(train), len(val)) == (0, 1, 1, 2)
    with pytest.raises(FileNotFoundError):
        tds.get_loaders("standard", str(tmp_path / "nope"), SIZE, 4, 1, 0)

    out = tmp_path / "packed"
    create_packed_dataset.main(["--max_resolution", str(SIZE), "--output_folder", str(out),
                                "--train_folder", str(tmp_path / "train"), "--workers", "2"])
    jpk.write_packed(str(tmp_path / "want.pack"), (theirs[i] for i in range(6)), SIZE)
    assert (out / "train.pack").read_bytes() == (tmp_path / "want.pack").read_bytes()
    (tmp_path / "packed" / "validation.pack").write_bytes((out / "train.pack").read_bytes())
    ptrain, pval = tds.get_loaders("packed", str(out), SIZE, 4, 1, 0, shard_rank=0,
                                   shard_count=1)
    assert isinstance(ptrain.dataset, tpk.PackedDataset) and len(pval) == 2
