"""Evaluation CLI of the port, flag for flag the JAX package's ``evaluate.py``
(itself flag-compatible with the reference's vqvae/evaluate.py:8-24):

    python -m vqvae_tpu_torch.cli.evaluate --params_file conf.yaml \
        --dataset_path /data/ --batch_size 64 --seed 42 --loading_path /ckpts/run/last

It computes the reference's test suite (model.py:491-562) on the ``test/``
split: L2 (mse), PSNR, SSIM, rFID, codebook usage (%) and perplexity. rFID
reads the converted FID-inception weights from
``$VQVAE_TPU_INCEPTION_WEIGHTS`` or ``~/.cache/vqvae_tpu/inception_fid.npz``
(the JAX package's file); without them the CLI exits with an error naming
the converter, before any card or dataset work, unless
``--allow_missing_rfid`` is given. ``--loading_path`` is a snapshot
directory of the port's train CLI (``<run>/last``, ``<run>/epoch_NNNN``).

Runs on the card (``--device cpu`` on the CPU), in fp32 with TF32 off for
matmuls and convolutions (the JAX CLI's ``set_matmul_precision("highest")``).
Launched by torchrun (``torchrun --nproc_per_node N -m
vqvae_tpu_torch.cli.evaluate ...``) each rank evaluates its own shard of the
test set on ``cuda:LOCAL_RANK`` at ``--batch_size / world`` images per
batch (the last batch of a shard padded with
masked rows) and the sums are reduced over the ranks before ``compute()``
(the JAX CLI's ``evaluate.py:48-101``); every rank returns the results,
rank 0 prints them. ``--single_device`` is kept for the flags' sake.
``main(argv)`` runs in process and returns the results.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--params_file', type=str, required=True,
                        help='path to yaml file with model params')
    parser.add_argument('--dataloader', type=str, choices=['standard', 'packed', 'ffcv'],
                        default='standard')
    parser.add_argument('--dataset_path', type=str, required=True,
                        help='path to a dataset folder with a test/ subfolder or test.pack file')
    parser.add_argument('--batch_size', type=int, required=True,
                        help='evaluation batch size (all ranks together)')
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--loading_path', type=str, required=True,
                        help='path to checkpoint to load')
    parser.add_argument('--workers', type=int, default=1)
    parser.add_argument('--single_device', action='store_true',
                        help='kept for CLI parity: one process evaluates on one device')
    parser.add_argument('--allow_missing_rfid', action='store_true',
                        help='proceed without rFID when the FID-inception weights are not '
                             'converted; WITHOUT this flag a missing weights file is a hard '
                             'error (rFID is the reference test suite\'s headline metric, '
                             'model.py:497,536-541)')
    parser.add_argument('--device', type=str, default='cuda', choices=['cuda', 'cpu'],
                        help='where to evaluate; cuda needs a visible card')
    return parser.parse_args(argv)


def to_uint8(x):
    """[0,1] float images -> uint8 as torchvision's ConvertImageDtype(uint8)
    (reference model.py:536-538): times 256 - 1e-3, clipped, truncated; equal
    bins, not ``round(x * 255)``."""
    import torch
    return (x * (256.0 - 1e-3)).clamp(0, 255).to(torch.uint8)


def evaluate_checkpoint(cfg, state, trainer, test_loader, *, verbose=True) -> dict:
    """Run the test metric suite over ``test_loader`` (dicts of NHWC uint8 or
    [0,1] float ``image`` and (B,) bool ``mask``) with ``trainer.eval_step``;
    -> {mse, psnr, ssim, used_codebook, perplexity[, rfid]}. The metric sums
    stay on the device; the FID features go to the host. Under a process
    group each rank streams its shard and the sums are reduced over the
    ranks before ``compute()`` (the usage counts already are, by the eval
    step)."""
    import numpy as np
    import torch

    from vqvae_tpu_torch.eval.fid import FID, load_inception_extractor
    from vqvae_tpu_torch.eval.metrics import ReconMetrics
    from vqvae_tpu_torch.models.quantizers import get_codebook_usage
    from vqvae_tpu_torch.parallel.dist import world

    recon_metrics = ReconMetrics(data_range=1.0)
    extractor, feat_dim = load_inception_extractor(trainer.device)
    fid = FID(extractor, feat_dim) if extractor is not None else None

    usage = None
    for batch in test_loader:
        _, batch_usage, recons = trainer.eval_step(state, batch, epoch=0)
        images = torch.as_tensor(batch["image"]).to(recons.device)
        images = images.float() / 255.0 if images.dtype == torch.uint8 else images.float()
        mask = np.asarray(batch["mask"], bool)

        recon_metrics.update(recons, images, mask)
        # the eval step's usage already leaves out the masked rows
        usage = batch_usage if usage is None else usage + batch_usage
        if fid is not None:
            fid.update(to_uint8(recons), real=False, mask=mask)
            fid.update(to_uint8(images), real=True, mask=mask)

    recon_metrics.reduce_across_hosts()
    if fid is not None:
        fid.reduce_across_hosts()
    results = recon_metrics.compute()
    _, perplexity, cb_usage = get_codebook_usage(usage)
    results["used_codebook"] = float(cb_usage)
    results["perplexity"] = float(perplexity)
    if fid is not None:
        results["rfid"] = fid.compute()
    if verbose and world()[0] == 0:
        for k, v in results.items():
            print(f"{k}: {v:.6f}")
    return results


def main(argv=None):
    args = parse_args(argv)

    # fail fast when the headline metric cannot be computed: before any card
    # or dataset work, so a quality run never reports without rFID
    if not args.allow_missing_rfid:
        from vqvae_tpu_torch.eval.fid import inception_weights_path
        path = inception_weights_path()
        if not path.exists():
            sys.exit(
                f"ERROR: FID-inception weights not found at {path} — rFID (the reference's "
                "headline quality metric) cannot be computed.\nConvert them on a connected "
                f"machine with:\n    python tools/convert_inception_weights.py --out {path}\n"
                "(or tools/fetch_and_convert_all.sh for the full set), copy the file here, or "
                "re-run with --allow_missing_rfid to evaluate without rFID.")
    import torch

    from vqvae_tpu_torch.parallel import dist

    if args.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(pass --device cpu to evaluate on the CPU)")
    with dist.process_group(args.device):
        return _evaluate(args)


def _evaluate(args):
    import torch

    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.data.dataset import get_loaders
    from vqvae_tpu_torch.parallel import dist
    from vqvae_tpu_torch.train.loop import Trainer
    from vqvae_tpu_torch.utils.checkpoint import restore_for_eval
    from vqvae_tpu_torch.utils.precision import set_full_fp32

    set_full_fp32()
    device = dist.default_device() if args.device == 'cuda' else torch.device('cpu')
    rank, world = dist.world()
    cfg = load_config(args.params_file)
    seed = int(args.seed)
    # --batch_size is the global batch, as in the JAX CLI
    batch_size = dist.local_batch_size(int(args.batch_size), world)
    test_loader = get_loaders(args.dataloader, args.dataset_path, cfg.image_size,
                              batch_size, int(args.workers), seed, mode='test')
    # inference needs no loss stack (reference evaluate.py:48-49: l_conf=None)
    eval_cfg = dataclasses.replace(cfg, loss=None)
    trainer = Trainer(cfg=eval_cfg, learning_rate=cfg.training.base_lr, seed=seed,
                      steps_per_epoch=1, compute_dtype=torch.float32, device=device)
    state = restore_for_eval(args.loading_path, trainer.init_state())

    name = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
    if rank == 0:
        print(f"[INFO] device: {name}, ranks: {world}, batch size per rank: {batch_size}")
    return evaluate_checkpoint(eval_cfg, state, trainer, test_loader)


if __name__ == '__main__':
    main()
