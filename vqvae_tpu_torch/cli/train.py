"""Train CLI of the port, flag for flag the JAX package's ``train.py``
(itself flag-compatible with the reference's vqvae/train.py:16-39):

    python -m vqvae_tpu_torch.cli.train --params_file example_confs/ema_vqvae.yaml \
        --dataset_path /data/imagenet/ --save_path /ckpts/ --run_name ema --seed 42

Runs on the card; ``--device cpu`` trains on the CPU instead (the
counterpart of the JAX package's ``VQVAE_TPU_PLATFORM=cpu``), and
``--device cuda`` without a visible card raises. ``VQVAE_TPU_FUSED_DBWD=1``
/ ``VQVAE_TPU_FUSED_SKIP=1``, the JAX package's names, run the
discriminator's first-order backward through the kernels B3 / B4.
``--dataloader packed`` reads ``train.pack`` / ``validation.pack``
(``vqvae_tpu_torch.cli.create_packed_dataset``) and needs no PIL.
``main(argv)`` runs in process and returns (the final TrainState, the
Trainer).

Data parallel, one process per card, launched by torchrun:

    torchrun --nproc_per_node 8 -m vqvae_tpu_torch.cli.train --params_file \
        example_confs/gumbel_vqgan.yaml --dataset_path /data/ --save_path /ckpts/ \
        --run_name gan --seed 42

Each rank joins the group (NCCL on the card, gloo with ``--device cpu``;
``parallel/dist.py``), takes ``cumulative_bs / world`` images per step from
its own shard of the data, and trains on ``cuda:LOCAL_RANK``; the LR is
``scaled_lr()`` of the global batch. ``--num_nodes`` must equal torchrun's
``--nnodes`` (the world size over ``LOCAL_WORLD_SIZE``). Rank 0 logs and
writes the checkpoints.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--params_file', type=str, required=True,
                        help='path to yaml file with model params')
    parser.add_argument('--dataloader', type=str, choices=['standard', 'packed', 'ffcv'],
                        default='standard', help='defines what type of dataloader to use.')
    parser.add_argument('--dataset_path', type=str, required=True,
                        help='path to a dataset folder containing two sub-folders '
                             '(validation / train) or packed files '
                             '(train.pack / validation.pack).')
    parser.add_argument('--save_path', type=str, required=True,
                        help='path for checkpointing the model')
    parser.add_argument('--save_every_n_epochs', type=int, default=1,
                        help='how often to save a new checkpoint')
    parser.add_argument('--run_name', type=str, required=True,
                        help='name of the run, for logging and checkpointing')
    parser.add_argument('--seed', type=int, required=True,
                        help='global random seed for reproducibility')
    parser.add_argument('--loading_path', type=str, default=None,
                        help='if passed, will load and continue training of an '
                             'existing checkpoint')
    parser.add_argument('--logging', help='if passed, wandb logger is used',
                        action='store_true')
    parser.add_argument('--wandb_project', type=str, default='vqvae',
                        help='project name for wandb logger')
    parser.add_argument('--wandb_id', type=str, default=None,
                        help='wandb id of the run. Useful for resuming logging')
    parser.add_argument('--workers', type=int, default=1, help='num of parallel workers')
    parser.add_argument('--num_nodes', type=int, default=1,
                        help='number of hosts; under torchrun it must equal --nnodes')
    parser.add_argument('--precision', type=str, default='bf16', choices=['bf16', 'fp32'],
                        help='compute dtype for the conv stacks (params are always fp32)')
    parser.add_argument('--max_epochs', type=int, default=None,
                        help='override training.max_epochs (debug)')
    parser.add_argument('--device', type=str, default='cuda', choices=['cuda', 'cpu'],
                        help='where to train; cuda needs a visible card')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from vqvae_tpu_torch.parallel import dist

    if args.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(pass --device cpu to train on the CPU)")
    with dist.process_group(args.device):
        return _train(args)


def _train(args):
    import torch

    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.data.dataset import get_loaders
    from vqvae_tpu_torch.parallel import dist
    from vqvae_tpu_torch.train.loop import run_training
    from vqvae_tpu_torch.utils.logging import MetricLogger

    rank, world = dist.world()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if args.num_nodes * local_world != world:
        raise ValueError(f"--num_nodes {args.num_nodes} with {local_world} processes per node "
                         f"does not make the world of {world} ranks (launch with torchrun "
                         "--nnodes)")
    cfg = load_config(args.params_file)
    seed = int(args.seed)
    cumulative_bs = cfg.training.cumulative_bs
    batch_size = dist.local_batch_size(cumulative_bs, world)
    # sqrt LR scaling with the global batch (reference train.py:63)
    learning_rate = cfg.training.scaled_lr()
    train_loader, val_loader = get_loaders(args.dataloader, args.dataset_path, cfg.image_size,
                                           batch_size, int(args.workers), seed, mode='train')
    logger = MetricLogger(args.save_path, args.run_name, use_wandb=bool(args.logging),
                          wandb_project=args.wandb_project, wandb_id=args.wandb_id,
                          resume=args.loading_path is not None)
    device = dist.default_device() if args.device == 'cuda' else torch.device('cpu')
    if rank == 0:
        name = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
        print(f"[INFO] device: {name}, ranks: {world}")
        print(f"[INFO] workers: {args.workers}")
        print(f"[INFO] batch size per rank: {batch_size} "
              f"({cfg.training.grad_accum_steps} micro-batches)")
        print(f"[INFO] cumulative batch size (all ranks): {cumulative_bs}")
        print(f"[INFO] final learning rate: {learning_rate}")
    try:
        return run_training(
            cfg, train_loader, val_loader, seed=seed, learning_rate=learning_rate,
            save_dir=args.save_path, run_name=args.run_name,
            save_every_n_epochs=int(args.save_every_n_epochs), logger=logger,
            resume_path=args.loading_path,
            compute_dtype=torch.bfloat16 if args.precision == 'bf16' else torch.float32,
            max_epochs=args.max_epochs, device=device,
            fused_dbwd=os.environ.get("VQVAE_TPU_FUSED_DBWD", "0") == "1",
            fused_skip=os.environ.get("VQVAE_TPU_FUSED_SKIP", "0") == "1")
    finally:
        logger.finish()


if __name__ == '__main__':
    main()
