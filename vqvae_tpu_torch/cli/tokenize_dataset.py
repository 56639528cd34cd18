"""Export VQ token sequences for a whole dataset, for stage-2 models (the
port's ``tools/tokenize_dataset.py``, flag for flag, plus ``--device``):

    python -m vqvae_tpu_torch.cli.tokenize_dataset --params_file conf.yaml \
        --loading_path /ckpts/run/last --dataset_path /data/ \
        --splits train validation --batch_size 256 --output_folder /tokens/

It runs the tokenizer API (``VQVAE.get_tokens``; the nearest-code kernel B1
on the card for the standard, EMA and entropy quantizers) over each split
and writes one int32 ``{split}_tokens.npy`` of shape (N, S) per split, the
padded rows of the last batch left out, and a ``manifest.json`` with the
codebook size (the JAX CLI's keys and values). Runs on the card
(``--device cpu`` on the CPU) in fp32 with TF32 off, so that the tokens
agree with the eval path's.

The gumbel quantizer's tokens are the deterministic argmax by default.
``--sampled_tokens`` draws gumbel noise, as the reference's ``vec_to_codes``
does (vector_quantizers.py:265-274), from a ``torch.Generator`` seeded by
``--seed`` anew for each split; that stream cannot equal ``jax.random``'s,
so sampled tokens differ from the JAX CLI's (deterministic ones agree).
``--spatial`` (height-sharded inference over several devices) is
ROADMAP.md queue A, item 11. One process on one card, as the JAX tool: it
starts no process group. ``main(argv)`` runs in process and returns the
manifest.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--params_file", required=True)
    ap.add_argument("--loading_path", required=True)
    ap.add_argument("--dataset_path", required=True)
    ap.add_argument("--output_folder", required=True)
    ap.add_argument("--splits", nargs="+", default=["train", "validation"])
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--dataloader", default="standard", choices=["standard", "packed", "ffcv"])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampled_tokens", action="store_true",
                    help="gumbel quantizer: sample tokens through gumbel noise like the "
                         "reference vec_to_codes (default: deterministic argmax)")
    ap.add_argument("--spatial", action="store_true",
                    help="shard each image's height across devices (not ported yet)")
    ap.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                    help="where to tokenize; cuda needs a visible card")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.spatial:
        raise NotImplementedError(
            "--spatial (height-sharded inference) is not ported yet "
            "(ROADMAP.md queue A, item 11)")

    import numpy as np
    import torch

    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.data.dataset import ImageFolderDataset, Loader
    from vqvae_tpu_torch.data.packed import PackedDataset
    from vqvae_tpu_torch.train.loop import Trainer
    from vqvae_tpu_torch.utils.checkpoint import restore_for_eval
    from vqvae_tpu_torch.utils.precision import set_full_fp32

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is visible "
                           "(pass --device cpu to tokenize on the CPU)")
    set_full_fp32()
    device = torch.device(args.device)
    cfg = load_config(args.params_file)
    is_gumbel = cfg.quantizer.type == "gumbel"
    # the LR plays no part in tokenizing
    trainer = Trainer(cfg=dataclasses.replace(cfg, loss=None),
                      learning_rate=cfg.training.base_lr, seed=args.seed, steps_per_epoch=1,
                      compute_dtype=torch.float32, device=device)
    model = restore_for_eval(args.loading_path, trainer.init_state()).model

    os.makedirs(args.output_folder, exist_ok=True)
    manifest = {"num_embeddings": cfg.quantizer.num_embeddings,
                "quantizer": cfg.quantizer.type,
                "image_size": cfg.image_size,
                "latent_tokens": cfg.latent_size ** 2,
                "splits": {}}

    for split in args.splits:
        if args.dataloader == "standard":
            ds = ImageFolderDataset(os.path.join(args.dataset_path, split), cfg.image_size)
        else:
            ds = PackedDataset(os.path.join(args.dataset_path, split + ".pack"), cfg.image_size)
        loader = Loader(ds, batch_size=args.batch_size, shuffle=False, drop_last=False,
                        num_workers=args.workers, shard_rank=0, shard_count=1)
        generator = torch.Generator(device=device).manual_seed(args.seed)
        out = []
        for batch in loader:
            images = torch.from_numpy(batch["image"]).to(device).float() / 255.0
            if is_gumbel:
                toks = model.get_tokens(images, deterministic=not args.sampled_tokens,
                                        generator=generator)
            else:
                toks = model.get_tokens(images)
            out.append(toks[torch.from_numpy(np.asarray(batch["mask"], bool)).to(device)])
        tokens = torch.cat(out).cpu().numpy().astype(np.int32)
        path = os.path.join(args.output_folder, f"{split}_tokens.npy")
        np.save(path, tokens)
        manifest["splits"][split] = {"file": os.path.basename(path),
                                     "num_sequences": int(tokens.shape[0]),
                                     "seq_len": int(tokens.shape[1])}
        print(f"[INFO] {split}: {tokens.shape} -> {path}")

    with open(os.path.join(args.output_folder, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"[INFO] manifest -> {args.output_folder}/manifest.json")
    return manifest


if __name__ == "__main__":
    main()
