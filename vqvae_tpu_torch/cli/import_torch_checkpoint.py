"""Import a reference PyTorch-Lightning checkpoint into the port (the port's
``tools/import_torch_checkpoint.py``, flag for flag):

    python -m vqvae_tpu_torch.cli.import_torch_checkpoint \
        --ckpt /path/to/model.ckpt \
        --params_file example_confs/standard_vqvae.yaml \
        --output /ckpts/imported/

Reads the ``.ckpt`` (or a bare state_dict ``.pt``) written by the
reference's train.py, drops the loss stack's weights (``criterion.*``, as
the reference's ``load_from_checkpoint(load_loss=False)``), checks every
key and shape against the port's VQVAE for the config
(``utils/torch_import.py``) and writes a weights-only snapshot,
``<output>/state.pt``, that ``--loading_path`` of the port's eval and
token-export CLIs reads; the config is copied beside it as ``conf.yaml``.
A ``.ckpt`` is a pickle: import only files from a source you trust. The
conversion runs on the CPU and touches no card. ``main(argv)`` runs in
process and returns the snapshot's path.
"""

from __future__ import annotations

import argparse
import os
import shutil


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help=".ckpt / .pt state file")
    ap.add_argument("--params_file", required=True, help="matching YAML conf")
    ap.add_argument("--output", required=True, help="snapshot directory")
    return ap.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)

    import torch

    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.utils.checkpoint import save_eval_checkpoint
    from vqvae_tpu_torch.utils.torch_import import convert_vqvae_state_dict, vqvae_template

    cfg = load_config(args.params_file)
    # Lightning's checkpoint holds more than tensors (hyperparameters, loop state)
    blob = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    sd = {k: v for k, v in sd.items() if not k.startswith("criterion.")}
    weights = convert_vqvae_state_dict(sd, cfg)

    model = vqvae_template(cfg).to_empty(device="cpu")
    model.load_state_dict(weights, strict=True)
    n = sum(p.numel() for p in model.parameters())
    print(f"[INFO] converted {n / 1e6:.1f}M params ({cfg.quantizer.type} quantizer)")
    path = save_eval_checkpoint(args.output, model)
    # self-describing import: the matching conf rides inside the snapshot dir
    shutil.copyfile(args.params_file, os.path.join(args.output, "conf.yaml"))
    print(f"[INFO] wrote {path} — evaluate with:\n"
          f"  python -m vqvae_tpu_torch.cli.evaluate --params_file {args.params_file} "
          f"--loading_path {args.output} ...")
    return str(path)


if __name__ == "__main__":
    main()
