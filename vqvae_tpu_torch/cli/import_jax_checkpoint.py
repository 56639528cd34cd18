"""Import a JAX package checkpoint into the port, the second of two steps:

    python tools/export_jax_checkpoint.py --loading_path /ckpts/run/last \
        --output /ckpts/run_last.npz                     # where JAX is installed
    python -m vqvae_tpu_torch.cli.import_jax_checkpoint --npz /ckpts/run_last.npz \
        --params_file conf.yaml --output /ckpts/run_last_torch/

The ``.npz`` (the model's ``params``, ``vq_state`` and ``step`` under flat
``/``-joined keys, written by ``tools/export_jax_checkpoint.py``) becomes a
weights-only port snapshot, ``<output>/state.pt`` with that ``step``, which
``--loading_path`` of the port's eval and token-export CLIs reads; the
config is copied beside it as ``conf.yaml``. The layouts change through
``utils/convert.py`` ``convert_vqvae_variables`` (NHWC / HWIO to NCHW /
OIHW); every array of the file must land in the model, and every tensor of
the model must come from the file. numpy and torch only: no JAX here. The
conversion runs on the CPU and touches no card. ``main(argv)`` runs in
process and returns the snapshot's path.
"""

from __future__ import annotations

import argparse
import os
import shutil


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--npz", required=True, help="file of tools/export_jax_checkpoint.py")
    ap.add_argument("--params_file", required=True, help="matching YAML conf")
    ap.add_argument("--output", required=True, help="snapshot directory")
    return ap.parse_args(argv)


class ReadTree(dict):
    """The nested dicts of ``{"a/b/c": array}``, which record the flat key of
    every array read from them in ``seen``; a key that is not there raises
    KeyError naming its flat key."""

    def __init__(self, flat: dict, seen: set, prefix: str = ""):
        children: dict = {}
        for key, value in flat.items():
            head, _, rest = key.partition("/")
            if rest:
                children.setdefault(head, {})[rest] = value
            else:
                children[head] = value
        super().__init__({k: ReadTree(v, seen, f"{prefix}{k}/") if isinstance(v, dict) else v
                          for k, v in children.items()})
        self.seen, self.prefix = seen, prefix

    def __getitem__(self, key):
        if key not in self:
            raise KeyError(f"no array {self.prefix}{key}")
        value = super().__getitem__(key)
        if not isinstance(value, ReadTree):
            self.seen.add(self.prefix + key)
        return value


def main(argv=None) -> str:
    args = parse_args(argv)

    import numpy as np

    from vqvae_tpu_torch.config import load_config
    from vqvae_tpu_torch.utils.checkpoint import save_eval_checkpoint
    from vqvae_tpu_torch.utils.convert import convert_vqvae_variables
    from vqvae_tpu_torch.utils.torch_import import check_state_dict, vqvae_template

    cfg = load_config(args.params_file)
    with np.load(args.npz) as f:
        flat = {k: f[k] for k in f.files}
    if "step" not in flat:
        raise KeyError(f"{args.npz} has no 'step': not a file of tools/export_jax_checkpoint.py")
    step = int(flat.pop("step"))
    seen: set = set()
    try:
        sd = convert_vqvae_variables(ReadTree(flat, seen), cfg.autoencoder.num_res_blocks,
                                     len(cfg.autoencoder.channel_multipliers))
    except KeyError as exc:
        raise KeyError(f"{args.npz}: {exc.args[0]} for a {cfg.quantizer.type} VQVAE") from None
    unused = sorted(set(flat) - seen)
    if unused:
        raise KeyError(f"{args.npz}: arrays that are no tensor of a {cfg.quantizer.type} "
                       f"VQVAE: {unused}")
    model = vqvae_template(cfg).to_empty(device="cpu")
    model.load_state_dict(check_state_dict(sd, model, f"{cfg.quantizer.type} VQVAE"),
                          strict=True)
    path = save_eval_checkpoint(args.output, model, step=step)
    shutil.copyfile(args.params_file, os.path.join(args.output, "conf.yaml"))
    print(f"[INFO] converted {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params "
          f"({cfg.quantizer.type} quantizer, step {step}) -> {path}")
    return str(path)


if __name__ == "__main__":
    main()
