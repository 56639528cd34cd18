"""Export a JAX package snapshot (orbax) to one ``.npz``, the first of the
two steps that bring a JAX checkpoint into the PyTorch port.

    python tools/export_jax_checkpoint.py --loading_path /ckpts/run/last \
        --output /ckpts/run_last.npz
    python -m vqvae_tpu_torch.cli.import_jax_checkpoint --npz /ckpts/run_last.npz \
        --params_file conf.yaml --output /ckpts/run_last_torch/

This step runs where JAX and orbax are installed and imports no torch; the
second runs where the port is installed and imports no JAX. Any snapshot
reads: a training snapshot (``epoch_NNNN/``, ``last/``) as well as an eval
one (``save_eval_checkpoint``), under any device topology, the way
``vqvae_tpu/utils/checkpoint.py`` ``restore_for_eval`` reads it (every leaf
restored as a host numpy array). The ``.npz`` holds the model's ``params``,
its ``vq_state`` (the EMA quantizer's codebook and accumulators) where it
has one, and ``step``, under flat keys of the tree's path joined by ``/``
(``params/encoder/conv_in/Conv_0/kernel``, ``vq_state/quantizer/codebook``,
``step``); the optimizer, the discriminator and the generators are left out.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path


def flatten(tree, prefix: str = "") -> dict:
    """Nested dicts of arrays -> {"a/b/c": array}."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten(value, name))
        else:
            out[name] = value
    return out


def read_snapshot(path: str) -> dict:
    """The saved ``params``, ``vq_state`` (or None) and ``step`` of any
    snapshot, as host numpy arrays."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    meta = ckptr.metadata(str(Path(path)))
    # orbax metadata layout varies by version: StepMetadata(item_metadata=
    # TreeMetadata(tree=...)) on current, bare tree on older
    for attr in ("item_metadata", "tree"):
        if hasattr(meta, attr):
            meta = getattr(meta, attr)
    restore_args = jax.tree.map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray), meta)
    saved = ckptr.restore(str(Path(path)), restore_args=restore_args)["state"]
    vq_state = saved.get("vq_state")
    return {"params": saved["params"], "vq_state": vq_state or None,
            "step": np.asarray(saved["step"], np.int64)}


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--loading_path", required=True, help="orbax snapshot directory")
    ap.add_argument("--output", required=True, help=".npz file to write")
    args = ap.parse_args(argv)

    import numpy as np

    snap = read_snapshot(args.loading_path)
    arrays = flatten({"params": snap["params"]})
    if snap["vq_state"] is not None:
        arrays.update(flatten({"vq_state": snap["vq_state"]}))
    arrays["step"] = snap["step"]
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "wb") as f:
        np.savez(f, **arrays)
    n = sum(v.size for k, v in arrays.items() if k.startswith("params/"))
    print(f"[INFO] exported {len(arrays) - 1} arrays ({n / 1e6:.1f}M params, step "
          f"{int(snap['step'])}) to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
