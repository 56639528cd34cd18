"""One command from the released reference checkpoints to the published
table, through the port (counterpart of ``tools/quality_parity.sh``):

    python -m vqvae_tpu_torch.cli.quality_parity --dataset /path/to/imagenet \
        [--checkpoints DIR] [--cache DIR] [--runs gumbel,entropy] [--batch 64] \
        [--seed 42] [--dataloader standard|packed] [--device cuda|cpu] [--dry-run FIXDIR]

For each reference checkpoint ``<run>.ckpt`` under ``--checkpoints`` (default
``<cache>/hf_checkpoints``), at its top level or one directory down, with
``<run>.yaml`` or ``conf.yaml`` beside it, whose name holds one of ``--runs``
(the kind it is checked as; a checkpoint one directory down is named
``<dir>_<run>``):

1. import it with ``cli.import_torch_checkpoint`` into
   ``<cache>/imported_torch/<run>/`` (not ``imported/``, where the JAX chain
   keeps its orbax snapshots);
2. evaluate it with ``cli.evaluate`` on the dataset's ``test/`` split
   (``test.pack`` under ``--dataloader packed``), its output also written to
   ``<cache>/quality_parity_torch/eval_<run>.txt``;
3. check the metric lines of that file against the reference's published
   row (``eval/quality_parity.py``: rFID, codebook usage, perplexity, L2,
   SSIM, PSNR).

The two CLIs run in this process, with ``VQVAE_TPU_LPIPS_WEIGHTS_DIR`` and
``VQVAE_TPU_INCEPTION_WEIGHTS`` pointed at the cache for their calls only.
Exit 0 when every run reproduces its row, 1 when a metric is out of
tolerance, 2 when no checkpoint is found, a YAML, the dataset's splits or
the FID-inception weights are missing.

This command downloads and converts nothing. On a connected machine
``tools/fetch_and_convert_all.sh --hf --cache DIR`` downloads the released
checkpoints into ``DIR/hf_checkpoints`` and converts the LPIPS and
FID-inception weights into ``DIR``; bring ``DIR`` here and pass it as
``--cache``.

``--dry-run FIXDIR`` runs the same chain offline on fixtures: the
checkpoints are those under FIXDIR (the ``model.ckpt`` + ``conf.yaml``
layout of ``fetch_and_convert_all.sh --dry-run`` included), its
``inception_fid.npz``, if any, is copied into the cache, and without
``--dataset`` the data is the JAX chain's synthetic set (8 validation and 8
test 16^2 PNGs, seed 0) under ``<cache>/quality_parity_torch/dryrun_data``.
Every run is evaluated with ``--allow_missing_rfid`` and checked only for
metric lines that parse (mse, psnr, ssim, used_codebook, perplexity); the
published values are not asserted. ``main(argv)`` returns the exit code.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys
from pathlib import Path

DRY_RUN_KEYS = {"mse", "psnr", "ssim", "used_codebook", "perplexity"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Weights and checkpoints come from tools/fetch_and_convert_all.sh --hf "
               "on a connected machine; this command downloads nothing.")
    ap.add_argument("--dataset", default=None,
                    help="folder with validation/ and test/ (or test.pack with "
                         "--dataloader packed); required unless --dry-run")
    ap.add_argument("--checkpoints", default=None,
                    help="released checkpoints (default <cache>/hf_checkpoints)")
    ap.add_argument("--cache", default=str(Path.home() / ".cache" / "vqvae_tpu"),
                    help="artifact cache: converted weights, imports, logs")
    ap.add_argument("--runs", default="gumbel,entropy",
                    help="comma list matched against the checkpoints' run names")
    ap.add_argument("--batch", type=int, default=64, help="eval batch")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dataloader", default="standard", choices=["standard", "packed"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to evaluate; cuda needs a visible card")
    ap.add_argument("--dry-run", dest="dry_run", default=None, metavar="FIXDIR",
                    help="offline self-test on the fixtures in FIXDIR; no asserts")
    return ap.parse_args(argv)


def find_runs(root: Path) -> list:
    """-> sorted [(run name, .ckpt, its YAML or None)] for every ``*.ckpt`` at
    the top of ``root`` or one directory down."""
    found = []
    for ckpt in sorted(list(root.glob("*.ckpt")) + list(root.glob("*/*.ckpt"))):
        name = "_".join(ckpt.relative_to(root).with_suffix("").parts)
        conf = next((c for c in (ckpt.with_suffix(".yaml"), ckpt.parent / "conf.yaml")
                     if c.is_file()), None)
        found.append((name, ckpt, conf))
    return found


def run_kind(name: str, wanted: list):
    """The last of ``wanted`` that ``name`` holds (the JAX chain's rule), or None."""
    kind = None
    for w in wanted:
        if w in name:
            kind = w
    return kind


def dataset_error(path, loader: str):
    """What the dataset lacks for the eval CLI, or None."""
    if path is None:
        return "--dataset is required"
    root = Path(path)
    if loader == "packed":
        return None if (root / "test.pack").is_file() else f"{root} must contain test.pack"
    if (root / "validation").is_dir() and (root / "test").is_dir():
        return None
    return f"{root} must contain validation/ and test/ subfolders (data/dataset.py layout)"


def synthetic_dataset(root: Path) -> Path:
    """The JAX chain's dry-run data: 8 validation and 8 test 16^2 PNGs, each
    split drawn from ``RandomState(0)``."""
    import numpy as np
    from PIL import Image
    for split, n in (("validation", 8), ("test", 8)):
        d = root / split
        d.mkdir(parents=True, exist_ok=True)
        rs = np.random.RandomState(0)
        for i in range(n):
            Image.fromarray(rs.randint(0, 255, (16, 16, 3), np.uint8)).save(d / f"i{i}.png")
    return root


@contextlib.contextmanager
def weights_from(cache: Path):
    """The LPIPS and FID-inception loaders read the cache while entered; the
    environment is restored on exit."""
    names = {"VQVAE_TPU_LPIPS_WEIGHTS_DIR": str(cache),
             "VQVAE_TPU_INCEPTION_WEIGHTS": str(cache / "inception_fid.npz")}
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(names)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Tee:
    """A stream that writes to two."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def main(argv=None) -> int:
    args = parse_args(argv)
    from vqvae_tpu_torch.cli import evaluate as cli_evaluate
    from vqvae_tpu_torch.cli import import_torch_checkpoint as cli_import
    from vqvae_tpu_torch.eval.quality_parity import check, parse_metrics, report

    cache = Path(args.cache)
    outdir = cache / "quality_parity_torch"
    dry = args.dry_run is not None
    loader = args.dataloader
    if dry:
        ckpt_root = Path(args.dry_run)
    else:
        ckpt_root = Path(args.checkpoints) if args.checkpoints else cache / "hf_checkpoints"
    # fail fast, before any import or evaluation
    if not (dry and args.dataset is None):
        error = dataset_error(args.dataset, loader)
        if error:
            print(f"ERROR: {error}", file=sys.stderr)
            return 2
    wanted = args.runs.split(",")
    runs = []
    for name, ckpt, conf in find_runs(ckpt_root):
        kind = "gumbel" if dry else run_kind(name, wanted)
        if kind is None:
            print(f"   (skipping {name} — not in --runs {args.runs})")
            continue
        if conf is None:
            print(f"ERROR: no {ckpt.stem}.yaml or conf.yaml next to {ckpt}", file=sys.stderr)
            return 2
        runs.append((name, ckpt, conf, kind))
    if not runs:
        print(f"ERROR: no reference checkpoint under {ckpt_root} (did "
              "tools/fetch_and_convert_all.sh --hf succeed?)", file=sys.stderr)
        return 2
    outdir.mkdir(parents=True, exist_ok=True)
    if dry:
        fixture = ckpt_root / "inception_fid.npz"
        if fixture.is_file():
            shutil.copyfile(fixture, cache / "inception_fid.npz")
    elif not (cache / "inception_fid.npz").is_file():
        print(f"ERROR: no FID-inception weights at {cache / 'inception_fid.npz'} (convert "
              "them with tools/fetch_and_convert_all.sh)", file=sys.stderr)
        return 2
    dataset = args.dataset
    if dataset is None:   # a dry run without data: the JAX chain's synthetic set
        dataset, loader = str(synthetic_dataset(outdir / "dryrun_data")), "standard"

    failed = False
    for name, ckpt, conf, kind in runs:
        imported = cache / "imported_torch" / name
        log = outdir / f"eval_{name}.txt"
        print(f"-- {name}: import {ckpt} (conf {conf}) -> {imported}; evaluate -> {log}",
              flush=True)
        with weights_from(cache):
            cli_import.main(["--ckpt", str(ckpt), "--params_file", str(conf),
                             "--output", str(imported)])
            with open(log, "w") as f, contextlib.redirect_stdout(_Tee(sys.stdout, f)):
                cli_evaluate.main(["--params_file", str(imported / "conf.yaml"),
                                   "--dataset_path", str(dataset), "--dataloader", loader,
                                   "--batch_size", str(args.batch), "--seed", str(args.seed),
                                   "--loading_path", str(imported), "--device", args.device]
                                  + (["--allow_missing_rfid"] if dry else []))
        metrics = parse_metrics(log.read_text())
        if dry:   # the chain ran; the values of random fixtures mean nothing
            missing = DRY_RUN_KEYS - set(metrics)
            if missing:
                print(f"dry-run: {name}: no metric line for {sorted(missing)} in {log}",
                      file=sys.stderr)
                failed = True
            else:
                print(f"dry-run: metric lines parse -> {metrics}")
            continue
        print(f"== assert {name} vs published {kind} row (readme.md:148-156)")
        failures = check(kind, metrics)
        report(kind, failures)
        failed |= bool(failures)
    if failed:
        print(f"QUALITY PARITY: AT LEAST ONE RUN FAILED (logs in {outdir})", file=sys.stderr)
        return 1
    print("QUALITY PARITY: " + ("dry run: every chain ran and its metric lines parse."
                                if dry else "all runs reproduce readme.md:148-156 within "
                                            "tolerance."))
    return 0


if __name__ == "__main__":
    sys.exit(main())
