"""Metric logging (counterpart of ``vqvae_tpu/utils/logging.py``): one JSON
line per ``log`` call in ``<log_dir>/<run_name>/metrics.jsonl`` always, and
wandb where asked for and importable (imported only then). Replaces the
reference's WandbLogger wiring (train.py:81-85; per-component scalars,
model.py:277-286; reconstruction panels, model.py:442-456): a panel is a PNG
(PIL, imported only to write it) or, without PIL, a ``.npy`` of the array.
Under a process group only rank 0 writes, unless told otherwise.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from vqvae_tpu_torch.parallel.dist import world


class MetricLogger:
    def __init__(self, log_dir: str, run_name: str, use_wandb: bool = False,
                 wandb_project: str = "vqvae", wandb_id: Optional[str] = None,
                 resume: bool = False, is_main_process: Optional[bool] = None):
        self.dir = Path(log_dir) / run_name
        self.is_main = world()[0] == 0 if is_main_process is None else is_main_process
        self._wandb = None
        if not self.is_main:
            return
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a")
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(
                    project=wandb_project, name=run_name, id=wandb_id,
                    resume="must" if (resume and wandb_id) else None)
            except Exception as e:  # offline image: keep training
                print(f"[WARN] wandb unavailable ({e}); logging to files only")

    def log(self, metrics: Dict[str, float], step: int, prefix: str = ""):
        if not self.is_main:
            return
        record = {f"{prefix}{k}": float(v) for k, v in metrics.items()}
        record["step"] = int(step)
        record["time"] = time.time()
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(record, step=int(step))

    def log_images(self, images: np.ndarray, step: int, key: str):
        """Save a reconstruction grid (originals row / recons row) as a
        viewable PNG, mirroring log_reconstructions (reference
        model.py:442-456 logs wandb image grids; offline runs get the same
        artifact as a file, not a raw array dump)."""
        if not self.is_main:
            return
        grid = None
        path = self.dir / f"{key.replace('/', '_')}_{step}.png"
        try:
            from PIL import Image
            grid = _to_grid(images)
            arr = np.clip(np.asarray(grid, np.float32), 0.0, 1.0)
            Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8)).save(path)
        except Exception as e:  # PIL missing/odd shapes: keep the raw array
            np.save(path.with_suffix(".npy"), images)
            print(f"[WARN] PNG panel failed ({e}); wrote .npy instead")
        if self._wandb is not None:
            import wandb
            self._wandb.log(
                {key: wandb.Image(grid if grid is not None else images)},
                step=int(step))

    def finish(self):
        if not self.is_main:
            return
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()


def _to_grid(images: np.ndarray) -> np.ndarray:
    """(2, B, H, W, C) in [0,1] -> single HWC grid: top row originals,
    bottom row reconstructions."""
    rows = [np.concatenate(list(r), axis=1) for r in images]
    return np.concatenate(rows, axis=0)


def make_recon_panel(originals: np.ndarray, recons: np.ndarray,
                     max_images: int = 8) -> np.ndarray:
    b = min(originals.shape[0], max_images)
    return np.stack([originals[:b], recons[:b]])
