"""Checkpoints (counterpart of ``vqvae_tpu/utils/checkpoint.py``): one
``torch.save`` file per snapshot, laid out as the JAX package lays out its
orbax snapshots (the reference's ModelCheckpoint: save_last=True,
save_top_k=-1, every_n_epochs=N, train.py:121-122)::

    <save_dir>/<run_name>/epoch_<EEEE>/state.pt   (every N epochs, kept)
    <save_dir>/<run_name>/last/state.pt           (replaced every save)

A snapshot holds everything a bit-exact resume needs: the model's
parameters and buffers (the EMA accumulators among them), both optimizers'
state, ``step``, ``disc_step``, the usage counts, the epoch, and the states
of the augmentation generator and the gumbel noise generator. A snapshot is
written under a temporary name and renamed into place, so a reader never
sees a half-written one.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import torch

from vqvae_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


def _snapshot(state: TrainState, epoch: int) -> dict:
    """The payload of a checkpoint: tensors, numbers and dicts of them only
    (``torch.load(weights_only=True)`` reads it back)."""
    payload = {"epoch": int(epoch), "step": int(state.step), "disc_step": int(state.disc_step),
               "model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "usage_count": state.usage_count, "generator": state.generator.get_state()}
    if state.noise_generator is not None:
        payload["noise_generator"] = state.noise_generator.get_state()
    if state.disc is not None:
        payload["disc"] = state.disc.state_dict()
        payload["disc_optimizer"] = state.disc_optimizer.state_dict()
    return payload


class CheckpointManager:
    def __init__(self, save_dir: str, run_name: str, save_every_n_epochs: int = 1):
        self.dir = Path(save_dir) / run_name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every = max(1, int(save_every_n_epochs))

    def save(self, state: TrainState, epoch: int) -> None:
        """``epoch_<EEEE>/`` every ``save_every_n_epochs`` epochs, and ``last/``
        (a hard link to the same file where both are written)."""
        targets = [self.dir / "last"]
        if epoch % self.every == 0:
            targets.insert(0, self.dir / f"epoch_{epoch:04d}")
        written = None
        for path in targets:
            written = self._save_to(path, _snapshot(state, epoch) if written is None else None,
                                    written)

    def _save_to(self, path: Path, payload: Optional[dict], source: Optional[Path]) -> Path:
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        if source is None:
            torch.save(payload, tmp / STATE_FILE)
        else:
            try:
                os.link(source, tmp / STATE_FILE)
            except OSError:
                shutil.copyfile(source, tmp / STATE_FILE)
        old = None
        if path.exists():
            old = path.with_name(f".{path.name}.{os.getpid()}.old")
            shutil.rmtree(old, ignore_errors=True)
            os.replace(path, old)
        os.replace(tmp, path)
        if old is not None:
            shutil.rmtree(old)
        return path / STATE_FILE

    def restore(self, path: str, template_state: TrainState):
        """Load a snapshot into ``template_state`` (a fresh ``init_state()``
        of the same config), onto its device. -> (state, epoch)."""
        payload = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
        state = template_state
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        state.disc_step = int(payload["disc_step"])
        state.usage_count.copy_(payload["usage_count"])
        state.generator.set_state(payload["generator"])
        if state.noise_generator is not None:
            state.noise_generator.set_state(payload["noise_generator"])
        if state.disc is not None:
            state.disc.load_state_dict(payload["disc"], strict=True)
            state.disc_optimizer.load_state_dict(payload["disc_optimizer"])
        return state, int(payload["epoch"])


def latest_checkpoint(save_dir: str, run_name: str) -> Optional[str]:
    last = Path(save_dir) / run_name / "last"
    return str(last) if last.exists() else None
