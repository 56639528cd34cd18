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

Under a process group rank 0 writes (the replicas are identical) between
two barriers, so that no rank reads a ``last/`` that is being replaced. The
ranks' own random streams differ: their generator states are gathered into
the snapshot (``rank_generators``), and every rank restores its own. A
snapshot resumed on another number of ranks gives each rank above 0 a fresh
stream seeded by (step, rank).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Optional

import torch

import torch.distributed as dist

from vqvae_tpu_torch.parallel.dist import barrier, rank_seed, world
from vqvae_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


def _generator_states(state: TrainState) -> list:
    """Every rank's (augmentation, noise) generator states, in rank order
    (a collective under a group)."""
    mine = (state.generator.get_state(),
            None if state.noise_generator is None else state.noise_generator.get_state())
    _, size = world()
    if size == 1:
        return [mine]
    out = [None] * size
    dist.all_gather_object(out, mine)
    return out


def _snapshot(state: TrainState, epoch: int, rank_states: list) -> dict:
    """The payload of a checkpoint: tensors, numbers and lists and dicts of
    them only (``torch.load(weights_only=True)`` reads it back)."""
    payload = {"epoch": int(epoch), "step": int(state.step), "disc_step": int(state.disc_step),
               "model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "usage_count": state.usage_count, "generator": state.generator.get_state()}
    if state.noise_generator is not None:
        payload["noise_generator"] = state.noise_generator.get_state()
    if len(rank_states) > 1:
        payload["rank_generators"] = [g for g, _ in rank_states]
        if state.noise_generator is not None:
            payload["rank_noise_generators"] = [n for _, n in rank_states]
    if state.disc is not None:
        payload["disc"] = state.disc.state_dict()
        payload["disc_optimizer"] = state.disc_optimizer.state_dict()
    return payload


def _save_to(path: Path, payload: Optional[dict], source: Optional[Path]) -> Path:
    """Write ``payload`` (or link ``source``, a written ``state.pt``) as
    ``path/state.pt``: into a temporary directory, then renamed into place,
    so a reader never sees a half-written snapshot."""
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


class CheckpointManager:
    def __init__(self, save_dir: str, run_name: str, save_every_n_epochs: int = 1):
        self.dir = Path(save_dir) / run_name
        if world()[0] == 0:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.every = max(1, int(save_every_n_epochs))

    def save(self, state: TrainState, epoch: int) -> None:
        """``epoch_<EEEE>/`` every ``save_every_n_epochs`` epochs, and ``last/``
        (a hard link to the same file where both are written); rank 0 writes,
        between barriers."""
        rank_states = _generator_states(state)
        barrier()
        if world()[0] == 0:
            targets = [self.dir / "last"]
            if epoch % self.every == 0:
                targets.insert(0, self.dir / f"epoch_{epoch:04d}")
            written = None
            for path in targets:
                payload = _snapshot(state, epoch, rank_states) if written is None else None
                written = _save_to(path, payload, written)
        barrier()

    def restore(self, path: str, template_state: TrainState):
        """Load a snapshot into ``template_state`` (a fresh ``init_state()``
        of the same config), onto its device, with this rank's generator
        states. -> (state, epoch)."""
        payload = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
        state = template_state
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        state.disc_step = int(payload["disc_step"])
        state.usage_count.copy_(payload["usage_count"])
        rank, size = world()
        own = len(payload.get("rank_generators", [None])) == size
        if rank == 0 or own:
            state.generator.set_state(payload["rank_generators"][rank] if rank else
                                      payload["generator"])
            if state.noise_generator is not None:
                state.noise_generator.set_state(payload["rank_noise_generators"][rank] if rank
                                                else payload["noise_generator"])
        else:
            seed = rank_seed(state.step, rank)
            state.generator.manual_seed(seed)
            if state.noise_generator is not None:
                state.noise_generator.manual_seed(seed)
        if state.disc is not None:
            state.disc.load_state_dict(payload["disc"], strict=True)
            state.disc_optimizer.load_state_dict(payload["disc_optimizer"])
        return state, int(payload["epoch"])


def restore_for_eval(path: str, template_state: TrainState) -> TrainState:
    """Load only the model's weights (its buffers, the EMA accumulators among
    them) and ``step`` from any snapshot into ``template_state``, onto its
    device (counterpart of ``vqvae_tpu/utils/checkpoint.py:94-122``; the
    reference's ``load_from_checkpoint(strict=False, load_loss=False)``,
    evaluate.py:48-49). The optimizers, the generators, the usage counts and
    the discriminator of the snapshot are ignored, so a GAN run's snapshot
    loads into a ``loss=None`` eval Trainer. ``step`` matters: the gumbel
    eval step seeds its noise and reads its temperature from it."""
    payload = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
    template_state.model.load_state_dict(payload["model"], strict=True)
    template_state.step = int(payload["step"])
    return template_state


def save_eval_checkpoint(path: str, model: torch.nn.Module, step: int = 0,
                         epoch: int = 0) -> Path:
    """Write a weights-only snapshot of ``model`` (its parameters and
    buffers, the EMA accumulators among them) with ``step`` and ``epoch`` to
    ``path/state.pt``, which ``restore_for_eval`` reads (counterpart of
    ``vqvae_tpu/utils/checkpoint.py:126``; the import CLIs write it). Written
    under a temporary name and renamed into place, replacing a snapshot
    there. -> the file."""
    payload = {"epoch": int(epoch), "step": int(step),
               "model": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    return _save_to(Path(path), payload, None)


def latest_checkpoint(save_dir: str, run_name: str) -> Optional[str]:
    last = Path(save_dir) / run_name / "last"
    return str(last) if last.exists() else None
