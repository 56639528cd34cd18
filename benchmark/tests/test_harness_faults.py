"""Whole runs of every cell on the CPU at the tiny size, past the harness's
look for a card, in float32 (where a sound run agrees with the reference
to rounding), judged by the cells' own limits: the sound run comes out
correct, and a run with the timed path broken underneath comes out not
correct, once for each fault the cell can have: a training step that
returns its state unchanged, half of the batch left out with the mean
taken over the rest (every training cell), a token or an image altered
where it is produced. (One card: no exchange between cards to leave
out.) The sound run covers every cell of ``BENCHMARK.json``."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.run import HERE
from benchmark.tests import tiny

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAIN = [name for name in CELLS if run.load_cell(HERE.parent, HERE, name)[3]["kind"] == "train"]


def run_cell(root: Path, here: Path, capsys, cell: str) -> dict:
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 5), "--seconds", "0.5"],
                  root=root, here=here, allow_cpu=True)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def result(tmp_path, capsys, cell: str) -> dict:
    return run_cell(*tiny.make(tmp_path, fp32=True), capsys, cell)


def check_sound_run(root: Path, here: Path, capsys, cell: str) -> None:
    out = run_cell(root, here, capsys, cell)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, capsys, cell):
    check_sound_run(*tiny.make(tmp_path, fp32=True), capsys, cell)


def unchanged_state(monkeypatch):
    """Each step computes its metrics, then puts every leaf back."""
    from vqvae_tpu_torch.train import steps
    real = steps.train_step

    def broken(state, *args, **kwargs):
        modules = [m for m in (state.model, state.disc) if m is not None]
        saved = [{k: v.detach().clone() for k, v in m.state_dict().items()} for m in modules]
        metrics = real(state, *args, **kwargs)
        for m, sd in zip(modules, saved):
            m.load_state_dict(sd)
        return metrics
    monkeypatch.setattr(steps, "train_step", broken)


def half_batch(monkeypatch):
    """Each step sees the first half of its batch only."""
    from vqvae_tpu_torch.train import steps
    real = steps.train_step
    monkeypatch.setattr(steps, "train_step",
                        lambda state, images, *a, **k: real(state, images[: len(images) // 2],
                                                            *a, **k))


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [unchanged_state, half_batch], ids=lambda f: f.__name__)
def test_training_fault_is_caught(tmp_path, capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    assert result(tmp_path, capsys, cell)["correct"] is False


def test_altered_token_is_caught(tmp_path, capsys, monkeypatch):
    from vqvae_tpu_torch.models.vqvae import VQVAE
    real = VQVAE.get_tokens

    def broken(self, *args, **kwargs):
        tokens = real(self, *args, **kwargs).clone()
        tokens[0, 0] = (tokens[0, 0] + 1) % self.quantizer.num_embeddings
        return tokens
    monkeypatch.setattr(VQVAE, "get_tokens", broken)
    assert result(tmp_path, capsys, "ema_vqvae.tokenize")["correct"] is False


def test_altered_image_is_caught(tmp_path, capsys, monkeypatch):
    from vqvae_tpu_torch.models.vqvae import VQVAE
    real = VQVAE.reconstruct_from_tokens

    def broken(self, tokens):
        images = real(self, tokens).clone()
        images[0, 0, 0] = (images[0, 0, 0] + 0.5) % 1.0   # half the range away
        return images
    monkeypatch.setattr(VQVAE, "reconstruct_from_tokens", broken)
    assert result(tmp_path, capsys, "gumbel_vqgan.detokenize")["correct"] is False
