"""The port's data-parallel training loop on the CPU: two gloo ranks spawned
with ``torch.multiprocessing`` (a ``file://`` store under ``tmp_path``), on
tiny configs, without JAX (``test_torch_ddp.py`` holds the steps to the JAX
mesh).

- GAN: a gumbel-VQGAN step with R1, then one without, at 4 rows per rank
  with the augmentations on (each rank draws its own augmentations and
  gumbel noise): every metric finite, R1 > 0 on the first step only, and the
  autoencoder's and the D's replicas bitwise equal after each step
  (``check_replication``, and ``torch.equal`` across the ranks' copies).
- Reinit: after an EMA step on 2 x 4 rows, ``maybe_reinit_codes`` leaves the
  same codebook and EMA buffers on both ranks, and replaces the same dead
  rows with the same codes as one process on the 8 rows (rtol 1e-5: the two
  runs' EMA sums differ in rounding only).
- ``cli.train.main`` on 2 ranks (``grad_accum_steps`` 2, reinit every epoch,
  packed data with a ragged validation split): only rank 0 writes
  ``metrics.jsonl`` (one record per line, as one process writes) and the
  checkpoints; 2 epochs straight equal (``torch.equal``) 1 epoch, a resume
  from ``last/`` and 1 more, on each rank: every parameter, buffer,
  optimizer moment, the usage counts, the step counters and each rank's own
  generator states; a one-process snapshot resumes on 2 ranks with rank 0's
  stream kept and a fresh one for rank 1.
- ``cli.evaluate.main`` on 2 ranks (global batch 8, a 13-image ragged test
  split) equals one process: mse, psnr, ssim rtol 1e-5, usage and perplexity
  exact; ``FID.reduce_across_hosts`` over the ranks' shards of a feature set
  equals the FID of the whole set (rtol 1e-9).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import yaml

from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.data.packed import write_packed
from vqvae_tpu_torch.eval.fid import FID
from vqvae_tpu_torch.parallel import dist
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils.introspect import check_replication

torch.set_num_threads(1)

WORLD, IMG, ROWS = 2, 16, 8
SPLITS = {"train": 16, "validation": 10, "test": 13}

GAN_RAW = {
    "image_size": IMG,
    "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
    "quantizer": {"type": "gumbel", "num_embeddings": 32, "embedding_dim": 8,
                  "reinit_every_n_epochs": None,
                  "params": {"straight_through": False, "temp": 1.0, "kl_cost": 0.00859375,
                             "kl_warmup_epochs": 0.48, "temp_decay_epochs": 15,
                             "temp_final": 0.0625}},
    "loss": {"l1_weight": 0.8, "l2_weight": 0.2, "perc_weight": 1.0,
             "adversarial_params": {"start_epoch": 0, "loss_type": "non-saturating",
                                    "g_weight": 0.1, "use_adaptive": False,
                                    "r1_reg_weight": 10.0, "r1_reg_every": 4}},
    "training": {"cumulative_bs": ROWS, "base_lr": 1e-4, "betas": [0.0, 0.99], "eps": 1e-8,
                 "weight_decay": 1e-4, "decay_epochs": 1, "max_epochs": 300},
}


def ema_raw(accum: int = 1) -> dict:
    return {
        "image_size": IMG,
        "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
        "quantizer": {"type": "ema", "num_embeddings": 32, "embedding_dim": 8,
                      "reinit_every_n_epochs": 1,
                      "params": {"commitment_cost": 0.25, "decay": 0.95, "epsilon": 1e-5}},
        "training": {"cumulative_bs": ROWS, "grad_accum_steps": accum, "base_lr": 1e-3,
                     "betas": [0.0, 0.99], "eps": 1e-8, "weight_decay": 1e-4,
                     "decay_epochs": 2, "max_epochs": 2},
    }


def _gan_steps() -> list:
    trainer = Trainer(parse_config(GAN_RAW), learning_rate=1e-4, seed=0, steps_per_epoch=10,
                      device="cpu", disc_kwargs={"channel_base": 256})
    state = trainer.init_state()
    rank, world = dist.world()
    images = np.random.RandomState(5).rand(2, ROWS, IMG, IMG, 3).astype(np.float32)
    per = ROWS // world
    out = []
    for b in images:
        state, m = trainer.train_step(state, {"image": b[rank * per:(rank + 1) * per]}, epoch=0)
        check_replication({"model": state.model, "disc": state.disc,
                           "usage_count": state.usage_count})
        out.append({k: float(v) for k, v in m.items()})
    snapshot = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    snapshot.update({f"disc.{k}": v.clone() for k, v in state.disc.state_dict().items()})
    return out, snapshot


def _reinit(rows: slice) -> dict:
    trainer = Trainer(parse_config(ema_raw()), learning_rate=1e-3, seed=0, steps_per_epoch=10,
                      augment=False, device="cpu")
    state = trainer.init_state()
    # dark, near-constant images: few codes take all the rows
    images = 0.1 * np.random.RandomState(6).rand(ROWS, IMG, IMG, 3).astype(np.float32)
    state, _ = trainer.train_step(state, {"image": images[rows]}, epoch=0)
    q = state.model.quantizer
    before = q.codebook.weight.clone()
    usage = state.usage_count.clone()
    state = trainer.maybe_reinit_codes(state, epoch=1)
    check_replication({"model": state.model})
    return {"usage": usage, "before": before,
            **{k: v.clone() for k, v in q.state_dict().items()}}


def _train_cli(params: str, data: str, save: Path, run: str, *extra):
    from vqvae_tpu_torch.cli import train as cli_train
    state, _ = cli_train.main(["--params_file", params, "--dataloader", "packed",
                               "--dataset_path", data, "--save_path", str(save), "--run_name",
                               run, "--seed", "0", "--device", "cpu", "--precision", "fp32",
                               "--workers", "1", *extra])
    return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
            "usage": state.usage_count.clone(), "step": state.step,
            "generator": state.generator.get_state()}


def _evaluate_cli(params: str, data: str, ckpt: Path):
    from vqvae_tpu_torch.cli import evaluate as cli_evaluate
    return cli_evaluate.main(["--params_file", params, "--dataloader", "packed",
                              "--dataset_path", data, "--batch_size", str(ROWS), "--seed", "0",
                              "--loading_path", str(ckpt), "--workers", "1",
                              "--allow_missing_rfid", "--device", "cpu"])


def _restored_stream(tmp: Path):
    """This rank's augmentation generator state after restoring the
    one-process snapshot ``one/last``, and the snapshot's step."""
    from vqvae_tpu_torch.utils.checkpoint import CheckpointManager
    trainer = Trainer(parse_config(ema_raw(accum=2)), learning_rate=1e-3, seed=0,
                      steps_per_epoch=2, device="cpu")
    state, _ = CheckpointManager(str(tmp / "ckpt"), "one").restore(
        str(tmp / "ckpt" / "one" / "last"), trainer.init_state())
    trainer.native_lr.destroy()
    return state.generator.get_state(), state.step


def _features() -> np.ndarray:
    return np.random.RandomState(7).randn(2, 13, 6)


def _fid(rows) -> float:
    real, fake = _features()
    fid = FID(lambda x: x, 6)
    fid.update(real[rows], real=True)
    fid.update(fake[rows], real=False)
    fid.reduce_across_hosts()
    return fid.compute()


def _worker(rank: int, world: int, tmp: str):
    torch.set_num_threads(1)
    dist.init_distributed("cpu", rank=rank, world_size=world, init_method=f"file://{tmp}/store")
    try:
        tmp = Path(tmp)
        out = {"gan": _gan_steps()}
        per = ROWS // world
        out["reinit"] = _reinit(slice(rank * per, (rank + 1) * per))
        params, data = str(tmp / "ema.yaml"), str(tmp / "data")
        out["straight"] = _train_cli(params, data, tmp / "ckpt", "straight")
        _train_cli(params, data, tmp / "ckpt", "resumed", "--max_epochs", "1")
        out["resumed"] = _train_cli(params, data, tmp / "ckpt", "resumed", "--loading_path",
                                    str(tmp / "ckpt" / "resumed" / "last"))
        out["eval"] = _evaluate_cli(params, data, tmp / "ckpt" / "straight" / "last")
        out["fid"] = _fid(slice(rank, None, world))
        out["restored"] = _restored_stream(tmp)
        torch.save(out, tmp / f"rank{rank}.pt")
    finally:
        dist.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_loop")
    rs = np.random.RandomState(0)
    (tmp / "data").mkdir()
    for split, n in SPLITS.items():
        write_packed(str(tmp / "data" / f"{split}.pack"),
                     (rs.randint(0, 256, (IMG, IMG, 3), dtype=np.uint8) for _ in range(n)), IMG)
    (tmp / "ema.yaml").write_text(yaml.safe_dump(ema_raw(accum=2)))
    # one process's snapshot, for the ranks to resume on two
    _train_cli(str(tmp / "ema.yaml"), str(tmp / "data"), tmp / "ckpt", "one", "--max_epochs",
               "1")
    ctx = mp.spawn(_worker, args=(WORLD, str(tmp)), nprocs=WORLD, join=False)
    one = {"reinit": _reinit(slice(None)), "fid": _fid(slice(None))}
    while not ctx.join():
        pass
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    # one process, no group: the eval CLI on the same snapshot
    one["eval"] = _evaluate_cli(str(tmp / "ema.yaml"), str(tmp / "data"),
                                tmp / "ckpt" / "straight" / "last")
    return {"ranks": ranks, "one": one, "tmp": tmp}


def test_gan_replicas_stay_bitwise_equal(runs):
    (steps0, snap0), (steps1, snap1) = (r["gan"] for r in runs["ranks"])
    for steps in (steps0, steps1):
        assert all(np.isfinite(v) for m in steps for v in m.values())
        assert steps[0]["r1_penalty"] > 0 and steps[1]["r1_penalty"] == 0
    assert steps0 == steps1        # the metrics are means over the ranks
    assert snap0.keys() == snap1.keys()
    for k in snap0:
        assert torch.equal(snap0[k], snap1[k]), k


def test_reinit_picks_the_same_rows_on_every_rank(runs):
    (r0, r1), one = (r["reinit"] for r in runs["ranks"]), runs["one"]["reinit"]
    for k in ("codebook.weight", "ema_weight", "ema_count", "usage"):
        assert torch.equal(r0[k], r1[k]), k
    assert torch.equal(r0["usage"], one["usage"])
    dead = r0["usage"] == 0
    assert 0 < int(dead.sum()) < dead.numel()
    assert not torch.equal(r0["codebook.weight"][dead], r0["before"][dead])
    for k in ("codebook.weight", "ema_weight", "ema_count"):
        np.testing.assert_allclose(r0[k].numpy(), one[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_only_rank_0_writes(runs):
    run = runs["tmp"] / "ckpt" / "straight"
    assert sorted(p.name for p in run.iterdir()) == [
        "epoch_0000", "epoch_0001", "last", "metrics.jsonl"]
    records = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    prefixes = [{k.split("/")[0] for k in r if "/" in k} for r in records]
    assert prefixes == [{"train"}, {"val_metrics"}, {"validation"}, {"train"}]
    assert [r["step"] for r in records] == [2, 2, 2, 4]


def test_resume_continues_bit_for_bit(runs):
    for r in runs["ranks"]:
        a, b = r["straight"], r["resumed"]
        assert a["step"] == b["step"] == 4
        assert torch.equal(a["usage"], b["usage"])
        assert torch.equal(a["generator"], b["generator"])
        for k in a["model"]:
            assert torch.equal(a["model"][k], b["model"][k]), k
        for pid, s in a["optimizer"]["state"].items():
            for k, v in s.items():
                assert torch.equal(v, b["optimizer"]["state"][pid][k]), (pid, k)
    # the ranks' streams differ; their replicas do not
    r0, r1 = (r["straight"] for r in runs["ranks"])
    assert not torch.equal(r0["generator"], r1["generator"])
    assert all(torch.equal(r0["model"][k], r1["model"][k]) for k in r0["model"])


def test_evaluate_on_two_ranks_equals_one_process(runs):
    want = runs["one"]["eval"]
    for r in runs["ranks"]:
        got = r["eval"]
        assert got.keys() == want.keys() == {"mse", "psnr", "ssim", "used_codebook",
                                             "perplexity"}
        for k in ("mse", "psnr", "ssim"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert got["used_codebook"] == want["used_codebook"]
        assert got["perplexity"] == want["perplexity"]


def test_a_snapshot_of_another_world_resumes_with_fresh_streams(runs):
    """Rank 0 takes the one-process snapshot's stream; rank 1, which the
    snapshot has none for, a fresh one seeded by (step, rank)."""
    payload = torch.load(runs["tmp"] / "ckpt" / "one" / "last" / "state.pt",
                         weights_only=True)
    assert "rank_generators" not in payload
    (g0, step0), (g1, step1) = (r["restored"] for r in runs["ranks"])
    assert step0 == step1 == payload["step"] == 2
    assert torch.equal(g0, payload["generator"])
    assert torch.equal(g1, torch.Generator().manual_seed(dist.rank_seed(2, 1)).get_state())
    two = torch.load(runs["tmp"] / "ckpt" / "straight" / "last" / "state.pt",
                     weights_only=True)
    assert len(two["rank_generators"]) == WORLD
    assert torch.equal(two["rank_generators"][0], two["generator"])


def test_fid_reduces_over_ranks(runs):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["fid"], runs["one"]["fid"], rtol=1e-9)
