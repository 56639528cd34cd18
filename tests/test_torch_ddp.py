"""Data parallelism of the port (``vqvae_tpu_torch/parallel``) on the CPU:
two gloo ranks, spawned with ``torch.multiprocessing`` and joined through a
``file://`` store under ``tmp_path``, against the JAX package on a 2-device
mesh (``create_mesh(devices=jax.devices()[:2])``) and against one port
process on the global batch.

- The EMA quantizer's update with 8 rows on each rank equals the update on
  all 16 rows and JAX's ``shard_map`` over 2 devices (the counterpart of
  ``tests/test_parallel.py``), rtol 2e-5 / atol 1e-6.
- The ``Trainer`` (``standard`` and ``ema``; tiny config, 2 x 4 rows, 3 steps,
  fp32, no augmentations, from the JAX Trainer's initial weights) against
  the JAX ``Trainer`` on the mesh: step 1's metrics rtol 1e-4 and every
  step's rtol 5e-3 / atol 1e-5 (the trajectory tolerances of
  ``torch_train_parity.py``), the usage counts exactly, the EMA buffers
  rtol 1e-4 / atol 1e-6 and the parameters rtol 1e-3 / atol 1e-5 after the 3
  steps, but for at most 0.1% of the entries, each within 2 LR per step (an
  entry whose gradient is 0 up to rounding takes AdamW's unit step either
  way: 30 of 298379 entries in the standard run, 24 of them the 32 biases
  of the decoder's last upsampling conv; one JAX process against one port
  process shows the same entries). Against one port process on the 8
  rows: metrics rtol 1e-5, usage exact, parameters and buffers rtol 1e-4 /
  atol 1e-6 but for at most 0.1% of the entries, as above (33 of 298667 in
  the EMA run).
- ``eval_step`` on a ragged masked batch (rank 1 holds the 2 masked rows)
  equals JAX's on the mesh: the masked means, ``n_valid`` and the
  ``n_valid``-weighted ``quant_loss``, rtol 1e-5, and the usage exactly.
- ``check_replication`` passes on the trained replicas and, after rank 1
  moves one entry of ``ema_count``, raises on both ranks naming that buffer.
- ``param_summary`` prints the JAX package's table for the same model.
- The collectives' helpers: ``local_batch_size`` raises on a batch the ranks
  do not divide; ``rank_seed`` keeps rank 0's seed; the train CLI's
  ``--num_nodes`` must match the world.
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.models.quantizers import EMAVectorQuantizer
from vqvae_tpu_torch.parallel import dist
from vqvae_tpu_torch.train.loop import Trainer
from vqvae_tpu_torch.utils.introspect import check_replication

torch.set_num_threads(1)

WORLD, ROWS, STEPS, IMG, LR = 2, 8, 3, 16, 1e-3
NRB, LEVELS = 1, 2
N, D, DECAY = 16, 8, 0.9
EVAL_MASK = np.array([True] * 6 + [False] * 2)
Q_TYPES = ("standard", "ema")


def raw_config(q_type: str) -> dict:
    params = {"commitment_cost": 0.25}
    if q_type == "ema":
        params.update(decay=0.95, epsilon=1e-5)
    return {
        "image_size": IMG,
        "autoencoder": {"channels": 32, "num_res_blocks": NRB, "channel_multipliers": [1, 2]},
        "quantizer": {"type": q_type, "num_embeddings": 32, "embedding_dim": 8,
                      "reinit_every_n_epochs": None, "params": params},
        "training": {"cumulative_bs": ROWS, "base_lr": LR, "betas": [0.0, 0.99],
                     "eps": 1e-8, "weight_decay": 1e-4, "decay_epochs": 1, "max_epochs": 300},
    }


def _inputs():
    rs = np.random.RandomState(0)
    z = rs.randn(16, 2, 2, D).astype(np.float32)
    cb = (rs.randn(N, D) * 0.1).astype(np.float32)
    batches = np.random.RandomState(42).rand(STEPS, ROWS, IMG, IMG, 3).astype(np.float32)
    eval_images = np.random.RandomState(43).rand(ROWS, IMG, IMG, 3).astype(np.float32)
    return z, cb, batches, eval_images


def _ema_update(z: np.ndarray, cb: np.ndarray) -> dict:
    """The port's EMA quantizer, train=True on ``z`` (NHWC): its buffers."""
    q = EMAVectorQuantizer(N, D, decay=DECAY)
    q.load_state_dict({"codebook.weight": torch.from_numpy(cb),
                       "ema_count": torch.ones(N), "ema_weight": torch.from_numpy(cb)})
    q(torch.from_numpy(z).permute(0, 3, 1, 2), train=True)
    return {k: v.clone() for k, v in q.state_dict().items()}


def _port_run(q_type: str, weights: dict, rows: slice) -> dict:
    """The port's Trainer from ``weights``: eval_step on the eval batch's
    ``rows``, then STEPS train steps on the batches' ``rows``."""
    _, _, batches, eval_images = _inputs()
    trainer = Trainer(parse_config(raw_config(q_type)), learning_rate=LR, seed=0,
                      steps_per_epoch=24, augment=False, device="cpu")
    state = trainer.init_state()
    state.model.load_state_dict(weights, strict=True)
    metrics, usage, _ = trainer.eval_step(
        state, {"image": eval_images[rows], "mask": EVAL_MASK[rows]}, epoch=0)
    out = {"eval": ({k: float(v) for k, v in metrics.items()}, usage.clone()), "traj": []}
    for b in batches:
        state, m = trainer.train_step(state, {"image": b[rows]}, epoch=0)
        out["traj"].append({k: float(v) for k, v in m.items()})
    check_replication({"model": state.model, "usage_count": state.usage_count})
    out["state"] = {k: v.clone() for k, v in state.model.state_dict().items()}
    out["usage"] = state.usage_count.clone()
    if q_type == "ema":
        # one replica moves one entry: every rank must raise, naming it
        rank, _ = dist.world()
        q = state.model.quantizer
        if rank == 1:
            q.ema_count[3] += 1e-3
        try:
            check_replication({"model": state.model})
            out["perturbed"] = None
        except AssertionError as e:
            out["perturbed"] = str(e)
    return out


def _worker(rank: int, world: int, store: str, payload: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_distributed("cpu", rank=rank, world_size=world, init_method=f"file://{store}")
    try:
        weights = torch.load(payload, weights_only=True)
        z, cb, _, _ = _inputs()
        per = ROWS // world
        rows = slice(rank * per, (rank + 1) * per)
        out = {"ema_update": _ema_update(z[rank * 8:(rank + 1) * 8], cb),
               "world": dist.world()}
        for q_type in Q_TYPES:
            out[q_type] = _port_run(q_type, weights[q_type], rows)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.shutdown()


def _variables(state) -> dict:
    import jax
    return jax.tree.map(np.array, {"params": state.params, **(
        {"vq_state": state.vq_state} if state.vq_state is not None else {})})


def _jax_trainers():
    """The JAX Trainers on a 2-device mesh, their initial states, and those
    weights in the port's layout."""
    import jax
    import jax.numpy as jnp

    from vqvae_tpu.config import parse_config as jax_parse_config
    from vqvae_tpu.parallel.mesh import create_mesh
    from vqvae_tpu.train.loop import Trainer as JaxTrainer
    from vqvae_tpu.utils.introspect import param_summary
    from vqvae_tpu_torch.utils.convert import convert_vqvae_variables

    mesh = create_mesh(devices=jax.devices()[:WORLD])
    trainers, weights, summaries = {}, {}, {}
    for q_type in Q_TYPES:
        jt = JaxTrainer(cfg=jax_parse_config(raw_config(q_type)), learning_rate=LR, seed=0,
                        steps_per_epoch=24, mesh=mesh, compute_dtype=jnp.float32, remat=False,
                        augment=False)
        # the same initial weights, compiled once instead of traced op by op
        jt.model.init = jax.jit(jt.model.init, static_argnames=("train",))
        state = jt.init_state()
        trainers[q_type] = (jt, state)
        weights[q_type] = convert_vqvae_variables(_variables(state), NRB, LEVELS)
        summaries[q_type] = param_summary(jax.device_get(state.params))
    return mesh, trainers, weights, summaries


def _jax_runs(mesh, trainers) -> dict:
    """The JAX side: the EMA update under shard_map, and each Trainer's
    masked eval step and STEPS train steps on the mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from vqvae_tpu.models.quantizers import EMAVectorQuantizer as JaxEMA
    from vqvae_tpu_torch.utils.convert import convert_vqvae_variables

    z, cb, batches, eval_images = _inputs()
    vq = {"codebook": jnp.asarray(cb), "ema_count": jnp.ones((N,), jnp.float32),
          "ema_weight": jnp.asarray(cb)}
    q = JaxEMA(N, D, decay=DECAY, axis_name="data")

    def step(state, zz):
        _, upd = q.apply({"vq_state": state}, zz, train=True, mutable=["vq_state"])
        return upd["vq_state"]

    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(P(), P("data")), out_specs=P(),
                               check_vma=False))
    out = {"ema_update": jax.tree.map(np.array, fn(vq, jnp.asarray(z)))}
    for q_type, (jt, state) in trainers.items():
        try:
            mj, uj, _ = jt.eval_step(state, {"image": eval_images, "mask": EVAL_MASK}, epoch=0)
            run = {"eval": (jax.device_get(mj), np.asarray(uj)), "traj": []}
            for b in batches:
                state, m = jt.train_step(state, {"image": jnp.asarray(b)}, epoch=0)
                run["traj"].append({k: float(v) for k, v in jax.device_get(m).items()})
            run["state"] = convert_vqvae_variables(_variables(state), NRB, LEVELS)
            run["usage"] = np.array(state.usage_count)
        finally:
            jt.native_lr.destroy()
        out[q_type] = run
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    mesh, trainers, weights, summaries = _jax_trainers()
    payload = tmp / "weights.pt"
    torch.save(weights, payload)
    # the ranks run while this process runs the JAX side and one port process
    ctx = mp.spawn(_worker, args=(WORLD, str(tmp / "store"), str(payload), str(tmp)),
                   nprocs=WORLD, join=False)
    jax_out = _jax_runs(mesh, trainers)
    z, cb, _, _ = _inputs()
    one = {"ema_update": _ema_update(z, cb)}
    for q_type in Q_TYPES:
        one[q_type] = _port_run(q_type, weights[q_type], slice(None))
    while not ctx.join():
        pass
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"jax": jax_out, "ranks": ranks, "one": one, "summaries": summaries}


def test_ranks_joined_one_group(runs):
    assert [r["world"] for r in runs["ranks"]] == [(0, WORLD), (1, WORLD)]


def test_ema_update_is_global_over_ranks(runs):
    want_jax = runs["jax"]["ema_update"]
    for r in runs["ranks"]:
        for name, key in (("codebook.weight", "codebook"), ("ema_count", "ema_count"),
                          ("ema_weight", "ema_weight")):
            got = r["ema_update"][name].numpy()
            np.testing.assert_allclose(got, runs["one"]["ema_update"][name].numpy(), rtol=2e-5,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(got, want_jax[key], rtol=2e-5, atol=1e-6, err_msg=name)
    rank0, rank1 = (r["ema_update"] for r in runs["ranks"])
    assert all(torch.equal(rank0[k], rank1[k]) for k in rank0)


def _close_states(got: dict, want: dict, rtol: float, atol: float, share: float = 0.0):
    """Every tensor within rtol / atol, but for at most ``share`` of all the
    entries, which must lie within one AdamW trajectory's reach (2 LR per
    step): an entry whose gradient is 0 up to rounding takes its near
    unit-size step either way."""
    assert got.keys() == want.keys()
    outside = total = 0
    for k, v in got.items():
        a, b = v.numpy(), np.asarray(want[k])
        bad = ~np.isclose(a, b, rtol=rtol, atol=atol)
        outside, total = outside + int(bad.sum()), total + a.size
        if share:
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * STEPS, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=k)
    assert outside <= share * total, (outside, total)


@pytest.mark.parametrize("q_type", Q_TYPES)
def test_trainer_matches_jax_mesh(runs, q_type):
    want = runs["jax"][q_type]
    for r in runs["ranks"]:
        got = r[q_type]
        assert set(got["traj"][0]) == set(want["traj"][0])
        for k, v in got["traj"][0].items():
            np.testing.assert_allclose(v, want["traj"][0][k], rtol=1e-4, err_msg=k)
        for key in ("loss", "l2_loss", "quant_loss"):
            np.testing.assert_allclose([m[key] for m in got["traj"]],
                                       [m[key] for m in want["traj"]], rtol=5e-3, atol=1e-5,
                                       err_msg=key)
        np.testing.assert_array_equal(got["usage"].numpy(), want["usage"])
        assert int(got["usage"].sum()) == STEPS * ROWS * 16
        params = {k: v for k, v in got["state"].items() if "ema_" not in k
                  and not (q_type == "ema" and k == "quantizer.codebook.weight")}
        _close_states(params, {k: want["state"][k] for k in params}, rtol=1e-3, atol=1e-5,
                      share=1e-3)
        if q_type == "ema":
            buffers = {k: v for k, v in got["state"].items() if k.startswith("quantizer.")}
            _close_states(buffers, {k: want["state"][k] for k in buffers}, rtol=1e-4,
                          atol=1e-6)


@pytest.mark.parametrize("q_type", Q_TYPES)
def test_trainer_two_ranks_equal_one_process(runs, q_type):
    want = runs["one"][q_type]
    rank0, rank1 = (r[q_type] for r in runs["ranks"])
    for k in want["state"]:
        assert torch.equal(rank0["state"][k], rank1["state"][k]), k
    for got in (rank0, rank1):
        for step, m in enumerate(got["traj"]):
            for k, v in m.items():
                np.testing.assert_allclose(v, want["traj"][step][k], rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {step} {k}")
        assert torch.equal(got["usage"], want["usage"])
        _close_states(got["state"], want["state"], rtol=1e-4, atol=1e-6, share=1e-3)


@pytest.mark.parametrize("q_type", Q_TYPES)
def test_masked_eval_step_matches_jax_mesh(runs, q_type):
    want, want_usage = runs["jax"][q_type]["eval"]
    for r in runs["ranks"] + [runs["one"]]:
        metrics, usage = r[q_type]["eval"]
        assert metrics["n_valid"] == float(want["n_valid"]) == EVAL_MASK.sum()
        for k in ("loss", "l1_loss", "l2_loss", "quant_loss", "perc_loss"):
            np.testing.assert_allclose(metrics[k], float(want[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_array_equal(usage.numpy(), want_usage)
        assert int(usage.sum()) == EVAL_MASK.sum() * 16


def test_check_replication_names_the_diverged_buffer(runs):
    for r in runs["ranks"]:
        assert "replication mismatch at model.quantizer.ema_count" in (r["ema"]["perturbed"] or "")
    assert runs["one"]["ema"]["perturbed"] is None   # one process: nothing to compare


@pytest.mark.parametrize("q_type", Q_TYPES)
def test_param_summary_is_the_jax_packages(runs, q_type):
    from vqvae_tpu_torch.models.vqvae import VQVAE
    from vqvae_tpu_torch.utils.introspect import param_summary
    model = VQVAE.from_config(parse_config(raw_config(q_type)), device="cpu")
    assert param_summary(model) == runs["summaries"][q_type]


def test_helpers():
    assert dist.world() == (0, 1)
    assert dist.local_batch_size(256, 8) == 32
    with pytest.raises(ValueError):
        dist.local_batch_size(100, 8)
    assert dist.rank_seed(5, 0) == 5
    seeds = {dist.rank_seed(5, r) for r in range(1, 4)}
    assert len(seeds) == 3 and 5 not in seeds and all(0 <= s < 2**63 for s in seeds)
    assert dist.init_distributed("cpu") == (0, 1)   # no torchrun environment: no group
    t = torch.ones(3)
    dist.all_reduce_mean_([t])
    dist.all_reduce_sum_([t, None])
    assert torch.equal(t, torch.ones(3))
    from vqvae_tpu_torch.cli import train as cli_train
    with pytest.raises(ValueError, match="--num_nodes 2"):   # one process is not 2 nodes
        cli_train.main(["--params_file", "x", "--dataset_path", "x", "--save_path", "x",
                        "--run_name", "x", "--seed", "0", "--device", "cpu", "--num_nodes", "2"])
