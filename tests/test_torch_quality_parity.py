"""The port's quality-parity chain on the CPU (``eval/quality_parity.py``,
``cli/quality_parity.py``), against ``tools/check_quality_parity.py`` and
``tools/quality_parity.sh``:

- the port's published table and tolerances are the JAX tool's (loaded by
  path: the port may not import ``tools``);
- ``check`` passes each published row, fails a value one step outside each
  tolerance and a missing rFID unless it is allowed; ``main`` exits as the
  tool does;
- the chain's ``--dry-run`` in process on fixtures made from seeded port
  models of the gumbel and entropy quantizers in the reference's Lightning
  layout (``state_dict`` of the port's VQVAE plus a loss-stack entry),
  seeded FID-inception weights and the JAX chain's synthetic 16^2 data
  (8 test images): exit 0, every metric line parses, and the metrics equal
  those of ``cli.evaluate`` run directly on a port snapshot of the same
  weights, to every printed digit;
- without ``--dry-run`` a random-weight gumbel run exits 1 naming each metric
  out of tolerance, and an empty ``--checkpoints`` exits 2.
"""

import importlib.util
import shutil
from pathlib import Path

import pytest
import torch
import yaml

from vqvae_tpu_torch.cli import evaluate as cli_evaluate
from vqvae_tpu_torch.cli import quality_parity as chain
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.eval import quality_parity as qp
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.utils.checkpoint import save_eval_checkpoint
from vqvae_tpu_torch.utils.convert import random_inception_npz

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
AE = {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]}
TRAINING = {"cumulative_bs": 8, "base_lr": 1e-4, "betas": [0.0, 0.99], "eps": 1e-8,
            "weight_decay": 1e-4, "decay_epochs": 2, "max_epochs": 1}
RAW = {
    "gumbel": {"image_size": 16, "autoencoder": AE, "training": TRAINING,
               "quantizer": {"num_embeddings": 32, "embedding_dim": 8, "type": "gumbel",
                             "reinit_every_n_epochs": None,
                             "params": {"straight_through": False, "temp": 1.0,
                                        "kl_cost": 0.00859375, "kl_warmup_epochs": 0.48,
                                        "temp_decay_epochs": 15, "temp_final": 0.0625}}},
    "entropy": {"image_size": 16, "autoencoder": AE, "training": TRAINING,
                "quantizer": {"num_embeddings": 32, "embedding_dim": 8, "type": "entropy",
                              "reinit_every_n_epochs": None,
                              "params": {"ent_loss_ratio": 0.1, "ent_temperature": 0.01,
                                         "ent_loss_type": "softmax",
                                         "commitment_cost": 0.25}}},
}
SEEDS = {"gumbel": 3, "entropy": 4}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "check_quality_parity_tool", ROOT / "tools" / "check_quality_parity.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _model(run: str) -> VQVAE:
    return VQVAE.from_config(parse_config(RAW[run]), device="cpu",
                             generator=torch.Generator().manual_seed(SEEDS[run]))


def _write_run(directory: Path, run: str, stem: str, conf_name: str) -> None:
    """``run``'s seeded model as the reference's Lightning checkpoint
    ``directory/stem.ckpt``, its YAML beside it as ``conf_name``."""
    directory.mkdir(parents=True, exist_ok=True)
    sd = {k: v.clone() for k, v in _model(run).state_dict().items()}
    sd["criterion.perceptual_loss.lin0.model.1.weight"] = torch.ones(1, 64, 1, 1)
    torch.save({"epoch": 3, "global_step": 120, "state_dict": sd}, directory / f"{stem}.ckpt")
    (directory / conf_name).write_text(yaml.safe_dump(RAW[run]))


def _evaluate_direct(run: str, snapshot: Path, dataset: Path, npz: Path, monkeypatch) -> dict:
    """``cli.evaluate`` on a port snapshot of ``run``'s weights."""
    save_eval_checkpoint(str(snapshot), _model(run))
    (snapshot / "conf.yaml").write_text(yaml.safe_dump(RAW[run]))
    with monkeypatch.context() as m:
        m.setenv("VQVAE_TPU_INCEPTION_WEIGHTS", str(npz))
        return cli_evaluate.main(["--params_file", str(snapshot / "conf.yaml"),
                                  "--dataset_path", str(dataset), "--batch_size", "8",
                                  "--seed", "42", "--loading_path", str(snapshot),
                                  "--device", "cpu"])


@pytest.fixture(scope="module")
def dry_run(tmp_path_factory):
    """The chain's dry run on gumbel and entropy fixtures, once."""
    root = tmp_path_factory.mktemp("quality_parity")
    fixdir = root / "fixtures"
    for run in RAW:
        _write_run(fixdir / run, run, "model", "conf.yaml")
    random_inception_npz(fixdir / "inception_fid.npz", seed=7)
    cache = root / "cache"
    code = chain.main(["--dry-run", str(fixdir), "--cache", str(cache), "--batch", "8",
                       "--device", "cpu"])
    return {"root": root, "fixdir": fixdir, "cache": cache, "code": code}


def test_published_table_and_tolerances_are_the_jax_tools():
    tool = _tool()
    assert qp.PUBLISHED == tool.PUBLISHED
    assert qp.TOLERANCES == tool.TOLERANCES
    text = "[INFO] device: cpu\nmse: 0.007500\n  psnr :21.230000 \nrfid: nan\nssim: 1e-2"
    assert qp.parse_metrics(text) == tool.parse_metrics(text) == {
        "mse": 0.0075, "psnr": 21.23, "ssim": 0.01}


def _outside(want: float, kind: str, tol: float, sign: int) -> float:
    """A value one step past the tolerance, above (sign 1) or below (-1)."""
    step = tol * 1.001
    return want * (1 + sign * step) if kind == "rel" else want + sign * step


@pytest.mark.parametrize("run", sorted(qp.PUBLISHED))
def test_check_holds_the_published_row(run, capsys):
    good = dict(qp.PUBLISHED[run])
    assert qp.check(run, good) == []
    for key, (kind, tol) in qp.TOLERANCES.items():
        inside = {k: (v * (1 + 0.999 * tol) if kind == "rel" else v + 0.999 * tol)
                  if k == key else v for k, v in good.items()}
        assert qp.check(run, inside) == [], key
        for sign in (1, -1):
            bad = dict(good, **{key: _outside(good[key], kind, tol, sign)})
            failures = qp.check(run, bad)
            assert len(failures) == 1 and failures[0].startswith(f"{key}:"), (key, sign)
    no_rfid = {k: v for k, v in good.items() if k != "rfid"}
    failures = qp.check(run, no_rfid)
    assert len(failures) == 1 and "MISSING" in failures[0]
    assert qp.check(run, no_rfid, require_rfid=False) == []
    # evaluate's exact lines round-trip through the parser
    text = "\n".join(f"{k}: {v:.6f}" for k, v in good.items())
    assert qp.parse_metrics("[INFO] noise\n" + text) == {
        k: float(f"{v:.6f}") for k, v in good.items()}
    capsys.readouterr()


def test_checker_main_exit_codes(tmp_path, capsys):
    good = qp.PUBLISHED["entropy"]
    path = tmp_path / "m.txt"
    path.write_text("\n".join(f"{k}: {v:.6f}" for k, v in good.items()))
    assert qp.main(["--run", "entropy", "--metrics", str(path)]) == 0
    assert "QUALITY PARITY OK (entropy)" in capsys.readouterr().out
    assert qp.main(["--run", "gumbel", "--metrics", str(path)]) == 1
    assert "QUALITY PARITY FAILED (gumbel)" in capsys.readouterr().err
    path.write_text("\n".join(f"{k}: {v:.6f}" for k, v in good.items() if k != "rfid"))
    assert qp.main(["--run", "entropy", "--metrics", str(path)]) == 1
    assert qp.main(["--run", "entropy", "--metrics", str(path), "--allow_missing_rfid"]) == 0
    path.write_text("[INFO] nothing\n")
    assert qp.main(["--run", "entropy", "--metrics", str(path)]) == 1
    assert "no metric lines" in capsys.readouterr().err


def test_find_runs_names_and_yaml_rule(tmp_path):
    (tmp_path / "a").mkdir()
    for f in ("gumbel.ckpt", "gumbel.yaml", "a/model.ckpt", "a/conf.yaml", "b.ckpt"):
        (tmp_path / f).write_text("")
    found = {name: (ckpt.name, conf and conf.name)
             for name, ckpt, conf in chain.find_runs(tmp_path)}
    assert found == {"gumbel": ("gumbel.ckpt", "gumbel.yaml"),
                     "a_model": ("model.ckpt", "conf.yaml"), "b": ("b.ckpt", None)}
    assert chain.run_kind("vqgan_gumbel_entropy", ["gumbel", "entropy"]) == "entropy"
    assert chain.run_kind("standard", ["gumbel", "entropy"]) is None


@pytest.mark.parametrize("run", sorted(RAW))
def test_dry_run_equals_a_direct_evaluate(dry_run, run, monkeypatch):
    assert dry_run["code"] == 0
    cache = dry_run["cache"]
    name = f"{run}_model"
    assert (cache / "imported_torch" / name / "state.pt").is_file()
    logged = qp.parse_metrics((cache / "quality_parity_torch" / f"eval_{name}.txt").read_text())
    assert chain.DRY_RUN_KEYS | {"rfid"} <= set(logged)
    direct = _evaluate_direct(run, dry_run["root"] / "direct" / run,
                              cache / "quality_parity_torch" / "dryrun_data",
                              dry_run["fixdir"] / "inception_fid.npz", monkeypatch)
    assert logged == {k: float(f"{v:.6f}") for k, v in direct.items()}


def test_random_weights_fail_the_published_row(dry_run, tmp_path, capsys):
    checkpoints = tmp_path / "hf"
    _write_run(checkpoints, "gumbel", "gumbel", "gumbel.yaml")
    _write_run(checkpoints, "entropy", "vqvae_plain", "vqvae_plain.yaml")   # not in --runs
    cache = tmp_path / "cache"
    cache.mkdir()
    shutil.copyfile(dry_run["fixdir"] / "inception_fid.npz", cache / "inception_fid.npz")
    dataset = dry_run["cache"] / "quality_parity_torch" / "dryrun_data"
    code = chain.main(["--dataset", str(dataset), "--checkpoints", str(checkpoints),
                       "--cache", str(cache), "--batch", "8", "--device", "cpu"])
    out = capsys.readouterr()
    assert code == 1
    assert "skipping vqvae_plain" in out.out
    logged = qp.parse_metrics((cache / "quality_parity_torch" / "eval_gumbel.txt").read_text())
    failing = {f.split(":")[0] for f in qp.check("gumbel", logged)}
    assert {"mse", "psnr", "rfid"} <= failing
    for key in qp.PUBLISHED["gumbel"]:
        assert (f"  - {key}:" in out.err) == (key in failing), key
    assert "QUALITY PARITY FAILED (gumbel)" in out.err


def test_nothing_found_or_missing_yaml_exits_2(dry_run, tmp_path, capsys):
    dataset = dry_run["cache"] / "quality_parity_torch" / "dryrun_data"
    common = ["--dataset", str(dataset), "--cache", str(tmp_path / "cache"), "--device", "cpu"]
    (tmp_path / "empty").mkdir()
    assert chain.main(common + ["--checkpoints", str(tmp_path / "empty")]) == 2
    assert "no reference checkpoint" in capsys.readouterr().err
    (tmp_path / "noyaml").mkdir()
    (tmp_path / "noyaml" / "gumbel.ckpt").write_text("")
    assert chain.main(common + ["--checkpoints", str(tmp_path / "noyaml")]) == 2
    assert "no gumbel.yaml or conf.yaml" in capsys.readouterr().err
    assert chain.main(["--dataset", str(tmp_path / "empty"), "--checkpoints",
                       str(tmp_path / "noyaml")]) == 2
    assert "validation/ and test/" in capsys.readouterr().err
    assert not (tmp_path / "cache").exists()
