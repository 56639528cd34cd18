"""The PyTorch port stands apart from JAX: importing it and every submodule
loads neither the JAX package nor jax / flax / optax / orbax nor the JAX
CLIs (``evaluate``, ``tools.*``), no file of it imports them, its own config
parser equals the JAX package's, its entry points (``run_training``, the
train, eval and token-export CLIs and the FID extractor among them) ask for
the card unless told otherwise, its copies of the host sources keep the C interface
their loaders bind, ``chip_smoke.py`` refuses to run without a GPU, the
profiler sorts kernel names into the kinds it reports, and the export step
of a JAX checkpoint (``tools/export_jax_checkpoint.py``) loads no torch.
"""

import ctypes
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "vqvae_tpu_torch"
CONFIGS = sorted((ROOT / "example_confs").glob("*.yaml"))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vqvae_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vqvae_tpu_torch.__path__, "vqvae_tpu_torch.")]
for name in names:
    importlib.import_module(name)
cfg = vqvae_tpu_torch.load_config("example_confs/standard_vqvae.yaml")
assert vqvae_tpu_torch.VQVAE.__name__ == "VQVAE" and cfg.latent_size == 16
assert {"vqvae_tpu_torch.cli.train", "vqvae_tpu_torch.cli.create_packed_dataset",
        "vqvae_tpu_torch.cli.evaluate", "vqvae_tpu_torch.cli.tokenize_dataset",
        "vqvae_tpu_torch.eval.metrics", "vqvae_tpu_torch.eval.inception",
        "vqvae_tpu_torch.eval.fid", "vqvae_tpu_torch.train.loop",
        "vqvae_tpu_torch.data.dataset", "vqvae_tpu_torch.parallel",
        "vqvae_tpu_torch.parallel.dist", "vqvae_tpu_torch.utils.introspect",
        "vqvae_tpu_torch.parallel.spatial", "vqvae_tpu_torch.utils.torch_import",
        "vqvae_tpu_torch.cli.import_torch_checkpoint", "vqvae_tpu_torch.cli.import_jax_checkpoint",
        "vqvae_tpu_torch.ops.misc_ops", "vqvae_tpu_torch.bench_infer",
        "vqvae_tpu_torch.probe_max_resolution", "vqvae_tpu_torch.eval.quality_parity",
        "vqvae_tpu_torch.cli.quality_parity", "vqvae_tpu_torch.bench_input",
        "vqvae_tpu_torch.bench_breakdown", "vqvae_tpu_torch.bench"} <= set(names)
from vqvae_tpu_torch.models.lpips import LPIPS
for net in ("alex", "squeeze"):
    LPIPS(net, device="cpu")
loaded = sorted(m for m in ("vqvae_tpu", "jax", "flax", "optax", "orbax", "evaluate", "tools",
                            "torchvision") if m in sys.modules)
print(len(names), loaded)
"""


def test_import_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, loaded = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 59
    assert loaded.strip() == "[]"


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|evaluate|tools|torchvision)\b",
                         re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []
    jax_pkg = re.compile(r"^\s*(import|from)\s+vqvae_tpu(\.|\s|$)", re.M)
    assert [str(f.relative_to(ROOT)) for f in files if jax_pkg.search(f.read_text())] == []


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_parser_equals_the_jax_packages(path):
    """On every SerezD-layout YAML the port's reading equals the JAX
    package's. The JAX package has no taming layout: on
    ``taming_vqgan_f16.yaml`` and ``kandinsky22_movq.yaml`` the port's
    reading is checked alone."""
    from vqvae_tpu_torch import config as port_config
    if port_config.get_model_conf(str(path))["autoencoder"].get("layout") == "taming":
        cfg = port_config.load_config(str(path))
        assert isinstance(cfg.autoencoder, port_config.TamingAutoencoderConf)
        assert cfg.loss is None and cfg.training is None
        if path.name == "kandinsky22_movq.yaml":
            assert cfg.autoencoder.norm_type == "spatial"
            assert (cfg.autoencoder.attn_resolutions, cfg.autoencoder.z_channels) == ((64,), 4)
            assert cfg.autoencoder.channel_multipliers == (1, 2, 2, 4)
            assert (cfg.quantizer.num_embeddings, cfg.quantizer.embedding_dim) == (16384, 4)
            assert cfg.latent_size == 64
            return
        assert path.name == "taming_vqgan_f16.yaml"
        assert cfg.autoencoder.norm_type == "group"
        assert (cfg.autoencoder.attn_resolutions, cfg.autoencoder.z_channels) == ((16,), 256)
        assert cfg.autoencoder.channel_multipliers == (1, 1, 2, 2, 4)
        assert cfg.latent_size == 16
        return
    from vqvae_tpu import config as jax_config
    want = dataclasses.asdict(jax_config.load_config(str(path)))
    got = dataclasses.asdict(port_config.load_config(str(path)))
    assert got == want
    assert port_config.load_config(str(path)).latent_size == want["image_size"] // 2 ** len(
        want["autoencoder"]["channel_multipliers"])


def test_entry_points_ask_for_the_card_by_default(monkeypatch, tmp_path):
    """Without ``device`` the models (the gumbel one too), the discriminator,
    LPIPS and the Trainers (the GAN one too) go to CUDA; here the move is
    recorded, not made, so the test runs without a card."""
    from vqvae_tpu_torch import load_config
    from vqvae_tpu_torch.models.discriminator import Discriminator
    from vqvae_tpu_torch.models.lpips import LPIPS, init_lpips
    from vqvae_tpu_torch.models.vqvae import VQVAE
    from vqvae_tpu_torch.train.loop import Trainer
    asked = []

    def record_to(self, device=None, *args, **kwargs):
        asked.append(device)
        return self

    for cls in (VQVAE, Discriminator, LPIPS):
        monkeypatch.setattr(cls, "to", record_to)
    cfg = load_config(str(ROOT / "example_confs" / "ema_vqvae.yaml"))
    tiny = dataclasses.replace(cfg, image_size=16, autoencoder=dataclasses.replace(
        cfg.autoencoder, channels=32, num_res_blocks=1, channel_multipliers=(1, 2)),
        quantizer=dataclasses.replace(cfg.quantizer, num_embeddings=32, embedding_dim=8))
    VQVAE.from_config(tiny)
    VQVAE.from_config(tiny, device="cpu")
    assert [torch.device(d) for d in asked] == [torch.device("cuda"), torch.device("cpu")]

    gumbel = load_config(str(ROOT / "example_confs" / "gumbel_vqgan.yaml"))
    tiny_gan = dataclasses.replace(gumbel, image_size=16, autoencoder=tiny.autoencoder,
                                   quantizer=dataclasses.replace(gumbel.quantizer,
                                                                 num_embeddings=32))
    monkeypatch.setenv("VQVAE_TPU_LPIPS_WEIGHTS_DIR", str(tmp_path))   # no .npz: random init
    asked.clear()
    VQVAE.from_config(tiny_gan)
    Discriminator(16, channel_base=256)
    with pytest.warns(UserWarning, match="LPIPS"):
        init_lpips("vgg")
        gan_trainer = Trainer(tiny_gan, learning_rate=1e-4, seed=0, steps_per_epoch=10)
    assert [torch.device(d) for d in asked] == [torch.device("cuda")] * 4
    assert gan_trainer.device == torch.device("cuda")

    class Asked(Exception):
        pass

    def record_from_config(cfg, dtype=torch.float32, device="cuda", generator=None, remat=False):
        asked.append(device)
        raise Asked  # the state would be built on the card

    trainer = Trainer(tiny, learning_rate=1e-4, seed=0, steps_per_epoch=10)
    monkeypatch.setattr(VQVAE, "from_config", record_from_config)
    asked.clear()
    with pytest.raises(Asked):
        trainer.init_state()
    assert [torch.device(d) for d in asked] == [torch.device("cuda")]


def test_trainer_under_a_group_asks_for_its_local_rank(monkeypatch, tmp_path):
    """Under a process group (here gloo, one rank, torchrun's environment
    with ``LOCAL_RANK`` 3) the Trainer's default device, its state and the
    CLIs' card are ``cuda:3``; the group's end restores plain ``cuda``."""
    from vqvae_tpu_torch import load_config
    from vqvae_tpu_torch.models.vqvae import VQVAE
    from vqvae_tpu_torch.parallel import dist
    from vqvae_tpu_torch.train.loop import Trainer

    class Asked(Exception):
        pass

    asked = []

    def record_from_config(cfg, dtype=torch.float32, device="cuda", generator=None, remat=False):
        asked.append(device)
        raise Asked

    cfg = load_config(str(ROOT / "example_confs" / "ema_vqvae.yaml"))
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "3")):
        monkeypatch.setenv(name, value)
    assert dist.init_distributed("cpu", init_method=f"file://{tmp_path}/store") == (0, 1)
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert dist.default_device() == torch.device("cuda", 3)
        trainer = Trainer(cfg, learning_rate=1e-4, seed=0, steps_per_epoch=10)
        assert trainer.device == torch.device("cuda", 3)
        monkeypatch.setattr(VQVAE, "from_config", record_from_config)
        with pytest.raises(Asked):
            trainer.init_state()
        assert [torch.device(d) for d in asked] == [torch.device("cuda", 3)]
        assert Trainer(cfg, learning_rate=1e-4, seed=0, steps_per_epoch=10,
                       device="cpu").device == torch.device("cpu")
    finally:
        dist.shutdown()
    assert dist.default_device() == torch.device("cuda") and dist.world() == (0, 1)


def test_training_entry_points_ask_for_the_card_by_default(monkeypatch, tmp_path):
    """``run_training`` builds its Trainer on CUDA unless told otherwise, and
    the train CLI's ``--device`` defaults to ``cuda``; the packer CLI touches
    no device."""
    from vqvae_tpu_torch import load_config
    from vqvae_tpu_torch.cli import create_packed_dataset, train as cli_train
    from vqvae_tpu_torch.train import loop
    asked = []

    class Asked(Exception):
        pass

    def record_trainer(**kwargs):
        asked.append(kwargs.get("device", "<missing>"))
        raise Asked

    class Loader:
        batch_size = 8

        def __len__(self):
            return 1

    monkeypatch.setattr(loop, "Trainer", record_trainer)
    cfg = load_config(str(ROOT / "example_confs" / "ema_vqvae.yaml"))
    with pytest.raises(Asked):
        loop.run_training(cfg, Loader(), None, seed=0, learning_rate=1e-4,
                          save_dir=str(tmp_path), run_name="r")
    assert [torch.device(d) for d in asked] == [torch.device("cuda")]
    args = cli_train.parse_args(["--params_file", "x", "--dataset_path", "x", "--save_path",
                                 "x", "--run_name", "x", "--seed", "0"])
    assert args.device == "cuda" and args.precision == "bf16"
    assert "device" not in vars(create_packed_dataset.get_args(["--output_folder", "x"]))


def test_eval_entry_points_ask_for_the_card_by_default(monkeypatch, tmp_path):
    """The eval and token-export CLIs' ``--device`` defaults to ``cuda`` and
    raises without a card; the FID extractor and its loader default to
    ``cuda``; ``restore_for_eval`` has no device of its own (it follows the
    template state)."""
    import inspect

    from vqvae_tpu_torch.cli import evaluate as cli_evaluate
    from vqvae_tpu_torch.cli import tokenize_dataset as cli_tokenize
    from vqvae_tpu_torch.eval import fid, inception
    from vqvae_tpu_torch.utils import checkpoint

    args = cli_evaluate.parse_args(["--params_file", "x", "--dataset_path", "x",
                                    "--batch_size", "4", "--seed", "0", "--loading_path", "x"])
    assert args.device == "cuda"
    args = cli_tokenize.parse_args(["--params_file", "x", "--loading_path", "x",
                                    "--dataset_path", "x", "--output_folder", "x"])
    assert args.device == "cuda" and args.batch_size == 256 and args.workers == 4
    for fn in (inception.make_pool3_extractor, fid.load_inception_extractor):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert "device" not in inspect.signature(checkpoint.restore_for_eval).parameters
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_evaluate.main(["--params_file", "x", "--dataset_path", "x", "--batch_size", "4",
                           "--seed", "0", "--loading_path", "x", "--allow_missing_rfid"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_tokenize.main(["--params_file", "x", "--loading_path", "x", "--dataset_path", "x",
                           "--output_folder", str(tmp_path)])


def test_tool_entry_points_ask_for_the_card_by_default():
    """The quality-parity chain, the step decomposition and the headline
    benchmark (its orchestrator and each leg) default to ``--device cuda``,
    and the decomposition and the benchmark raise without a card; the input
    bench touches no device."""
    import inspect

    from vqvae_tpu_torch import bench, bench_breakdown, bench_input
    from vqvae_tpu_torch.cli import quality_parity

    assert quality_parity.parse_args([]).device == "cuda"
    assert bench_breakdown.parse_args([]).device == "cuda"
    assert bench.parse_args([]).device == "cuda"
    for fn in (bench.bench_flagship, bench.bench_gan_plain, bench.bench_plain):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert "device" not in vars(bench_input.parse_args([]))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench_breakdown.main([])
    for argv in ([], ["--leg", "flagship"], ["--leg", "standard_vqvae"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            bench.main(argv)


_C_TYPES = {"double": ctypes.c_double, "void*": ctypes.c_void_p, "const char*": ctypes.c_char_p,
            "int": ctypes.c_int, "int64_t": ctypes.c_int64, "void": None,
            "uint64_t*": ctypes.POINTER(ctypes.c_uint64),
            "uint32_t*": ctypes.POINTER(ctypes.c_uint32),
            "const int64_t*": ctypes.POINTER(ctypes.c_int64),
            "uint8_t*": ctypes.POINTER(ctypes.c_uint8),
            "const double*": ctypes.POINTER(ctypes.c_double),
            "double*": ctypes.POINTER(ctypes.c_double)}


def _c_interface(path: Path) -> dict:
    """name -> (restype, argtypes) of every function defined in the
    ``extern "C"`` block of a host source."""
    text = path.read_text()
    block = text[text.index('extern "C" {'):]
    out = {}
    for ret, name, params in re.findall(r"^(void\*|void|double|int)\s+(\w+)\(([^)]*)\)\s*\{",
                                        block, re.M):
        types = [" ".join(p.split()[:-1]).replace(" *", "*") for p in params.split(",")]
        out[name] = (_C_TYPES[ret], [_C_TYPES[t] for t in types])
    return out


@pytest.mark.parametrize("name,module", [("schedulers", "vqvae_tpu_torch.train.native_schedulers"),
                                         ("packio", "vqvae_tpu_torch.data.packed")])
def test_host_sources_keep_the_c_interface_their_loaders_bind(name, module):
    """Every function a loader binds is defined in the port's copy of the
    source with those types, and the copy defines the JAX package's
    ``csrc/`` functions with the same types."""
    import importlib
    signatures = importlib.import_module(module).SIGNATURES
    ours = _c_interface(PKG / "csrc" / f"{name}.cpp")
    assert {k: ours[k] for k in signatures} == {
        k: (r, list(a)) for k, (r, a) in signatures.items()}
    assert ours == _c_interface(ROOT / "csrc" / f"{name}.cpp")


_EXPORT = """
import runpy, sys
runpy.run_path("tools/export_jax_checkpoint.py")["main"](sys.argv[1:])
print(sorted(m for m in ("torch", "vqvae_tpu_torch") if m in sys.modules))
"""


def test_jax_export_tool_loads_no_torch(tmp_path):
    """The first step of bringing in a JAX snapshot runs where JAX is
    installed: it reads an orbax snapshot and writes its ``.npz`` without
    loading torch or the port."""
    import numpy as np

    from vqvae_tpu.utils.checkpoint import save_eval_checkpoint
    params = {"encoder": {"conv_in": {"Conv_0": {"kernel": np.ones((3, 3, 3, 4), np.float32)}}}}
    save_eval_checkpoint(str(tmp_path / "snap"), {"params": params}, step=3)
    out = subprocess.run([sys.executable, "-c", _EXPORT, "--loading_path",
                          str(tmp_path / "snap"), "--output", str(tmp_path / "snap.npz")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    with np.load(tmp_path / "snap.npz") as f:
        assert sorted(f.files) == ["params/encoder/conv_in/Conv_0/kernel", "step"]
        assert int(f["step"]) == 3


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout



@pytest.mark.parametrize("name,kind", [
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw", "conv gemm"),
    ("void DSE::regular_fft_pad<0, 1, 256, 16, 16, 1, float>", "conv fft"),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>", "conv fft"),
    ("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>", "conv layout"),
    ("nearest_codes_kernel(float const*, float const*)", "B1 nearest_codes"),
    ("(anonymous namespace)::nearest_codes_stats_assign_kernel(float const*)",
     "B2 nearest_codes_stats"),
    ("(anonymous namespace)::nearest_codes_stats_sum_kernel(float const*, int const*)",
     "B2 nearest_codes_stats"),
    ("sm90_xmma_wgrad_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc", "conv wgrad"),
    ("void cudnn::engines_precompiled::wgrad_alg0_engine<float, 128, 6>", "conv wgrad"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv dgrad"),
    ("void cudnn::cnn::dgrad2d_grouped_direct_kernel<float>", "conv dgrad"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<FusedAdamW>",
     "optimizer"),
    ("void at::native::reduce_kernel<512, 1>", "reduce"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("void at::native::avg_pool2d_out_cuda_frame<float, float>", "other"),
    ("void (anonymous namespace)::blur_t_gate_kernel<float>(float const*)", "B3 blur_t_gate"),
    ("void (anonymous namespace)::blur_t_gate_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*)",
     "B3 blur_t_gate"),
    ("void (anonymous namespace)::skip_fanout_bwd_kernel<float, 1>(float const*)",
     "B4 skip_fanout_bwd"),
    ("void (anonymous namespace)::skip_fanout_bwd_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
     "B4 skip_fanout_bwd"),
])
def test_profiler_kinds(name, kind):
    from vqvae_tpu_torch.profile_tokenizer import kind_of
    assert kind_of(name) == kind


def test_profiler_busy_time_is_the_union_of_kernel_intervals():
    from vqvae_tpu_torch.profile_tokenizer import busy_ms
    # two kernels side by side (0-400 and 100-300 us), a gap, then one more
    assert busy_ms([(100, 300), (0, 400), (1000, 1500)]) == 0.9
    assert busy_ms([]) == 0.0
