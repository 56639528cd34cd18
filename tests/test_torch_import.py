"""The PyTorch port stands apart from JAX: importing it and every submodule
loads no jax / flax / optax, ``chip_smoke.py`` refuses to run without a
GPU, and the profiler sorts kernel names into the kinds it reports.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "vqvae_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vqvae_tpu_torch
names = [m.name for m in pkgutil.walk_packages(vqvae_tpu_torch.__path__, "vqvae_tpu_torch.")]
for name in names:
    importlib.import_module(name)
cfg = vqvae_tpu_torch.load_config("example_confs/standard_vqvae.yaml")
assert vqvae_tpu_torch.VQVAE.__name__ == "VQVAE" and cfg.latent_size == 16
loaded = sorted(m for m in ("jax", "flax", "optax") if m in sys.modules)
print(len(names), loaded)
"""


def test_import_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, loaded = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 10
    assert loaded.strip() == "[]"


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern.search(f.read_text())]
    assert offenders == []
    # the smoke script reaches the shared config only through the port
    jax_pkg = re.compile(r"^\s*(import|from)\s+vqvae_tpu(\.|\s)", re.M)
    assert not jax_pkg.search((ROOT / "chip_smoke.py").read_text())


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
    ("void at::native::reduce_kernel<512, 1>", "reduce"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("void at::native::avg_pool2d_out_cuda_frame<float, float>", "other"),
])
def test_profiler_kinds(name, kind):
    from vqvae_tpu_torch.profile_tokenizer import kind_of
    assert kind_of(name) == kind
