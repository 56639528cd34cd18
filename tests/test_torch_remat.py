"""Rematerialization and the auto-remat gate of the PyTorch port against the
JAX package on the CPU (counterpart of ``tests/test_remat.py``):

- ``Encoder`` / ``Decoder`` / ``Discriminator`` with ``remat=True`` against
  the same module without it (forward bitwise equal in fp32, gradients
  within 1e-6) and against the JAX module with ``remat=True`` and the same
  weights (forward rtol 1e-4 / atol 1e-5 as ``test_torch_autoencoder``,
  gradients rtol 1e-4 / atol 1e-5 of each tensor's largest entry, 1e-4 of
  the module's for the autoencoder's, whose pool and upsample the JAX
  modules fold into other convolutions); the R1
  penalty and its second-order D gradients through checkpointed blocks
  against ``jax.grad`` of the JAX package's ``r1_penalty`` (rtol 1e-4);
- ``state_dict`` keys that do not depend on ``remat``, and eval / serving
  calls that do not checkpoint;
- ``estimate_activation_gb`` equal to JAX's on a grid, given JAX's 40 bytes
  per pixel x channel, and linear in the port's constant;
- the ``Trainer``'s auto decision equal to JAX's under a patched
  ``device_hbm_gb``, with and without ``per_device_batch``, and handed to
  the models it builds;
- ``check_remat_gate``'s messages equal to JAX's in its three cases (near
  OOM, wasteful, silent) under patched memory readers;
- a 4-step tiny GAN run (R1 on the first step) with remat on equal to
  remat off, port only; ``run_training`` audits the gate once, after its
  first step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_autoencoder import numpy_params
from test_torch_train_gan import RAW as GAN_RAW
from vqvae_tpu import config as jconfig
from vqvae_tpu.losses.losses import r1_penalty
from vqvae_tpu.models import autoencoder as jae
from vqvae_tpu.models import discriminator as jd
from vqvae_tpu.train import loop as jloop
from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.models import autoencoder as tae
from vqvae_tpu_torch.models import discriminator as td
from vqvae_tpu_torch.models.vqvae import VQVAE
from vqvae_tpu_torch.train import loop
from vqvae_tpu_torch.utils import convert

torch.set_num_threads(2)

CH, NRB, MULT, EDIM = 32, 1, (1, 2), 8
RTOL, ATOL = 1e-4, 1e-5
JAX_BYTES_PER_PIXEL_CHANNEL = 40.0   # the constant inside vqvae_tpu/train/loop.py:73


def _grads_close(got: dict, want: dict, module_share: float = 0.0) -> None:
    """rtol 1e-4, atol 1e-5 of each tensor's largest entry, that at least 1e-3
    of the module's, or ``module_share`` of the module's largest entry if
    that is larger (a bias just before a GroupNorm has a gradient that is 0
    but for rounding: a sum of terms that cancel, whose order differs)."""
    assert set(got) == set(want)
    largest = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        w = np.asarray(w)
        atol = max(ATOL * max(np.abs(w).max(), 1e-3 * largest), module_share * largest)
        np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=atol, err_msg=name)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _autoencoder(kind: str):
    """-> (JAX module factory, port module factory, weight map, input NHWC)."""
    if kind == "encoder":
        return (lambda r: jae.Encoder(channels=CH, num_res_blocks=NRB, channel_multipliers=MULT,
                                      embedding_dim=EDIM, remat=r),
                lambda r: tae.Encoder(CH, NRB, MULT, EDIM, remat=r),
                lambda p: convert.convert_encoder(p, NRB, len(MULT), prefix=""),
                np.random.RandomState(8).randn(2, 16, 16, 3).astype(np.float32))
    return (lambda r: jae.Decoder(channels=CH, num_res_blocks=NRB, channel_multipliers=MULT,
                                  embedding_dim=EDIM, remat=r),
            lambda r: tae.Decoder(CH, NRB, MULT, EDIM, remat=r),
            lambda p: convert.convert_decoder(p, NRB, len(MULT), prefix=""),
            np.random.RandomState(10).randn(2, 4, 4, EDIM).astype(np.float32))


def _port_run(module, x_nhwc):
    """Forward (NHWC out) and the gradients of sum(y^2) by parameter name."""
    y = module(_nchw(x_nhwc))
    (y.square()).sum().backward()
    return (y.detach().permute(0, 2, 3, 1).numpy(),
            {k: p.grad.numpy() for k, p in module.named_parameters()})


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_autoencoder_remat_matches_plain_and_jax(kind):
    jax_module, port_module, to_torch, x = _autoencoder(kind)
    # nn.remat keeps the parameter paths: the plain module's init is the tree
    params = numpy_params(jax.jit(jax_module(False).init)(jax.random.PRNGKey(0),
                                                          jnp.asarray(x)), seed=9)["params"]
    state = to_torch(params)
    runs = {}
    for remat in (False, True):
        module = port_module(remat)
        module.load_state_dict(state, strict=True)
        runs[remat] = _port_run(module, x)
    (y0, g0), (y1, g1) = runs[False], runs[True]
    np.testing.assert_array_equal(y1, y0)
    for name in g0:
        np.testing.assert_allclose(g1[name], g0[name], rtol=0, atol=1e-6, err_msg=name)

    module = jax_module(True)
    want_y = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    want_g = jax.jit(jax.grad(lambda p: jnp.sum(module.apply({"params": p}, jnp.asarray(x))
                                                ** 2)))(params)
    np.testing.assert_allclose(y1, want_y, rtol=RTOL, atol=ATOL)
    # the JAX decoder's upsample is an lhs-dilated conv: another order of sums
    _grads_close(g1, {k: v.numpy() for k, v in to_torch(jax.device_get(want_g)).items()},
                 module_share=1e-4)


def _jax_disc(res, base, seed):
    module = jd.Discriminator(img_resolution=res, channel_base=base, remat=True)
    plain = jd.Discriminator(img_resolution=res, channel_base=base)
    params = jax.jit(plain.init)(jax.random.PRNGKey(seed), jnp.zeros((4, res, res, 3)))["params"]
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (0.1 * rs.randn(*p.shape) if path[-1].key == "bias"
                         else np.asarray(p)).astype(np.float32), jax.device_get(params))
    return module, params


def _port_disc(res, base, params, remat, **kw):
    disc = td.Discriminator(res, channel_base=base, device="cpu", remat=remat, **kw)
    disc.load_state_dict(convert.convert_discriminator_params(params), strict=True)
    return disc


@pytest.fixture(scope="module")
def jax_disc_grads():
    """The JAX ``Discriminator(remat=True)`` at 16^2 (channel_base 256): its
    params, a batch, the logits and the parameter gradients of a weighted
    logit sum."""
    res, base = 16, 256
    module, params = _jax_disc(res, base, seed=3)
    x = np.random.RandomState(7).uniform(-1, 1, (8, res, res, 3)).astype(np.float32)
    weights = jnp.arange(1.0, 9.0)[:, None]
    logits = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    grads = jax.jit(jax.grad(lambda p: jnp.sum(module.apply({"params": p}, jnp.asarray(x))
                                               * weights)))(params)
    return res, base, params, x, logits, {
        k: v.numpy() for k, v in convert.convert_discriminator_params(
            jax.device_get(grads)).items()}


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_discriminator_remat_matches_plain_and_jax(fused, jax_disc_grads):
    res, base, params, x, want, want_gp = jax_disc_grads
    runs = {}
    for remat in (False, True):
        disc = _port_disc(res, base, params, remat, fused_dbwd=fused, fused_skip=fused)
        img = _nchw(x).requires_grad_(True)
        logits = disc(img)
        (logits * torch.arange(1.0, 9.0)[:, None]).sum().backward()
        runs[remat] = (logits.detach().numpy(), img.grad.numpy(),
                       {k: p.grad.numpy() for k, p in disc.named_parameters()})
    (l0, gx0, gp0), (l1, gx1, gp1) = runs[False], runs[True]
    np.testing.assert_array_equal(l1, l0)
    np.testing.assert_allclose(gx1, gx0, rtol=0, atol=1e-6)
    for name in gp0:
        np.testing.assert_allclose(gp1[name], gp0[name], rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(l1, want, rtol=1e-5, atol=1e-5)
    _grads_close(gp1, want_gp)


def test_r1_through_remat_blocks_matches_plain_and_jax():
    """The R1 step's path (``autograd.grad(create_graph=True)`` through the
    plain D, then ``backward(inputs=d_params)``) through checkpointed blocks:
    the penalty and every D gradient equal the uncheckpointed module's and
    ``jax.grad`` of the JAX ``r1_penalty`` on ``Discriminator(remat=True)``."""
    res, base = 16, 256
    module, params = _jax_disc(res, base, seed=4)
    x = np.random.RandomState(9).uniform(-1, 1, (8, res, res, 3)).astype(np.float32)
    want, want_g = jax.jit(jax.value_and_grad(lambda p: r1_penalty(
        lambda q, im: module.apply({"params": q}, im), p, jnp.asarray(x), 10.0)))(params)
    want_sd = {k: v.numpy() for k, v in
               convert.convert_discriminator_params(jax.device_get(want_g)).items()}
    runs = {}
    for remat in (False, True):
        disc = _port_disc(res, base, params, remat, fused_dbwd=True, fused_skip=True)
        img = _nchw(x).requires_grad_(True)
        (g,) = torch.autograd.grad(disc(img, fused=False).sum(), img, create_graph=True)
        r1 = 10.0 * g.square().reshape(8, -1).sum(1).mean()
        r1.backward(inputs=list(disc.parameters()))
        runs[remat] = (float(r1.detach()),
                       {k: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
                        for k, p in disc.named_parameters()})
    assert runs[True][0] == runs[False][0]
    for name, g in runs[False][1].items():
        np.testing.assert_allclose(runs[True][1][name], g, rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(runs[True][0], float(want), rtol=1e-4)
    _grads_close(runs[True][1], want_sd)


def _cfg_raw(size=16, channels=CH, nrb=NRB, loss="none", accum=1, q_type="standard"):
    raw = {
        "image_size": size,
        "autoencoder": {"channels": channels, "num_res_blocks": nrb,
                        "channel_multipliers": list(MULT)},
        "quantizer": {"num_embeddings": 32, "embedding_dim": EDIM, "type": q_type,
                      "reinit_every_n_epochs": None, "params": {"commitment_cost": 0.25}},
        "training": {"cumulative_bs": 8, "grad_accum_steps": accum, "base_lr": 1e-4,
                     "betas": [0.0, 0.99], "eps": 1e-8, "weight_decay": 1e-4,
                     "decay_epochs": 2, "max_epochs": 2},
    }
    if q_type == "ema":
        raw["quantizer"]["params"].update(decay=0.95, epsilon=1e-5)
    if loss != "none":
        raw["loss"] = {"l1_weight": 0.8, "l2_weight": 0.2, "perc_weight": 1.0}
        if loss == "gan":
            raw["loss"]["adversarial_params"] = dict(GAN_RAW["loss"]["adversarial_params"])
    return raw


def test_state_dict_keys_do_not_depend_on_remat():
    cfg = parse_config(_cfg_raw(q_type="ema"))
    keys = [list(VQVAE.from_config(cfg, device="cpu", remat=r).state_dict()) for r in (0, 1)]
    assert keys[0] == keys[1]
    keys = [list(td.Discriminator(16, channel_base=256, device="cpu", remat=bool(r))
                 .state_dict()) for r in (0, 1)]
    assert keys[0] == keys[1]


def test_eval_and_serving_do_not_checkpoint(monkeypatch):
    """Under ``inference_mode`` (the tokenizer API) and ``no_grad`` the blocks
    run their plain forward: no checkpoint is taken."""
    cfg = parse_config(_cfg_raw())
    model = VQVAE.from_config(cfg, device="cpu", remat=True,
                              generator=torch.Generator().manual_seed(0))
    calls = []
    real = tae.checkpoint
    monkeypatch.setattr(tae, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    images = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    tokens = model.get_tokens(images)
    model.reconstruct(images)
    model.reconstruct_from_tokens(tokens)
    with torch.no_grad():
        model(images * 2 - 1)
    assert calls == []
    model(images * 2 - 1)[0].sum().backward()
    n_blocks = sum(isinstance(m, tae.ResBlock) for m in model.modules())
    assert len(calls) == n_blocks == 2 * (NRB * len(MULT) + NRB)


@pytest.mark.parametrize("loss", ["none", "nogan", "gan"])
@pytest.mark.parametrize("accum", [1, 4])
def test_estimate_equals_jax(loss, accum, monkeypatch):
    monkeypatch.setattr(loop, "ACTIVATION_BYTES_PER_PIXEL_CHANNEL", JAX_BYTES_PER_PIXEL_CHANNEL)
    for size in (16, 256, 512):
        for channels in (32, 128):
            for nrb in (1, 2, 3):
                raw = _cfg_raw(size, channels, nrb, loss, accum)
                jcfg, cfg = jconfig.parse_config(raw), parse_config(raw)
                for batch in (4, 8, 32, 256):
                    want = jloop.estimate_activation_gb(jcfg, batch)
                    assert loop.estimate_activation_gb(cfg, batch) == pytest.approx(want,
                                                                                    rel=1e-12)


def test_estimate_is_linear_in_the_constant():
    cfg = parse_config(_cfg_raw(256, 128, 2, "gan"))
    want = jloop.estimate_activation_gb(jconfig.parse_config(_cfg_raw(256, 128, 2, "gan")), 32)
    got = loop.estimate_activation_gb(cfg, 32)
    assert got == pytest.approx(want * loop.ACTIVATION_BYTES_PER_PIXEL_CHANNEL
                                / JAX_BYTES_PER_PIXEL_CHANNEL, rel=1e-12)


@pytest.mark.parametrize("hbm_gb,size,batch", [
    (16.0, 16, 8), (1e-9, 16, 8), (16.0, 16, None), (16.0, 128, None), (1e-9, 128, 64),
    (80.0, 256, 32), (80.0, 256, 256),
])
def test_auto_decision_equals_jax(hbm_gb, size, batch, monkeypatch):
    monkeypatch.setattr(jloop, "device_hbm_gb", lambda: hbm_gb)
    monkeypatch.setattr(loop, "device_hbm_gb", lambda device: hbm_gb)
    monkeypatch.setattr(loop, "ACTIVATION_BYTES_PER_PIXEL_CHANNEL", JAX_BYTES_PER_PIXEL_CHANNEL)
    raw = _cfg_raw(size)
    want = jloop.Trainer(cfg=jconfig.parse_config(raw), learning_rate=1e-4, seed=0,
                         steps_per_epoch=1, per_device_batch=batch)
    got = loop.Trainer(cfg=parse_config(raw), learning_rate=1e-4, seed=0, steps_per_epoch=1,
                       device="cpu", per_device_batch=batch)
    assert got.remat is want.remat and got._remat_auto and want._remat_auto
    for remat in (False, True):   # the caller's decision stands
        assert loop.Trainer(cfg=parse_config(raw), learning_rate=1e-4, seed=0,
                            steps_per_epoch=1, device="cpu", remat=remat,
                            per_device_batch=batch).remat is remat


def test_decision_reaches_the_models(monkeypatch):
    monkeypatch.setattr(loop, "device_hbm_gb", lambda device: 1e-9)
    raw = _cfg_raw(loss="gan")
    raw["loss"]["perc_weight"] = 0.0   # no LPIPS: the D is what matters here
    trainer = loop.Trainer(cfg=parse_config(raw), learning_rate=1e-4, seed=0,
                           steps_per_epoch=1, device="cpu", per_device_batch=8,
                           disc_kwargs={"channel_base": 256})
    assert trainer.remat is True
    state = trainer.init_state()
    blocks = [m for m in state.model.modules() if isinstance(m, tae.ResBlock)]
    d_blocks = [m for m in state.disc.modules() if isinstance(m, td.DiscriminatorBlock)]
    assert blocks and d_blocks and all(m.remat for m in blocks + d_blocks)
    assert trainer.check_remat_gate() is None   # no statistics off the card


class _FakeDev:
    def __init__(self, peak, limit):
        self._stats = {"peak_bytes_in_use": peak, "bytes_limit": limit}

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("remat,peak,limit,words", [
    (False, 15.2e9, 16.0e9, ("OOM", "under-estimated")),        # near OOM
    (True, 4.0e9, 16.0e9, ("recompute", "over-estimated")),     # wasteful
    (False, 10.0e9, 16.0e9, None),                              # comfortable: silent
    (True, 12.0e9, 16.0e9, None),
    (False, 73.0e9, 79.0e9, ("OOM",)),
])
def test_gate_messages_equal_jax(remat, peak, limit, words, monkeypatch):
    raw = _cfg_raw()
    jt = jloop.Trainer(cfg=jconfig.parse_config(raw), learning_rate=1e-4, seed=0,
                       steps_per_epoch=1, per_device_batch=8)
    pt = loop.Trainer(cfg=parse_config(raw), learning_rate=1e-4, seed=0, steps_per_epoch=1,
                      device="cpu", per_device_batch=8)
    jt.remat = pt.remat = remat   # as if the estimate had decided so
    monkeypatch.setattr(jax, "local_devices", lambda: [_FakeDev(peak, limit)])
    monkeypatch.setattr(loop, "memory_peak_and_total", lambda device: (peak, limit))
    want = jt.check_remat_gate(verbose=False)
    got = pt.check_remat_gate(verbose=False)
    assert got == want
    assert (got is None) == (words is None)
    assert words is None or all(w in got for w in words)


def test_gate_is_silent_for_a_callers_decision_and_without_statistics(monkeypatch):
    raw = _cfg_raw()
    explicit = loop.Trainer(cfg=parse_config(raw), learning_rate=1e-4, seed=0,
                            steps_per_epoch=1, device="cpu", remat=False)
    monkeypatch.setattr(loop, "memory_peak_and_total", lambda device: (15.9e9, 16.0e9))
    assert explicit.check_remat_gate(verbose=False) is None
    auto = loop.Trainer(cfg=parse_config(raw), learning_rate=1e-4, seed=0, steps_per_epoch=1,
                        device="cpu", per_device_batch=8)
    monkeypatch.setattr(loop, "memory_peak_and_total", lambda device: None)
    assert auto.check_remat_gate(verbose=False) is None
    monkeypatch.undo()
    assert loop.memory_peak_and_total(torch.device("cpu")) is None
    assert loop.device_hbm_gb(torch.device("cpu")) == jloop.device_hbm_gb() == 16.0


def test_tiny_gan_run_with_remat_equals_without(monkeypatch, tmp_path):
    """4 steps of the tiny GAN (R1 on host step 0, ``r1_reg_every`` 4), the D's
    backward fused, from one seed: every metric, parameter and D parameter
    equal with remat on and off."""
    monkeypatch.setenv("VQVAE_TPU_LPIPS_WEIGHTS_DIR", str(tmp_path))
    cfg = parse_config(GAN_RAW)
    images = torch.rand(8, 16, 16, 3, generator=torch.Generator().manual_seed(5))
    runs = {}
    for remat in (False, True):
        with pytest.warns(UserWarning, match="LPIPS"):
            trainer = loop.Trainer(cfg=cfg, learning_rate=1e-4, seed=0, steps_per_epoch=100,
                                   device="cpu", augment=False, remat=remat, fused_dbwd=True,
                                   fused_skip=True, disc_kwargs={"channel_base": 256})
        state = trainer.init_state()
        history = []
        for _ in range(4):
            _, metrics = trainer.train_step(state, {"image": images}, epoch=0)
            history.append({k: float(v) for k, v in metrics.items()})
        runs[remat] = (history, dict(state.model.state_dict()), dict(state.disc.state_dict()))
    (h0, m0, d0), (h1, m1, d1) = runs[False], runs[True]
    assert [m["r1_penalty"] > 0 for m in h1] == [True, False, False, False]
    assert h1 == h0
    for name in m0:
        assert torch.equal(m1[name], m0[name]), name
    for name in d0:
        assert torch.equal(d1[name], d0[name]), name


def test_run_training_audits_the_gate_after_the_first_step(monkeypatch, tmp_path):
    """``run_training`` hands the per-rank batch to the Trainer and calls
    ``check_remat_gate`` once, after the first step of the first epoch."""
    from vqvae_tpu_torch.data.dataset import get_loaders
    from PIL import Image

    root = tmp_path / "data"
    rs = np.random.RandomState(0)
    for split in ("train", "validation"):
        (root / split).mkdir(parents=True)
        for i in range(8):
            Image.fromarray(rs.randint(0, 256, (16, 16, 3)).astype(np.uint8)).save(
                root / split / f"i{i}.png")
    cfg = parse_config(_cfg_raw())
    events = []
    real_step, real_gate = loop.Trainer.train_step, loop.Trainer.check_remat_gate
    monkeypatch.setattr(loop.Trainer, "train_step",
                        lambda self, *a: events.append("step") or real_step(self, *a))
    monkeypatch.setattr(loop.Trainer, "check_remat_gate",
                        lambda self, **k: events.append(("gate", self.per_device_batch,
                                                         self._remat_auto))
                        or real_gate(self, **k))
    train, val = get_loaders("standard", str(root), 16, 4, 0, 0)
    _, trainer = loop.run_training(cfg, train, val, seed=0, learning_rate=1e-4,
                                   save_dir=str(tmp_path / "ckpt"), run_name="r",
                                   max_epochs=2, device="cpu")
    assert events == ["step", ("gate", 4, True), "step", "step", "step"]
    assert trainer.remat is False
