"""The closed-form derivatives of the discriminator's convolutions
(``ops/upfirdn2d.py``: ``_FIRConv`` / ``_FIRConvT``; ``ops/conv2d_resample.py``:
``_Conv2d`` / ``_Conv2dInput`` / ``_Conv2dWeight``, ``no_weight_gradients``)
on the CPU:

- ``gradcheck`` and ``gradgradcheck`` of each Function in float64, at odd
  sides, strides 1 and 2 and asymmetric padding;
- the FIR's device filter made once, also when first made under
  ``inference_mode``;
- first- and second-order gradients of ``conv2d_resample`` through each of
  its branches, and of ``upfirdn2d``, equal to the plain autograd
  composition (``F.conv2d`` and autograd's own derivatives), float64, rtol
  1e-10;
- the R1 backward of a small port D (32^2, ``channel_base`` 2048, batch 4),
  profiled, with its blocks checkpointed and not: no
  ``aten::_convolution_double_backward``, no convolution whose weight operand
  is wider than the layer's kernel (4 x 4 at most) or whose batch is 1 (the
  parent's R1 pass ran 896 batch-1 per-channel convolutions and 8 with an
  image-sized kernel here); ``second_order.calls`` raised once per
  convolution and FIR by the R1 pass and never by a first-order pass; no
  weight gradient formed under ``no_weight_gradients``; the penalty and every
  D gradient equal the plain composition's (fp32, rtol 1e-4 / atol 1e-5 of
  each tensor's largest entry);
- ``profile_tokenizer.composite`` names the generic double backward's
  convolutions in the plain composition's R1 pass and finds none in the
  Functions';
- the GAN train step (adaptive lambda on, R1 every 2 steps) forms D weight
  gradients only in ``gan.d_real_backward`` and ``gan.d_fake_backward``:
  never under ``gan.r1_grad``, the adaptive lambda's gradients
  (``gan.d_fake``) or ``ae.backward``;
- on the card (``cuda``): the R1 gradients of a wider D against the plain
  composition in fp32 with TF32 off, and the profile's structure.
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F
from torch.autograd import gradcheck, gradgradcheck
from torch.profiler import ProfilerActivity, profile

from vqvae_tpu_torch.config import parse_config
from vqvae_tpu_torch.models.discriminator import Discriminator
from vqvae_tpu_torch.ops import conv2d_resample as cr
from vqvae_tpu_torch.ops import upfirdn2d as up
from vqvae_tpu_torch.train import steps
from vqvae_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

F64 = torch.float64
FILTER = up.setup_filter([1, 3, 3, 1])


@contextlib.contextmanager
def plain_composition(monkeypatch):
    """Within: ``_FIRConv`` and ``_Conv2d`` are the plain ``F.conv2d`` calls
    they wrap, which autograd differentiates with its own formulas."""
    with monkeypatch.context() as m:
        m.setattr(up._FIRConv, "apply", staticmethod(
            lambda x, w, stride: F.conv2d(x, w, stride=stride, groups=x.shape[1])))
        m.setattr(cr._Conv2d, "apply", staticmethod(
            lambda x, w, stride, padding: F.conv2d(x, w, stride=stride, padding=padding)))
        yield


def _randn(*shape, seed=0, dtype=F64):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed), dtype=dtype)


@pytest.mark.parametrize("kind,stride,padding", [
    ("fir", (1, 1), None), ("fir", (2, 2), None), ("fir", (1, 2), None),
    ("conv", (1, 1), (1, 1)), ("conv", (2, 2), (0, 0)), ("conv", (2, 2), (1, 2)),
])
def test_functions_pass_gradcheck_and_gradgradcheck(kind, stride, padding):
    x = _randn(2, 3, 7, 6, seed=1).requires_grad_(True)
    if kind == "fir":
        w = torch.from_numpy(FILTER).to(F64)[None, None].expand(3, 1, 4, 4)
        y = up._FIRConv.apply(x, w, stride).detach().requires_grad_(True)
        cases = [(lambda x: up._FIRConv.apply(x, w, stride), (x,)),
                 (lambda y: up._FIRConvT.apply(y, w, stride, x.shape), (y,))]
    else:
        w = _randn(5, 3, 3, 3, seed=2).requires_grad_(True)
        dy = cr._Conv2d.apply(x, w, stride, padding).detach().requires_grad_(True)
        cases = [(lambda x, w: cr._Conv2d.apply(x, w, stride, padding), (x, w)),
                 (lambda dy, w: cr._Conv2dInput.apply(dy, w, x.shape, stride, padding), (dy, w)),
                 (lambda x, dy: cr._Conv2dWeight.apply(x, dy, w.shape, stride, padding),
                  (x, dy))]
    for fn, inputs in cases:
        assert gradcheck(fn, inputs)
        assert gradgradcheck(fn, inputs)


def _orders(fn, x, w):
    """First- and second-order gradients through ``fn(x, w)``: of
    ``L = sum(y^2 r)`` toward x (and w), then of ``|dL/dx|^2 + <dL/dw, v>``."""
    y = fn(x, w)
    r = _randn(*y.shape, seed=3)
    wanted = (x,) if w is None else (x, w)
    first = torch.autograd.grad((y.square() * r).sum(), wanted, create_graph=True)
    s = first[0].square().sum()
    if w is not None:
        s = s + (first[1] * _randn(*w.shape, seed=4)).sum()
    second = torch.autograd.grad(s, wanted)
    return [t.detach() for t in (y,) + first + second]


# (what, kw): conv2d_resample's branches, then upfirdn2d alone
ORDER_CASES = [
    ("resample", dict(k=1, up=1, down=2, padding=0, flip_weight=True)),    # 1x1 + down
    ("resample", dict(k=1, up=2, down=1, padding=0, flip_weight=False)),   # 1x1 + up
    ("resample", dict(k=3, up=1, down=2, padding=1, flip_weight=True)),    # 3x3 + down
    ("resample", dict(k=3, up=1, down=1, padding=1, flip_weight=True)),    # plain 3x3
    ("resample", dict(k=3, up=2, down=1, padding=1, flip_weight=False)),   # generic, up
    ("resample", dict(k=3, up=2, down=2, padding=1, flip_weight=False, flip_filter=True)),
    ("resample", dict(k=3, up=1, down=1, padding=-1, flip_weight=True)),   # generic, crop
    ("resample", dict(k=3, up=1, down=2, padding=1, flip_weight=False, flip_filter=True)),
    ("fir", dict(up=2, padding=(2, 1, 2, 1))),
    ("fir", dict(down=2, padding=(1, -1, 2, 0), flip_filter=True)),
    ("fir", dict(up=(2, 1), down=(1, 2), padding=(0, 1, 1, 0), gain=3.0)),
]


@pytest.mark.parametrize("what,kw", ORDER_CASES,
                         ids=[f"{w}-{i}" for i, (w, _) in enumerate(ORDER_CASES)])
def test_first_and_second_order_match_plain_autograd(monkeypatch, what, kw):
    x = _randn(2, 4, 9, 8, seed=5).requires_grad_(True)
    if what == "resample":
        kw = dict(kw)
        k = kw.pop("k")
        w = _randn(5, 4, k, k, seed=6).requires_grad_(True)

        def fn(x, w):
            return cr.conv2d_resample(x, w, f=FILTER, **kw)
    else:
        w = None

        def fn(x, w):
            return up.upfirdn2d(x, FILTER, **kw)

    before = up.second_order.calls
    got = _orders(fn, x, w)
    assert up.second_order.calls > before
    with plain_composition(monkeypatch):
        want = _orders(fn, x, w)
    for g, t in zip(got, want):
        torch.testing.assert_close(g, t, rtol=1e-10, atol=1e-12 * float(t.abs().max()))


def test_filter_made_under_inference_mode_serves_training():
    """The FIR's device filter is made once per filter, dtype and device;
    made first under ``inference_mode`` (an eval step), it still serves a
    training step's backward."""
    f = up.setup_filter([1, 2, 2, 1])
    x = _randn(2, 3, 6, 6, seed=7, dtype=torch.float32)
    with torch.inference_mode():
        want = up.upfirdn2d(x, f, down=2, padding=1)
    xg = x.clone().requires_grad_(True)
    y = up.upfirdn2d(xg, f, down=2, padding=1)
    assert torch.equal(y.detach(), want)
    y.square().sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    made = up._filter_tensor.cache_info().currsize
    up.upfirdn2d(x, f, down=2, padding=1)
    assert up._filter_tensor.cache_info().currsize == made


def _conv_events(prof):
    """(batch, weight spatial shape) of every convolution the profile saw,
    forward or backward, from the recorded operand shapes."""
    out = []
    for e in prof.events():
        shapes = e.input_shapes
        if e.name in ("aten::convolution", "aten::_convolution") and len(shapes) > 1:
            out.append((shapes[0][0], tuple(shapes[1][2:])))
        elif e.name == "aten::convolution_backward" and len(shapes) > 2:
            out.append((shapes[0][0], tuple(shapes[2][2:])))
    return out


def _r1_backward(disc, img, wgrad=None):
    """The R1 step's D half as ``train/steps.py`` takes it: -> (penalty,
    D gradients, the ``wgrad`` calls made under the switch)."""
    real = img.clone().requires_grad_(True)
    logits = disc(real, fused=False)
    formed = wgrad.calls if wgrad else 0
    with cr.no_weight_gradients():
        (g,) = torch.autograd.grad(logits.sum(), real, create_graph=True)
    formed = (wgrad.calls if wgrad else 0) - formed
    penalty = 10.0 * g.square().reshape(g.shape[0], -1).sum(1).mean()
    params = list(disc.parameters())
    (F.softplus(-logits).mean() + penalty).backward(inputs=params)
    return penalty.detach(), {n: p.grad for n, p in disc.named_parameters()}, formed


@pytest.fixture
def counted_wgrad(monkeypatch):
    """``conv2d_resample._conv_backward``, the one call that forms a dense
    conv's weight gradient, with a count (``.calls``) of the calls that ask
    for one."""
    conv_backward = cr._conv_backward

    def counted(dy, x, w, conv, mask):
        counted.calls += mask[1]
        return conv_backward(dy, x, w, conv, mask)

    counted.calls = 0
    monkeypatch.setattr(cr, "_conv_backward", counted)
    return counted


@pytest.mark.parametrize("remat", [False, True], ids=["plain_blocks", "remat_blocks"])
def test_r1_backward_takes_only_layer_sized_convolutions(monkeypatch, counted_wgrad, remat):
    res, base, batch = 32, 2048, 4
    disc = Discriminator(res, channel_base=base, device="cpu", seed=3, remat=remat)
    img = torch.rand(batch, 3, res, res, generator=torch.Generator().manual_seed(8)) * 2 - 1
    n_blocks = len(disc.block_resolutions)
    n_convs = 3 * n_blocks + 2        # conv0, conv1, skip per block; fromrgb; the epilogue's
    n_firs = 2 * n_blocks             # conv1's and skip's FIRs

    calls = up.second_order.calls
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        penalty, grads, formed = _r1_backward(disc, img, counted_wgrad)
    assert up.second_order.calls - calls == n_convs + n_firs
    assert formed == 0
    names = {e.name for e in prof.events()}
    assert "aten::_convolution_double_backward" not in names
    convs = _conv_events(prof)
    assert len(convs) >= 3 * n_convs
    assert all(b == batch for b, _ in convs), sorted({b for b, _ in convs})
    assert all(max(k) <= 4 for _, k in convs), sorted({k for _, k in convs})

    # a first-order pass raises no second-order count
    disc.zero_grad(set_to_none=True)
    calls = up.second_order.calls
    disc(img).sum().backward()
    assert up.second_order.calls == calls

    with plain_composition(monkeypatch):
        plain = Discriminator(res, channel_base=base, device="cpu", seed=3)
        want_penalty, want, _ = _r1_backward(plain, img)
    torch.testing.assert_close(penalty, want_penalty, rtol=1e-5, atol=0)
    assert grads.keys() == want.keys()
    for name, t in want.items():
        if t is None:   # only the lrelu's branch mask depends on this bias
            assert grads[name] is None or not grads[name].any(), name
            continue
        torch.testing.assert_close(grads[name], t, rtol=1e-4,
                                   atol=1e-5 * float(t.abs().max()), msg=name)


def test_profile_composites_name_what_the_r1_pass_runs(monkeypatch):
    """``profile_tokenizer.composite`` (the ``r1`` part's split) finds the
    generic double backward's batch-1 and image-sized-weight convolutions
    in the plain composition's R1 pass, and none in the Functions'."""
    from vqvae_tpu_torch.profile_tokenizer import composite

    disc = Discriminator(16, channel_base=256, device="cpu", seed=5)
    img = torch.rand(4, 3, 16, 16, generator=torch.Generator().manual_seed(6))

    def labels():
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            _r1_backward(disc, img)
        return {composite(e) for e in prof.events() if e.name == "aten::_convolution"}

    new = labels()
    assert new and not any(k.startswith("double backward") for k in new), new
    with plain_composition(monkeypatch):
        old = labels()
    assert {"double backward: batch-1 per-channel convs",
            "double backward: image-sized weight convs"} <= old, old


GAN_RAW = {
    "image_size": 16,
    "autoencoder": {"channels": 32, "num_res_blocks": 1, "channel_multipliers": [1, 2]},
    "quantizer": {"type": "gumbel", "num_embeddings": 32, "embedding_dim": 8,
                  "reinit_every_n_epochs": None,
                  "params": {"straight_through": False, "temp": 1.0, "kl_cost": 0.00859375,
                             "kl_warmup_epochs": 0.48, "temp_decay_epochs": 15,
                             "temp_final": 0.0625}},
    "loss": {"l1_weight": 0.8, "l2_weight": 0.2, "perc_weight": 1.0,
             "adversarial_params": {"start_epoch": 0, "loss_type": "non-saturating",
                                    "g_weight": 0.1, "use_adaptive": True,
                                    "r1_reg_weight": 10.0, "r1_reg_every": 2}},
    "training": {"cumulative_bs": 8, "base_lr": 1e-4, "betas": [0.0, 0.99], "eps": 1e-8,
                 "weight_decay": 1e-4, "decay_epochs": 1, "max_epochs": 300},
}


def test_train_step_forms_d_weight_gradients_only_where_d_learns(monkeypatch, tmp_path):
    """Each dense conv weight gradient formed in the GAN step is counted
    under the phase span open around it: an R1 step forms each conv's
    twice in ``gan.d_real_backward`` (first and second order) and
    once in ``gan.d_fake_backward``; a plain step once in each; no other
    phase forms one."""
    monkeypatch.setenv("VQVAE_TPU_LPIPS_WEIGHTS_DIR", str(tmp_path))
    phases, formed = [], {}

    @contextlib.contextmanager
    def scope(name, **attrs):
        phases.append(name)
        try:
            yield
        finally:
            phases.pop()

    conv_backward = cr._conv_backward

    def counted(dy, x, w, conv, mask):
        if mask[1]:
            key = (len(records), phases[-1] if phases else None)
            formed[key] = formed.get(key, 0) + 1
        return conv_backward(dy, x, w, conv, mask)

    monkeypatch.setattr(steps, "named_scope", scope)
    monkeypatch.setattr(cr, "_conv_backward", counted)
    with pytest.warns(UserWarning, match="LPIPS"):
        trainer = Trainer(cfg=parse_config(GAN_RAW), learning_rate=1e-4, seed=0,
                          steps_per_epoch=100, device="cpu", augment=False,
                          disc_kwargs={"channel_base": 256})
    state = trainer.init_state()
    images = torch.rand(8, 16, 16, 3, generator=torch.Generator().manual_seed(5))
    records = []
    for _ in range(2):
        calls = up.second_order.calls
        _, metrics = trainer.train_step(state, {"image": images}, epoch=0)
        records.append((float(metrics["r1_penalty"]) > 0, up.second_order.calls - calls))
    assert [r1 for r1, _ in records] == [True, False]
    assert records[0][1] > 0 and records[1][1] == 0
    n_convs = 3 * len(state.disc.block_resolutions) + 2
    assert formed == {(0, "gan.d_real_backward"): 2 * n_convs,
                      (0, "gan.d_fake_backward"): n_convs,
                      (1, "gan.d_real_backward"): n_convs,
                      (1, "gan.d_fake_backward"): n_convs}


@pytest.mark.cuda
def test_r1_gradients_match_plain_composition_on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    res, base, batch = 64, 16384, 8
    img = (torch.rand(batch, 3, res, res, generator=torch.Generator().manual_seed(9)) * 2
           - 1).cuda()
    disc = Discriminator(res, channel_base=base, device="cuda", seed=4)
    calls = up.second_order.calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        penalty, grads, _ = _r1_backward(disc, img)
        torch.cuda.synchronize()
    n_blocks = len(disc.block_resolutions)
    assert up.second_order.calls - calls == (3 * n_blocks + 2) + 2 * n_blocks
    assert "aten::_convolution_double_backward" not in {e.name for e in prof.events()}
    convs = _conv_events(prof)
    assert all(b == batch for b, _ in convs) and all(max(k) <= 4 for _, k in convs)
    with plain_composition(monkeypatch):
        plain = Discriminator(res, channel_base=base, device="cuda", seed=4)
        want_penalty, want, _ = _r1_backward(plain, img)
    torch.testing.assert_close(penalty, want_penalty, rtol=1e-4, atol=0)
    for name, t in want.items():
        if t is None:
            continue
        torch.testing.assert_close(grads[name], t, rtol=1e-3,
                                   atol=1e-4 * float(t.abs().max()), msg=name)
