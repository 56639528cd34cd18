"""The port's FID InceptionV3 against ``vqvae_tpu/eval/inception.py`` on the
CPU, from one seeded ``random_inception_npz`` that both sides load (each
through its own loader, so ``convert_inception_params`` is held too):

- ``random_inception_npz`` writes exactly the arrays of the fixture in
  ``tests/test_golden_rfid.py`` (the same keys, shapes and stream);
- pool3 features of a 2 x 96^2 x 3 input straight into the network, and of
  2 x 16^2 uint8 images through ``preprocess_fid_input`` (the resize to 299):
  within 1e-4 of the largest entry; the preprocessed input within 1e-6.
One module-scoped fixture, so JAX compiles each network once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae_tpu.eval import inception as jinc
from vqvae_tpu.models.lpips import _unflatten
from vqvae_tpu_torch.eval import inception as tinc
from vqvae_tpu_torch.utils.convert import convert_inception_params, random_inception_npz

torch.set_num_threads(4)

SHARE = 1e-4   # features: |port - jax| <= SHARE * max |jax|


def _golden_fixture_arrays(seed: int) -> dict:
    """The rule of ``tests/test_golden_rfid.py::inception_npz``, with the key
    list taken from the JAX module."""
    model = jinc.InceptionV3Pool3()
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 299, 299, 3))),
                            jax.random.PRNGKey(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes["params"])
    flat = {"/".join(k.key for k in path): leaf.shape for path, leaf in leaves}
    rs = np.random.RandomState(seed)
    out = {}
    for key in sorted(flat):
        shape = flat[key]
        if key.endswith("/kernel"):
            fan_in = int(np.prod(shape[:-1]))
            out[key] = np.asarray(rs.randn(*shape) * np.sqrt(2.0 / fan_in), np.float32)
        else:
            out[key] = np.asarray(rs.randn(*shape) * 0.1, np.float32)
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("inception") / "inception_fid.npz"
    random_inception_npz(path, seed=7)
    return path


@pytest.fixture(scope="module")
def models(weights):
    """(jax params, jax extractor, port extractor) on the same weights."""
    flat = dict(np.load(str(weights)))
    params = jax.tree.map(jnp.asarray, _unflatten(flat))
    return params, jinc.make_pool3_extractor(weights), tinc.make_pool3_extractor(weights, "cpu")


def test_random_weights_equal_the_golden_fixtures(weights):
    got = dict(np.load(str(weights)))
    want = _golden_fixture_arrays(7)
    assert sorted(got) == sorted(want) and len(got) == 188
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_converted_state_dict_is_the_modules(weights):
    sd = convert_inception_params(dict(np.load(str(weights))))
    module_sd = tinc.InceptionV3Pool3().state_dict()
    assert sd.keys() == module_sd.keys()
    assert all(sd[k].shape == module_sd[k].shape for k in sd)
    flat = dict(np.load(str(weights)))
    np.testing.assert_array_equal(sd["Mixed_7c.branch3x3_2a.conv.weight"].numpy(),
                                  flat["Mixed_7c/branch3x3_2a/conv/kernel"].transpose(3, 2, 0, 1))
    with pytest.raises(KeyError):
        convert_inception_params({"Mixed_5b/branch1x1/bn/scale": np.ones(3)})


def test_pool3_features_match_jax_on_a_direct_input(models):
    params, _, extract = models
    x = np.random.RandomState(0).uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jinc.InceptionV3Pool3().apply({"params": p}, x))(
        params, jnp.asarray(x)))
    with torch.inference_mode():
        got = extract.model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=SHARE * np.abs(want).max())
    assert np.abs(want).max() > 0


def test_pool3_features_match_jax_through_the_resize(models):
    _, jax_extract, extract = models
    images = np.random.RandomState(1).randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    want_x = np.asarray(jinc.preprocess_fid_input(jnp.asarray(images)))
    got_x = tinc.preprocess_fid_input(torch.from_numpy(images)).numpy()
    assert got_x.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got_x, want_x, rtol=0, atol=1e-6)
    want = np.asarray(jax_extract(images))
    got = extract(images)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=SHARE * np.abs(want).max())
    # the module's own pools: Mixed_7c's pool branch is a max pool, the others average
    assert (extract.model.Mixed_7c.pool_type, extract.model.Mixed_7b.pool_type) == ("max", "avg")
