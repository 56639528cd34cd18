"""Today's configurations, pinned: what the benchmark makes and counts for
``gumbel_vqgan`` and ``ema_vqvae`` equals what it made before the parts
that depend on the architecture moved behind each configuration's plain
reference (``reference.of``): the leaf names and shapes of every model at
full size and at the tiny size, the weights of the tiny configuration at
one seed on the CPU, the tiny configuration itself, and the FLOPs per
image of decoding, of a training step of 32 and, where the configuration
exports tokens, of token export (the gumbel reference has no nearest-code
export). The digests were recorded on the commit before that move; a
change to the harness that moves one of them changes the cells' inputs or
metrics, and has to say so by changing this file."""

from __future__ import annotations

import hashlib
import json

import pytest

from benchmark import flops, inputs
from benchmark.run import HERE
from benchmark.runtime import weight_specs
from benchmark.tests.tiny import tiny_config

SEED = 2 ** 31 + 29

PINNED = {
    "gumbel_vqgan": {
        "weight_specs": "df3ea8a47de38b5c0e798e8b255f27800d721bd10ec1409e194aa527ecfa8954",
        "tiny_weight_specs": "467a06be10c3c674d1daa4c6c6d198d79d322a3e60598b180a1aa6557ea3e97b",
        "tiny_weights": "59a9840c908088ee3ca9ebe92804ddbeba5eb4a05d32aefb22ae22e5078a13b3",
        "tiny_config": "0e00813d65f210405759a71e77026e95a9747de8dee6f1a2e4e258d1dced4e2f",
        "detokenize_flops": 68132274176.0,
        "train_flops": 1562717745536.0,
    },
    "ema_vqvae": {
        "weight_specs": "3ce9c9a4b3a6c740ca0170d193212ebb1e0491481d699e1fb976839ff80d9643",
        "tiny_weight_specs": "94086d1a505d53a46679393a52d68cdccfbbce2c7bbeefae8486eda7748400fc",
        "tiny_weights": "69bad188b8dcb41de0a0e5dbd17852f35005e3e5b1ca1da278ea51b005204ddb",
        "tiny_config": "50719877bb90ff4fd1d1d3a1dce1b3c199150130c267c370b31438940392245a",
        "detokenize_flops": 68132274176.0,
        "train_flops": 768346161152.0,
        "tokenize_flops": 188424912896.0,
    },
}


def _json_digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def _weights_digest(weights: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(weights):
        t = weights[name].contiguous()
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype};".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def readings(name: str) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    tiny = tiny_config(name)
    specs = weight_specs(tiny)
    out = {
        "weight_specs": _json_digest(weight_specs(cfg)),
        "tiny_weight_specs": _json_digest(specs),
        "tiny_weights": _weights_digest(inputs.make_weights(specs, tiny, SEED, "cpu")),
        "tiny_config": _json_digest(tiny),
        "detokenize_flops": flops.detokenize_flops_per_image(cfg),
        "train_flops": flops.train_flops_per_image(cfg, 32),
    }
    if "tokenize_flops" in PINNED[name]:
        out["tokenize_flops"] = flops.tokenize_flops_per_image(cfg)
    return out


@pytest.mark.parametrize("name", sorted(PINNED))
def test_configuration_is_pinned(name):
    assert readings(name) == PINNED[name]
