"""The port's hand msgpack codec and `.dbt` reader and writer against
msgpack + flax."""

import dataclasses
import os

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from deepbinner_tpu.models.checkpoint import load_model as jax_load_model
from deepbinner_tpu_torch.models.checkpoint import (
    _config_to_json,
    from_flax_variables,
    load_model,
    msgpack_dumps,
    msgpack_loads,
    save_model,
    to_flax_variables,
)

DATA = os.path.join(os.path.dirname(__file__), "..", "deepbinner_tpu",
                    "models", "data")
MODELS = ["EXP-NBD103_read_starts.dbt", "EXP-NBD103_read_ends.dbt",
          "SQK-RBK004_read_starts.dbt", "TINY_dryrun.dbt"]


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert sorted(got) == sorted(want), path
        for key in want:
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
        return
    want = np.asarray(want)
    assert isinstance(got, np.ndarray), path
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("name", MODELS)
def test_decoder_matches_flax(name):
    import zipfile

    with zipfile.ZipFile(os.path.join(DATA, name)) as archive:
        raw = archive.read("params.msgpack")
    want = serialization.msgpack_restore(raw)
    got = msgpack_loads(raw)
    _assert_trees_equal(got, want)
    # Every leaf of the shipped models is flax's ndarray ext type.
    leaves = []

    def walk(node):
        for value in node.values():
            walk(value) if isinstance(value, dict) else leaves.append(value)

    walk(got)
    assert all(isinstance(leaf, np.ndarray) for leaf in leaves)


@pytest.mark.parametrize("name", MODELS)
def test_load_model_matches_jax(name):
    path = os.path.join(DATA, name)
    _model, variables, jax_cfg, jax_meta = jax_load_model(path)
    model, cfg, meta = load_model(path)
    jax_fields = dataclasses.asdict(jax_cfg)
    jax_fields.pop("compute_dtype")
    assert dataclasses.asdict(cfg) == jax_fields
    assert meta == jax_meta
    state = model.state_dict()
    want = from_flax_variables(cfg, variables)
    assert sorted(state) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(state[key].numpy(), value.numpy(),
                                      err_msg=key)


@pytest.mark.parametrize("value", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 - 1,
    -1, -32, -33, -128, -129, -32768, -2 ** 31 - 1, -2 ** 63,
    0.5, -1e300, True, False, None,
    "", "x" * 31, "y" * 32, "z" * 300, "ü" * 40000,
    b"", b"\x00" * 300, b"\x01" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(17)},
    {"nested": {"a": [1, {"b": b"c"}]}},
])
def test_decoder_matches_msgpack(value):
    assert msgpack_loads(msgpack.packb(value, use_bin_type=True)) == value


def test_decoder_float32():
    packed = msgpack.packb(1.5, use_single_float=True)
    assert packed[0] == 0xCA
    assert msgpack_loads(packed) == 1.5


@pytest.mark.parametrize("data", [b"\x92\x01", b"\xc1", b"\x01\x02"])
def test_decoder_rejects_malformed(data):
    with pytest.raises(ValueError):
        msgpack_loads(data)


def test_decoder_rejects_unknown_ext():
    with pytest.raises(ValueError):
        msgpack_loads(msgpack.packb(msgpack.ExtType(5, b"abcd")))


# -- writing: the port's encoder and save_model --------------------------------

ENCODED_VALUES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 - 1, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63,
    0.5, -1e300, True, False, None,
    "", "x" * 31, "y" * 32, "z" * 300, "ü" * 40000,
    b"", b"\x00" * 300, b"\x01" * 70000,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(17)},
    {str(i): i for i in range(70000)},
    {"nested": {"a": [1, {"b": b"c"}]}},
]


@pytest.mark.parametrize("value", ENCODED_VALUES)
def test_encoder_matches_msgpack_and_round_trips(value):
    encoded = msgpack_dumps(value)
    assert encoded == msgpack.packb(value, use_bin_type=True)
    assert msgpack_loads(encoded) == value


@pytest.mark.parametrize("array", [
    np.zeros((3, 4), np.float32), np.arange(5, dtype=np.int16),
    np.zeros((0,), np.float32), np.ones((), np.float32),
    np.ones((2,), np.uint8), np.linspace(-1, 1, 90000, dtype=np.float32),
])
def test_encoder_writes_flax_ndarrays(array):
    tree = {"leaf": array, "nested": {"same": array}}
    encoded = msgpack_dumps(tree)
    assert encoded == serialization.msgpack_serialize(tree)
    _assert_trees_equal(msgpack_loads(encoded), tree)


def test_encoder_refuses_what_it_cannot_write():
    with pytest.raises(TypeError):
        msgpack_dumps({1.5})
    with pytest.raises(ValueError):
        msgpack_dumps(2 ** 64)
    with pytest.raises(ValueError):
        msgpack_dumps(np.array(["a"], dtype=object))


@pytest.mark.parametrize("name", MODELS)
def test_shipped_models_rewrite_byte_for_byte(name):
    """A shipped model read by the port writes its params.msgpack again,
    byte for byte: the tree's layout and key order are flax's."""
    import zipfile

    path = os.path.join(DATA, name)
    with zipfile.ZipFile(path) as archive:
        raw = archive.read("params.msgpack")
        config_text = archive.read("config.json").decode()
    model, cfg, meta = load_model(path)
    assert msgpack_dumps(to_flax_variables(model)) == raw
    assert _config_to_json(cfg, meta) == config_text


def _random_model(config, seed):
    from deepbinner_tpu_torch.models.network import DemuxNet, init_weights

    model = init_weights(DemuxNet(config), torch.Generator().manual_seed(seed))
    with torch.no_grad():  # running statistics and BN affine away from 0/1
        for name, tensor in model.state_dict().items():
            if not name.endswith("kernel") and not name.endswith("weight"):
                tensor.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(
                    seed + len(name)))
    return model


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_port_dbt_loads_in_jax_bit_equal(size, tmp_path):
    from deepbinner_tpu.train.trainer import TINY_PRESET as JAX_TINY
    from deepbinner_tpu_torch.models.network import NetworkConfig
    from deepbinner_tpu_torch.train.trainer import TINY_PRESET

    config = TINY_PRESET if size == "tiny" else NetworkConfig()
    model = _random_model(config, 3)
    path = tmp_path / "port.dbt"
    meta = {"kit": "EXP-NBD103", "end": "start", "best_val": {"accuracy": 0.5}}
    save_model(path, config, to_flax_variables(model), meta)
    _jmodel, variables, jax_cfg, jax_meta = jax_load_model(path)
    want_cfg = JAX_TINY if size == "tiny" else type(JAX_TINY)()
    assert jax_cfg == want_cfg and jax_meta == meta
    _assert_trees_equal(jax.device_get(variables), to_flax_variables(model))
    state = from_flax_variables(config, jax.device_get(variables))
    for key, value in model.state_dict().items():
        assert torch.equal(state[key], value), key
    assert not os.path.exists(str(path) + ".tmp")


def test_jax_dbt_round_trips_through_the_port_exactly(tmp_path):
    """JAX save_model → port load_model → port save_model → JAX load_model
    gives JAX's arrays back bit for bit."""
    import zipfile

    from deepbinner_tpu.models.checkpoint import save_model as jax_save_model
    from deepbinner_tpu.models.network import init_params
    from deepbinner_tpu.train.trainer import TINY_PRESET as JAX_TINY

    _m, variables = init_params(jax.random.PRNGKey(8), JAX_TINY)
    variables = jax.device_get(variables)
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree_util.tree_map(
                     lambda v: v + 0.25, variables["batch_stats"])}
    first = tmp_path / "jax.dbt"
    jax_save_model(first, JAX_TINY, variables, {"kit": "SQK-RBK004"})
    model, cfg, meta = load_model(first)
    second = tmp_path / "port.dbt"
    save_model(second, cfg, to_flax_variables(model), meta)
    _jm, again, jax_cfg, jax_meta = jax_load_model(second)
    assert jax_cfg == JAX_TINY and jax_meta == {"kit": "SQK-RBK004"}
    _assert_trees_equal(jax.device_get(again), variables)
    with zipfile.ZipFile(first) as a, zipfile.ZipFile(second) as b:
        assert a.read("params.msgpack") == b.read("params.msgpack")
        assert a.read("config.json") == b.read("config.json")
