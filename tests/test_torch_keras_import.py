"""The port's Keras-HDF5 import against the JAX package's.

The same ``.h5`` file goes through the JAX ``load_keras_model`` (run by
``model.apply``) and the port's (``KerasGraphModel.forward``), and the same
numpy inputs from a seed through both: logits within 2e-5.  Covered: the
Keras 2.2 layout written by hand (shared layer with two inbound nodes, Add,
Flatten, the Dense-softmax strip), a model saved by Keras 3, a Sequential
config without an InputLayer, and small graphs that name each place where
a port that holds rank-3 tensors as ``(N, C, L)`` could go wrong:

- layout: Flatten in Keras's ``(L, C)`` order, Concatenate on the channel
  and on the length axis, the global pools, Dense on a sequence;
- asymmetric SAME padding: a strided conv, an even-width conv, and SAME
  max and average pools at odd lengths (the odd pad goes on the right; an
  average divides by the count of real elements);
- BatchNormalization: the config's epsilon, without gamma and beta.

Every loud error of the JAX module is raised by the port with the layer's
name (the port raises when the graph is built, JAX when it runs).  Last,
DemuxNet expressed as a Keras graph (``scripts/demuxnet_as_keras.py``) is
held to the JAX DemuxNet on the same weights, and a classify program on
two Keras graphs to the JAX program on the same files.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from deepbinner_tpu.models import keras_import as jax_keras
from deepbinner_tpu.models.network import NetworkConfig, init_params
from deepbinner_tpu.ops.calling import CallingConfig as JaxCallingConfig
from deepbinner_tpu.ops.preprocess import PreprocessConfig as JaxPreprocessConfig
from deepbinner_tpu.runner import executor as jax_executor
from deepbinner_tpu.runner import pipeline as jax_pipeline
from deepbinner_tpu.utils import simulate
from deepbinner_tpu_torch.models import keras_import
from deepbinner_tpu_torch.models.checkpoint import load_model
from deepbinner_tpu_torch.ops.calling import CallingConfig
from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
from deepbinner_tpu_torch.runner import executor
from deepbinner_tpu_torch.runner.pipeline import ClassifyConfig, ClassifyProgram

h5py = pytest.importorskip("h5py")

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY_NET = NetworkConfig(
    input_length=256, stem_features=8, block_features=(8,),
    inception_features=(16,), head_features=16,
)
TOL = dict(atol=2e-5, rtol=0)
L = 32  # the Keras 2.2 fixture's input length


def _load_converter():
    spec = importlib.util.spec_from_file_location(
        "demuxnet_as_keras", os.path.join(ROOT, "scripts", "demuxnet_as_keras.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.demuxnet_as_keras


demuxnet_as_keras = _load_converter()


# -- the Keras 2.2 on-disk layout, written by hand --------------------------


def keras2_layer(name, class_name, config, inbound):
    config = dict(config)
    config.setdefault("name", name)
    config.setdefault("trainable", True)
    return {"name": name, "class_name": class_name, "config": config,
            "inbound_nodes": inbound}


def write_keras22_h5(path, model_config, weights):
    """The Keras 2.2 HDF5 saver's layout: ``model_config`` and version attrs
    at the root, ``model_weights/<layer>`` groups with ``weight_names``."""
    with h5py.File(path, "w") as handle:
        handle.attrs["model_config"] = json.dumps(model_config).encode()
        handle.attrs["keras_version"] = b"2.2.4"
        handle.attrs["backend"] = b"tensorflow"
        mw = handle.create_group("model_weights")
        layer_names = [layer["config"]["name"]
                       for layer in model_config["config"]["layers"]]
        mw.attrs["layer_names"] = np.array([n.encode() for n in layer_names],
                                           dtype="S64")
        mw.attrs["keras_version"] = b"2.2.4"
        mw.attrs["backend"] = b"tensorflow"
        for layer_name in layer_names:
            group = mw.create_group(layer_name)
            layer_weights = weights.get(layer_name, {})
            group.attrs["weight_names"] = np.array(
                [n.encode() for n in layer_weights], dtype="S128")
            for weight_name, value in layer_weights.items():
                group.create_dataset(weight_name, data=value)
    return str(path)


def _fixture_config(conv_padding="same"):
    """A Keras 2.2 functional ("Model") config with a shared Conv1D layer."""
    layers = [
        keras2_layer("input_1", "InputLayer",
                     {"batch_input_shape": [None, L, 1], "dtype": "float32",
                      "sparse": False}, []),
        keras2_layer("conv1d_1", "Conv1D",
                     {"filters": 4, "kernel_size": [3], "strides": [1],
                      "padding": conv_padding, "dilation_rate": [1],
                      "activation": "relu", "use_bias": True},
                     [[["input_1", 0, 0, {}]]]),
        keras2_layer("batch_normalization_1", "BatchNormalization",
                     {"axis": -1, "momentum": 0.99, "epsilon": 1e-3,
                      "center": True, "scale": True},
                     [[["conv1d_1", 0, 0, {}]]]),
        # Shared: node 1 re-applies node 0's weights to node 0's output.
        keras2_layer("conv1d_2", "Conv1D",
                     {"filters": 4, "kernel_size": [3], "strides": [1],
                      "padding": "same", "dilation_rate": [1],
                      "activation": "relu", "use_bias": True},
                     [[["batch_normalization_1", 0, 0, {}]],
                      [["conv1d_2", 0, 0, {}]]]),
        keras2_layer("add_1", "Add", {},
                     [[["conv1d_2", 0, 0, {}], ["conv1d_2", 1, 0, {}]]]),
        keras2_layer("max_pooling1d_1", "MaxPooling1D",
                     {"pool_size": [2], "padding": "valid", "strides": [2]},
                     [[["add_1", 0, 0, {}]]]),
        keras2_layer("flatten_1", "Flatten", {},
                     [[["max_pooling1d_1", 0, 0, {}]]]),
        keras2_layer("dense_2", "Dense",
                     {"units": 13, "activation": "softmax", "use_bias": True},
                     [[["flatten_1", 0, 0, {}]]]),
    ]
    return {"class_name": "Model",
            "config": {"name": "model_1", "layers": layers,
                       "input_layers": [["input_1", 0, 0]],
                       "output_layers": [["dense_2", 0, 0]]}}


def _fixture_weights(rng):
    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {
        "conv1d_1": {"conv1d_1/kernel:0": normal(3, 1, 4),
                     "conv1d_1/bias:0": normal(4)},
        "batch_normalization_1": {
            "batch_normalization_1/gamma:0": rng.uniform(0.5, 1.5, 4).astype(np.float32),
            "batch_normalization_1/beta:0": normal(4),
            "batch_normalization_1/moving_mean:0": normal(4),
            "batch_normalization_1/moving_variance:0":
                rng.uniform(0.5, 2.0, 4).astype(np.float32),
        },
        "conv1d_2": {"conv1d_2/kernel:0": normal(3, 4, 4),
                     "conv1d_2/bias:0": normal(4)},
        "dense_2": {"dense_2/kernel:0": normal(4 * (L // 2), 13),
                    "dense_2/bias:0": normal(13)},
    }


def _both_logits(path, x):
    """(JAX logits, port logits) of the model file at ``path`` on ``x``."""
    j_model, j_vars, j_cfg, j_meta = jax_keras.load_keras_model(path)
    p_model, p_cfg, p_meta = keras_import.load_keras_model(path)
    assert (p_cfg.input_length, p_cfg.num_classes) == \
        (j_cfg.input_length, j_cfg.num_classes)
    assert p_meta == j_meta
    want = np.asarray(j_model.apply(j_vars, x, train=False))
    with torch.inference_mode():
        got = p_model(torch.from_numpy(x)).numpy()
    return want, got


def test_keras22_fixture_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    path = write_keras22_h5(tmp_path / "model1.h5", _fixture_config(),
                            _fixture_weights(rng))
    x = rng.normal(size=(3, L, 1)).astype(np.float32)
    want, got = _both_logits(path, x)
    assert got.shape == (3, 13)
    np.testing.assert_allclose(got, want, **TOL)
    # The softmax was stripped: logits, not probabilities.
    assert not np.allclose(got.sum(-1), 1.0, atol=1e-3)


def test_load_model_sniffs_hdf5(tmp_path):
    rng = np.random.default_rng(2)
    path = write_keras22_h5(tmp_path / "model1.h5", _fixture_config(),
                            _fixture_weights(rng))
    model, config, meta = load_model(path)
    assert isinstance(model, keras_import.KerasGraphModel)
    assert config == keras_import.KerasModelConfig(input_length=L, num_classes=13)
    assert meta == {"keras_version": "2.2.4", "source_file": path}
    # Weights are buffers: a copy on another device (here another dtype,
    # the CPU's only other placement) carries all of them.
    assert {name for name, _ in model.named_buffers()} >= {
        "layers.1.weight", "layers.1.bias", "layers.2.scale", "layers.2.shift"}
    assert model.to(torch.float64).layers[1].weight.dtype == torch.float64


def test_keras2_sequential_without_input_layer(tmp_path):
    rng = np.random.default_rng(3)
    config = {"class_name": "Sequential", "config": {"name": "seq2", "layers": [
        {"class_name": "Conv1D", "config": {
            "name": "conv1", "batch_input_shape": [None, 16, 1], "filters": 2,
            "kernel_size": [3], "strides": [1], "padding": "same",
            "dilation_rate": [1], "activation": "relu", "use_bias": True}},
        {"class_name": "GlobalAveragePooling1D", "config": {"name": "gap"}},
        {"class_name": "Dense", "config": {
            "name": "dense", "units": 3, "activation": "softmax",
            "use_bias": True}},
    ]}}
    weights = {
        "conv1": {"conv1/kernel:0": rng.normal(size=(3, 1, 2)).astype(np.float32),
                  "conv1/bias:0": rng.normal(size=(2,)).astype(np.float32)},
        "dense": {"dense/kernel:0": rng.normal(size=(2, 3)).astype(np.float32),
                  "dense/bias:0": rng.normal(size=(3,)).astype(np.float32)},
    }
    path = write_keras22_h5(tmp_path / "keras2_seq.h5", config, weights)
    want, got = _both_logits(path, rng.normal(size=(4, 16, 1)).astype(np.float32))
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got, want, **TOL)


# -- small graphs, one per place the (N, C, L) layout could go wrong -------


def _conv(name, src, filters, width, strides=1, padding="same", dilation=1,
          activation="linear"):
    return keras2_layer(name, "Conv1D", {
        "filters": filters, "kernel_size": [width], "strides": [strides],
        "padding": padding, "dilation_rate": [dilation],
        "activation": activation, "use_bias": True}, [[[src, 0, 0, {}]]])


def _pool(name, src, kind, size, strides, padding):
    return keras2_layer(name, kind, {"pool_size": [size], "strides": [strides],
                                     "padding": padding}, [[[src, 0, 0, {}]]])


def _simple(name, kind, config, *sources):
    return keras2_layer(name, kind, config,
                        [[[s, 0, 0, {}] for s in sources]])


CASES = {
    # Flatten must flatten (L, C), or the Dense weights are misaligned.
    "flatten_order": (12, [
        _conv("c", "input_1", 3, 3),
        _simple("f", "Flatten", {}, "c"),
    ]),
    # Concatenate on the channel axis (-1 and 2) and on the length axis (1).
    "concat_axes": (16, [
        _conv("a", "input_1", 2, 3),
        _conv("b", "input_1", 3, 1),
        _simple("cat_c", "Concatenate", {"axis": -1}, "a", "b"),
        _simple("cat_c2", "Concatenate", {"axis": 2}, "cat_c", "a"),
        _simple("cat_l", "Concatenate", {"axis": 1}, "a", "a"),
        _simple("f", "Flatten", {}, "cat_l"),
        _simple("g", "GlobalMaxPooling1D", {}, "cat_c2"),
        _simple("cat_2d", "Concatenate", {"axis": -1}, "f", "g"),
    ]),
    "global_pools": (20, [
        _conv("c", "input_1", 4, 5, activation="tanh"),
        _simple("avg", "GlobalAveragePooling1D", {}, "c"),
        _simple("max", "GlobalMaxPooling1D", {}, "c"),
        _simple("sum", "Add", {}, "avg", "max"),
    ]),
    # Dense on a sequence acts on the channels of each position.
    "dense_on_sequence": (10, [
        _conv("c", "input_1", 3, 3, activation="sigmoid"),
        _simple("d", "Dense", {"units": 5, "activation": "relu",
                               "use_bias": True}, "c"),
        _simple("sm", "Activation", {"activation": "softmax"}, "d"),
        _simple("f", "Flatten", {}, "sm"),
    ]),
    # A strided SAME conv at an odd length: the odd pad goes on the right.
    "strided_same_conv": (37, [
        _conv("c", "input_1", 3, 3, strides=2, activation="relu"),
        _conv("c2", "c", 2, 5, strides=3),
        _simple("f", "Flatten", {}, "c2"),
    ]),
    "even_width_same_conv": (21, [
        _conv("c", "input_1", 3, 4),
        _conv("c2", "c", 2, 2, dilation=3),
        _simple("f", "Flatten", {}, "c2"),
    ]),
    # SAME average pool at an odd length divides by the real elements.
    "same_avg_pool_odd": (37, [
        _conv("c", "input_1", 3, 3, activation="relu"),
        _pool("p", "c", "AveragePooling1D", 3, 2, "same"),
        _pool("p2", "p", "AveragePooling1D", 4, 4, "same"),
        _simple("f", "Flatten", {}, "p2"),
    ]),
    # SAME max pools pad with -inf (half the conv's outputs are negative).
    "same_max_pool_odd": (19, [
        _conv("c", "input_1", 3, 1, activation="linear"),
        _pool("p", "c", "MaxPooling1D", 2, 2, "same"),
        _pool("p3", "p", "MaxPooling1D", 3, 1, "same"),
        _pool("pv", "c", "MaxPooling1D", 3, 2, "valid"),
        _simple("f", "Flatten", {}, "p3"),
        _simple("fv", "Flatten", {}, "pv"),
        _simple("cat", "Concatenate", {"axis": -1}, "f", "fv"),
    ]),
    # BatchNormalization with the config's epsilon, with and without
    # gamma/beta, and the inference no-ops.
    "batchnorm_eps_no_affine": (12, [
        _conv("c", "input_1", 3, 3),
        _simple("bn", "BatchNormalization", {"epsilon": 0.25, "center": False,
                                             "scale": False}, "c"),
        _simple("bn2", "BatchNormalization", {"epsilon": 1e-5}, "bn"),
        _simple("dropout", "Dropout", {"rate": 0.5}, "bn2"),
        _simple("noise", "GaussianNoise", {"stddev": 1.0}, "dropout"),
        _simple("gd", "GaussianDropout", {"rate": 0.5}, "noise"),
        _simple("sd", "SpatialDropout1D", {"rate": 0.5}, "gd"),
        _simple("ar", "ActivityRegularization", {}, "sd"),
        _simple("f", "Flatten", {}, "ar"),
    ]),
}


def _case_model(length, body, rng):
    """A functional config: input → ``body`` → Dense(7, softmax), with
    random weights for every layer that has some."""
    layers = [keras2_layer("input_1", "InputLayer",
                           {"batch_input_shape": [None, length, 1]}, [])]
    layers += body
    layers.append(_simple("out", "Dense", {"units": 7, "activation": "softmax",
                                           "use_bias": True},
                          body[-1]["config"]["name"]))
    shapes = {"input_1": (length, 1)}
    weights = {}
    for layer in layers[1:]:
        cfg, kind = layer["config"], layer["class_name"]
        name = cfg["name"]
        src = [shapes[ref[0]] for ref in layer["inbound_nodes"][0]]
        channels = src[0][-1]
        w = {}
        # Kernels at a variance of 1/fan_in, so that values stay O(1) and
        # 2e-5 is a bound on f32 rounding, not on the magnitude.
        if kind == "Conv1D":
            width = cfg["kernel_size"][0]
            w = {"kernel": rng.normal(size=(width, channels, cfg["filters"]))
                 / np.sqrt(width * channels),
                 "bias": rng.normal(size=cfg["filters"])}
        elif kind == "Dense":
            w = {"kernel": rng.normal(size=(channels, cfg["units"]))
                 / np.sqrt(channels),
                 "bias": rng.normal(size=cfg["units"])}
        elif kind == "BatchNormalization":
            w = {"moving_mean": rng.normal(size=channels),
                 "moving_variance": rng.uniform(0.1, 2.0, channels)}
            if cfg.get("center", True):
                w["beta"] = rng.normal(size=channels)
            if cfg.get("scale", True):
                w["gamma"] = rng.uniform(0.5, 1.5, channels)
        if w:
            weights[name] = {f"{name}/{name}/{k}:0": v.astype(np.float32)
                             for k, v in w.items()}
        shapes[name] = _shape_of(layer, src)
    return ({"class_name": "Model", "config": {
        "name": "case", "layers": layers,
        "input_layers": [["input_1", 0, 0]],
        "output_layers": [["out", 0, 0]]}}, weights)


def _shape_of(layer, src):
    """The Keras output shape (without the batch) of ``layer``."""
    cfg, kind = layer["config"], layer["class_name"]
    if kind == "Conv1D":
        length, stride = src[0][0], cfg["strides"][0]
        window = (cfg["kernel_size"][0] - 1) * cfg["dilation_rate"][0] + 1
        out = (-(-length // stride) if cfg["padding"] == "same"
               else (length - window) // stride + 1)
        return (out, cfg["filters"])
    if kind in ("MaxPooling1D", "AveragePooling1D"):
        length, size, stride = src[0][0], cfg["pool_size"][0], cfg["strides"][0]
        out = (-(-length // stride) if cfg["padding"] == "same"
               else (length - size) // stride + 1)
        return (out, src[0][1])
    if kind == "Flatten":
        return (int(np.prod(src[0])),)
    if kind in ("GlobalAveragePooling1D", "GlobalMaxPooling1D"):
        return (src[0][-1],)
    if kind == "Dense":
        return src[0][:-1] + (cfg["units"],)
    if kind == "Concatenate":
        axis = cfg.get("axis", -1) % (len(src[0]) + 1) - 1
        out = list(src[0])
        out[axis] = sum(s[axis] for s in src)
        return tuple(out)
    return src[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_and_padding_cases_match_jax(tmp_path, case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    length, body = CASES[case]
    config, weights = _case_model(length, body, rng)
    path = write_keras22_h5(tmp_path / f"{case}.h5", config, weights)
    x = rng.normal(size=(3, length, 1)).astype(np.float32)
    want, got = _both_logits(path, x)
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got, want, **TOL)


# -- the loud errors -------------------------------------------------------


def _broken(kind, rng):
    config, weights = _fixture_config(), _fixture_weights(rng)
    layers = config["config"]["layers"]
    if kind == "unsupported_layer":
        layers[6] = keras2_layer("lstm_1", "LSTM", {"units": 4},
                                 [[["max_pooling1d_1", 0, 0, {}]]])
        layers[7]["inbound_nodes"] = [[["lstm_1", 0, 0, {}]]]
        return config, weights, "unsupported Keras layer 'LSTM'", "lstm_1"
    if kind == "causal_padding":
        layers[1]["config"]["padding"] = "causal"
        return config, weights, "padding 'causal'", "conv1d_1"
    if kind == "missing_weights":
        del weights["dense_2"]["dense_2/kernel:0"]
        return config, weights, "missing its kernel", "dense_2"
    if kind == "ambiguous_weights":
        weights["dense_2"]["dense_2_extra/kernel:0"] = \
            weights["dense_2"]["dense_2/kernel:0"].copy()
        return config, weights, "ambiguous", "dense_2"
    if kind == "unsupported_activation":
        layers[1]["config"]["activation"] = "selu"
        return config, weights, "unsupported Keras activation 'selu'", "conv1d_1"
    if kind == "multi_output_reference":
        layers[4]["inbound_nodes"] = [[["conv1d_2", 0, 1, {}],
                                       ["conv1d_2", 1, 0, {}]]]
        return config, weights, "multi-output layers are unsupported", "add_1"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", [
    "unsupported_layer", "causal_padding", "missing_weights",
    "ambiguous_weights", "unsupported_activation", "multi_output_reference",
])
def test_loud_errors_name_the_layer(tmp_path, kind):
    rng = np.random.default_rng(5)
    config, weights, message, layer = _broken(kind, rng)
    path = write_keras22_h5(tmp_path / f"{kind}.h5", config, weights)
    x = rng.normal(size=(1, L, 1)).astype(np.float32)
    j_model, j_vars, _c, _m = jax_keras.load_keras_model(path)
    with pytest.raises(ValueError, match=message):
        j_model.apply(j_vars, x, train=False)
    with pytest.raises(ValueError, match=message) as exc:
        keras_import.load_keras_model(path)
    assert repr(layer) in str(exc.value)


@pytest.mark.parametrize("kind", ["no_input_length", "no_dense_layer"])
def test_config_errors_match_jax(tmp_path, kind):
    rng = np.random.default_rng(6)
    config, weights = _fixture_config(), _fixture_weights(rng)
    layers = config["config"]["layers"]
    if kind == "no_input_length":
        layers[0]["config"]["batch_input_shape"] = [None, None, 1]
        message = "no fixed input length"
    else:
        layers[7] = keras2_layer("gap", "GlobalAveragePooling1D", {},
                                 [[["max_pooling1d_1", 0, 0, {}]]])
        config["config"]["output_layers"] = [["gap", 0, 0]]
        message = "no final Dense layer"
    path = write_keras22_h5(tmp_path / f"{kind}.h5", config, weights)
    with pytest.raises(ValueError, match=message):
        jax_keras.load_keras_model(path)
    with pytest.raises(ValueError, match=message):
        load_model(path)


def test_not_a_keras_file_is_refused(tmp_path):
    path = tmp_path / "plain.h5"
    with h5py.File(path, "w") as handle:
        handle.create_dataset("x", data=np.zeros(3))
    with pytest.raises(ValueError, match="no model_config"):
        load_model(path)


# -- a model saved by Keras 3 ----------------------------------------------


@pytest.fixture(scope="module")
def keras3_model_file(tmp_path_factory):
    os.environ.setdefault("KERAS_BACKEND", "jax")
    keras = pytest.importorskip("keras")
    keras.utils.set_random_seed(3)
    inputs = keras.Input(shape=(64, 1))
    x = keras.layers.GaussianNoise(0.02)(inputs)
    x = keras.layers.Conv1D(8, 3, padding="same", activation="relu")(x)
    x = keras.layers.BatchNormalization()(x)
    x = keras.layers.MaxPooling1D(2)(x)
    b1 = keras.layers.Conv1D(4, 1, padding="same", activation="relu")(x)
    b2 = keras.layers.Conv1D(4, 3, padding="same", activation="relu")(x)
    b3 = keras.layers.Conv1D(4, 3, padding="same", dilation_rate=2,
                             activation="relu")(x)
    x = keras.layers.Concatenate()([b1, b2, b3])
    x = keras.layers.BatchNormalization()(x)
    x = keras.layers.AveragePooling1D(3, strides=2, padding="same")(x)
    x = keras.layers.Dropout(0.1)(x)
    x = keras.layers.Conv1D(8, 4, strides=2, padding="same", activation="relu")(x)
    x = keras.layers.GlobalAveragePooling1D()(x)
    outputs = keras.layers.Dense(13, activation="softmax")(x)
    model = keras.Model(inputs, outputs)
    path = str(tmp_path_factory.mktemp("keras3") / "model.h5")
    model.save(path)  # legacy HDF5 (chosen by the extension)
    return path


def test_keras3_saved_model_matches_jax(keras3_model_file):
    x = np.random.default_rng(7).normal(size=(3, 64, 1)).astype(np.float32)
    want, got = _both_logits(keras3_model_file, x)
    np.testing.assert_allclose(got, want, **TOL)
    model, config, meta = load_model(keras3_model_file)
    assert (config.input_length, config.num_classes) == (64, 13)
    assert meta["keras_version"].startswith("3")


# -- DemuxNet as a Keras graph ---------------------------------------------


def _demuxnet_h5(tmp_path, seed, name="demuxnet.h5"):
    model, variables = init_params(jax.random.PRNGKey(seed), TINY_NET)
    variables = jax.device_get(variables)
    config, weights = demuxnet_as_keras(TINY_NET, variables)
    return model, variables, write_keras22_h5(tmp_path / name, config, weights)


def test_demuxnet_as_keras_matches_jax_demuxnet(tmp_path):
    model, variables, path = _demuxnet_h5(tmp_path, 3)
    x = np.random.default_rng(8).normal(
        size=(6, TINY_NET.input_length, 1)).astype(np.float32)
    want = np.asarray(jax.nn.softmax(model.apply(variables, x, train=False), -1))
    graph, config, _meta = load_model(path)
    assert (config.input_length, config.num_classes) == (256, 13)
    with torch.inference_mode():
        got = torch.softmax(graph(torch.from_numpy(x)), -1).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    j_want, j_got = _both_logits(path, x)
    np.testing.assert_allclose(j_got, j_want, **TOL)


def test_program_on_keras_graphs_matches_jax(tmp_path):
    """Dual mode on two Keras graphs, each end its own graph object: the
    JAX program (``model.apply``) and the port's give the same calls and
    combined probabilities within 3e-5."""
    pre = dict(scan_size=768, window=256, stride=128, trim_scan=512,
               trim_window=64, trim_stride=16)
    calling = dict(min_score=0.0, score_diff=0.0)
    paths = [_demuxnet_h5(tmp_path, seed, f"{seed}.h5")[2] for seed in (6, 7)]
    (j_start, j_svars, _c, _m), (j_end, j_evars, _c2, _m2) = [
        jax_keras.load_keras_model(p) for p in paths]
    jax_program = jax_pipeline.ClassifyProgram(
        j_start, jax_pipeline.ClassifyConfig(
            JaxPreprocessConfig(**pre), JaxCallingConfig(**calling),
            dual_model=True),
        j_svars, j_evars, end_model=j_end)
    start, end = [load_model(p)[0] for p in paths]
    program = ClassifyProgram(start, ClassifyConfig(
        PreprocessConfig(**pre), CallingConfig(**calling), dual_model=True),
        end_model=end, device="cpu")
    assert program.start_net is not start  # the program's own copies
    assert program.start_net is not program.end_net
    rng = np.random.default_rng(9)
    reads = []
    for barcode in list(range(13)) + [4]:
        read = simulate.simulate_read("EXP-NBD103", barcode, rng,
                                      genome_length=600)
        reads.append((read.read_id, read.signal))
    want = {r.read_id: r for r in jax_executor.classify_stream(
        jax_program, iter(reads), batch_size=8)}
    got = {r.read_id: r for r in executor.classify_stream(
        program, iter(reads), batch_size=8)}
    assert sorted(got) == sorted(want)
    for read_id, w in want.items():
        g = got[read_id]
        assert (g.call, g.start_call, g.end_call) == \
            (w.call, w.start_call, w.end_call)
        np.testing.assert_allclose(g.start_probs, w.start_probs, atol=3e-5)
        np.testing.assert_allclose(g.end_probs, w.end_probs, atol=3e-5)


@pytest.mark.parametrize("kernel_path", ["fused", "split3", "hybrid"])
def test_keras_graph_refuses_a_kernel_path(tmp_path, kernel_path):
    graph = load_model(_demuxnet_h5(tmp_path, 3)[2])[0]
    cfg = ClassifyConfig(PreprocessConfig(scan_size=768, window=256, stride=128,
                                          trim_scan=512),
                         kernel_path=kernel_path)
    with pytest.raises(ValueError, match="Keras graph"):
        ClassifyProgram(graph, cfg, device="cpu")
