"""DemuxNet's weights as a Keras 2.2 functional model: config and weight dict.

    from demuxnet_as_keras import demuxnet_as_keras
    model_config, weights = demuxnet_as_keras(config, variables)

``config`` is a DemuxNet ``NetworkConfig`` (either package's: only its
widths are read) and ``variables`` the flax variables tree of numpy arrays
(``params`` and ``batch_stats``; the port's ``to_flax_variables`` gives it
from a ``DemuxNet``).  The result is what a Keras-HDF5 reader takes from a
file: the ``model_config`` JSON object, and the weights keyed
``{layer: {"<layer>/<layer>/<name>:0": array}}`` as Keras 2.2 stores them.

Each ConvBNReLU unit becomes Conv1D (linear, no bias),
BatchNormalization (epsilon 1e-3) and Activation (relu); the stage pools
are MaxPooling1D(2), an inception's pool branch starts with
MaxPooling1D(3, strides 1, same), its four branches meet in a Concatenate,
and the head is GlobalAveragePooling1D and Dense(softmax).  The graph
computes DemuxNet's function on DemuxNet's weights.  Test tooling: it
needs numpy and json only, so it also runs where there is no h5py.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

import numpy as np

BN_EPSILON = 1e-3


def _node(*sources: str) -> List[List[list]]:
    return [[[source, 0, 0, {}] for source in sources]]


def _layer(layers: list, name: str, class_name: str, config: dict,
           *sources: str) -> str:
    config = {"name": name, "trainable": True, **config}
    layers.append({"name": name, "class_name": class_name, "config": config,
                   "inbound_nodes": _node(*sources) if sources else []})
    return name


def _leaf(tree: dict, path: str) -> np.ndarray:
    for part in path.split("/"):
        tree = tree[part]
    return np.asarray(tree, np.float32)


def demuxnet_as_keras(config, variables: dict
                      ) -> Tuple[Dict[str, Any], Dict[str, Dict[str, np.ndarray]]]:
    """(Keras ``model_config``, weights by layer) for DemuxNet's weights."""
    params, stats = variables["params"], variables["batch_stats"]
    layers: list = []
    weights: Dict[str, Dict[str, np.ndarray]] = {}

    def store(layer: str, **arrays: np.ndarray) -> None:
        weights[layer] = {f"{layer}/{layer}/{key}:0": value
                          for key, value in arrays.items()}

    def unit(scope: str, x: str, dilation: int = 1) -> str:
        name = scope.replace("/", "_")
        kernel = _leaf(params, f"{scope}/conv/kernel")
        conv = _layer(layers, f"{name}_conv", "Conv1D", {
            "filters": int(kernel.shape[2]), "kernel_size": [int(kernel.shape[0])],
            "strides": [1], "padding": "same", "dilation_rate": [dilation],
            "activation": "linear", "use_bias": False}, x)
        store(conv, kernel=kernel)
        bn = _layer(layers, f"{name}_bn", "BatchNormalization", {
            "axis": -1, "momentum": 0.99, "epsilon": BN_EPSILON,
            "center": True, "scale": True}, conv)
        store(bn, gamma=_leaf(params, f"{scope}/bn/scale"),
              beta=_leaf(params, f"{scope}/bn/bias"),
              moving_mean=_leaf(stats, f"{scope}/bn/mean"),
              moving_variance=_leaf(stats, f"{scope}/bn/var"))
        return _layer(layers, f"{name}_relu", "Activation",
                      {"activation": "relu"}, bn)

    def pool(name: str, x: str, size: int = 2, stride: int = 2,
             padding: str = "valid") -> str:
        return _layer(layers, name, "MaxPooling1D", {
            "pool_size": [size], "strides": [stride], "padding": padding}, x)

    x = _layer(layers, "input_1", "InputLayer", {
        "batch_input_shape": [None, int(config.input_length), 1],
        "dtype": "float32", "sparse": False})
    x = pool("stem_pool", unit("stem2", unit("stem1", x)))
    for i in range(len(config.block_features)):
        x = unit(f"block{i}_conv2", unit(f"block{i}_conv1", x))
        x = pool(f"block{i}_pool", x)
    for i in range(len(config.inception_features)):
        scope = f"inception{i}"
        branches = [
            unit(f"{scope}/branch1x1", x),
            unit(f"{scope}/branch3", x),
            unit(f"{scope}/branch_dilated", x, dilation=2 ** (i + 1)),
            unit(f"{scope}/branch_pool",
                 pool(f"{scope}_pool3", x, size=3, stride=1, padding="same")),
        ]
        x = _layer(layers, f"{scope}_concat", "Concatenate", {"axis": -1},
                   *branches)
        x = pool(f"{scope}_pool", x)
    x = unit("head_conv", x)
    x = _layer(layers, "global_average_pooling1d_1", "GlobalAveragePooling1D",
               {}, x)
    dense = _layer(layers, "classifier", "Dense", {
        "units": int(config.num_classes), "activation": "softmax",
        "use_bias": True}, x)
    store(dense, kernel=_leaf(params, "classifier/kernel"),
          bias=_leaf(params, "classifier/bias"))
    model_config = {
        "class_name": "Model",
        "config": {"name": "demuxnet", "layers": layers,
                   "input_layers": [["input_1", 0, 0]],
                   "output_layers": [[dense, 0, 0]]},
    }
    # A JSON round trip: the config is exactly what a file would hold.
    return json.loads(json.dumps(model_config)), weights
