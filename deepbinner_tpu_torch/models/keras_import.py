"""Keras-HDF5 model import: run the reference's ``.h5`` models in PyTorch.

Counterpart of ``deepbinner_tpu/models/keras_import.py``.  The reference
ships its trained models as Keras HDF5 files and loads them with
``keras.models.load_model``; this module reads them with **h5py only**
(imported inside :func:`load_keras_model`, so the package imports without
it):

- the ``model_config`` JSON attribute gives the layer graph,
- ``model_weights/<layer>/...`` gives the weights (Keras Conv1D kernels are
  ``(width, in, out)``),

and :class:`KerasGraphModel` runs that graph as an ``nn.Module`` whose
weights are buffers (``.to(device)`` moves them).  The layer vocabulary is
the JAX module's: InputLayer, the inference no-ops (Dropout, GaussianNoise,
GaussianDropout, ActivityRegularization, SpatialDropout1D), Activation,
Conv1D, MaxPooling1D / AveragePooling1D, BatchNormalization, Dense,
Flatten, GlobalAverage/MaxPooling1D, Concatenate and Add.  Anything else,
and every malformed layer, raises ``ValueError`` with the layer's name when
the graph is built.

Layout: Keras tensors are ``(N, L, C)``; inside the graph a rank-3 tensor
is held as ``(N, C, L)``, the layout of ``F.conv1d``.  So a Keras axis is
mapped before use (:func:`_torch_axis`), ``Flatten`` flattens in Keras's
``(L, C)`` order, and the global pools reduce over the last axis.  SAME
padding is TF's and ``lax``'s: the odd element of the padding goes on the
right (:func:`_same_pads`), max pools pad with ``-inf``, and a SAME average
pool divides by the count of real elements.

A trailing softmax is stripped so the module returns logits, as DemuxNet
does (the classify program applies the softmax).  The module computes in
f32; the classify program runs it inside ``runner/pipeline.full_f32``, so
its convolutions and matmuls run with TF32 off on the card.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Weights = Dict[str, Dict[str, np.ndarray]]
NodeKey = Tuple[str, int]  # (layer name, node index)


@dataclasses.dataclass(frozen=True)
class KerasModelConfig:
    """Just enough geometry for the pipeline (mirrors NetworkConfig fields)."""

    input_length: int
    num_classes: int
    source: str = "keras-h5"


_ACTIVATIONS = {
    None: lambda x: x,
    "linear": lambda x: x,
    "relu": torch.relu,
    "softmax": lambda x: torch.softmax(x, dim=1),  # channels: dim 1 at rank 2 and 3
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}

_NO_OPS = ("Dropout", "GaussianNoise", "GaussianDropout",
           "ActivityRegularization", "SpatialDropout1D")


def _activation(name: Optional[str], layer: str):
    if name not in _ACTIVATIONS:
        raise ValueError(f"unsupported Keras activation {name!r} "
                         f"(layer {layer!r})")
    return _ACTIVATIONS[name]


def _first(value, default: int) -> int:
    """A Keras 1D size, given as ``[n]`` or ``n``."""
    if value is None:
        return default
    return int(value[0] if isinstance(value, (list, tuple)) else value)


def _same_pads(length: int, window: int, stride: int) -> Tuple[int, int]:
    """TF/``lax`` SAME padding for a (dilated) ``window``: (left, right)."""
    out = -(-length // stride)
    total = max((out - 1) * stride + window - length, 0)
    return total // 2, total - total // 2


def _torch_axis(axis: int, rank: int) -> int:
    """A Keras axis of a rank-``rank`` tensor → the axis of the graph's
    tensor (rank 3 is held as ``(N, C, L)``, Keras ``(N, L, C)``)."""
    axis %= rank
    return (0, 2, 1)[axis] if rank == 3 else axis


def _padding(cfg: Dict[str, Any], kind: str, name: str) -> str:
    padding = cfg.get("padding", "valid")
    if padding not in ("valid", "same"):
        raise ValueError(
            f"unsupported {kind} padding {padding!r} (layer {name!r}) — only "
            f"'valid'/'same' are implemented"
        )
    return padding


class _Layer(nn.Module):
    """One Keras layer; its weights are buffers."""

    def __init__(self, **buffers: Optional[torch.Tensor]) -> None:
        super().__init__()
        for key, value in buffers.items():
            self.register_buffer(key, value)


class _Identity(_Layer):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class _Activation(_Layer):
    def __init__(self, fn) -> None:
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class _Conv1D(_Layer):
    def __init__(self, kernel, bias, stride, dilation, padding, act) -> None:
        # Keras (width, in, out) → F.conv1d's (out, in, width).
        super().__init__(weight=kernel.permute(2, 1, 0).contiguous(), bias=bias)
        self.stride, self.dilation, self.padding, self.act = (
            stride, dilation, padding, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = 0
        if self.padding == "same":
            window = (self.weight.shape[2] - 1) * self.dilation + 1
            left, right = _same_pads(x.shape[2], window, self.stride)
            if left == right:
                pad = left
            else:
                x = F.pad(x, (left, right))
        out = F.conv1d(x, self.weight, self.bias, stride=self.stride,
                       padding=pad, dilation=self.dilation)
        return self.act(out)


class _Pool1D(_Layer):
    def __init__(self, average: bool, pool: int, stride: int, padding: str) -> None:
        super().__init__()
        self.average, self.pool, self.stride, self.padding = (
            average, pool, stride, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        left = right = 0
        if self.padding == "same":
            left, right = _same_pads(x.shape[2], self.pool, self.stride)
        if not self.average:
            if left or right:
                x = F.pad(x, (left, right), value=float("-inf"))
            return F.max_pool1d(x, self.pool, self.stride)
        # Sum over the window, divided by the count of real elements.
        total = F.pad(x, (left, right)).unfold(2, self.pool, self.stride).sum(-1)
        ones = torch.ones(x.shape[2], dtype=x.dtype, device=x.device)
        count = F.pad(ones, (left, right)).unfold(0, self.pool, self.stride).sum(-1)
        return total / count


class _BatchNorm(_Layer):
    def __init__(self, scale, shift) -> None:
        super().__init__(scale=scale, shift=shift)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            return x * self.scale[:, None] + self.shift[:, None]
        return x * self.scale + self.shift


class _Dense(_Layer):
    def __init__(self, kernel, bias, act) -> None:
        super().__init__(weight=kernel.t().contiguous(), bias=bias)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:  # Dense on the channels of every position
            out = F.linear(x.transpose(1, 2), self.weight, self.bias)
            return self.act(out.transpose(1, 2))
        return self.act(F.linear(x, self.weight, self.bias))


class _Flatten(_Layer):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:  # Keras's (L, C) order
            x = x.transpose(1, 2)
        return x.reshape(x.shape[0], -1)


class _GlobalPool(_Layer):
    def __init__(self, average: bool) -> None:
        super().__init__()
        self.average = average

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=2) if self.average else x.amax(dim=2)


class _Concatenate(_Layer):
    def __init__(self, axis: int) -> None:
        super().__init__()
        self.axis = axis

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        return torch.cat(xs, dim=_torch_axis(self.axis, xs[0].dim()))


class _Add(_Layer):
    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        return sum(xs[1:], xs[0])


def _build_layer(layer: Dict[str, Any], w: Dict[str, np.ndarray]) -> _Layer:
    """The module of one Keras layer; raises with its name on anything the
    JAX module would refuse."""
    kind = layer["class_name"]
    cfg = layer["config"]
    name = cfg["name"]

    def get(names: Tuple[str, ...]) -> Optional[torch.Tensor]:
        # EXACT basename match: "conv1d_1/conv1d_1/kernel:0" resolves by its
        # last path component with the ":0" suffix stripped.
        matches = [(key, value) for key, value in w.items()
                   if key.rsplit("/", 1)[-1].split(":", 1)[0] in names]
        if not matches:
            return None
        if len(matches) > 1:
            raise ValueError(
                f"layer {name!r} has {len(matches)} datasets matching "
                f"{names}: {[k for k, _ in matches]} — ambiguous weights"
            )
        return torch.tensor(np.asarray(matches[0][1], np.float32))

    def require(names: Tuple[str, ...]) -> torch.Tensor:
        value = get(names)
        if value is None:
            raise ValueError(
                f"layer {name!r} ({kind}) is missing its {names[0]} "
                f"weights (found: {sorted(w)})"
            )
        return value

    if kind == "InputLayer" or kind in _NO_OPS:
        return _Identity()
    if kind == "Activation":
        return _Activation(_activation(cfg["activation"], name))
    if kind == "Conv1D":
        padding = _padding(cfg, kind, name)
        kernel = require(("kernel",))
        bias = get(("bias",)) if cfg.get("use_bias", True) else None
        return _Conv1D(kernel, bias, _first(cfg.get("strides"), 1),
                       _first(cfg.get("dilation_rate"), 1), padding,
                       _activation(cfg.get("activation", "linear"), name))
    if kind in ("MaxPooling1D", "AveragePooling1D"):
        pool = _first(cfg.get("pool_size"), 2)
        stride = _first(cfg.get("strides") or pool, pool)
        return _Pool1D(kind == "AveragePooling1D", pool, stride,
                       _padding(cfg, kind, name))
    if kind == "BatchNormalization":
        eps = cfg.get("epsilon", 1e-3)
        gamma, beta = get(("gamma",)), get(("beta",))
        mean, var = require(("moving_mean",)), require(("moving_variance",))
        scale = torch.rsqrt(var + eps)
        if gamma is not None:
            scale = gamma * scale
        shift = -mean * scale
        if beta is not None:
            shift = beta + shift
        return _BatchNorm(scale, shift)
    if kind == "Dense":
        kernel = require(("kernel",))
        bias = get(("bias",)) if cfg.get("use_bias", True) else None
        return _Dense(kernel, bias,
                      _activation(cfg.get("activation", "linear"), name))
    if kind == "Flatten":
        return _Flatten()
    if kind in ("GlobalAveragePooling1D", "GlobalMaxPooling1D"):
        return _GlobalPool(kind == "GlobalAveragePooling1D")
    if kind == "Concatenate":
        return _Concatenate(int(cfg.get("axis", -1)))
    if kind == "Add":
        return _Add()
    raise ValueError(
        f"unsupported Keras layer {kind!r} (layer {name!r}) — extend "
        f"deepbinner_tpu_torch/models/keras_import.py"
    )


def _is_softmax_layer(layer: Dict[str, Any]) -> bool:
    kind = layer["class_name"]
    return (kind in ("Activation", "Dense")
            and layer["config"].get("activation") == "softmax")


class KerasGraphModel(nn.Module):
    """Executable inference graph parsed from a Keras HDF5 file.

    ``forward`` maps ``(B, L, 1)`` (or ``(B, L)``) windows to ``(B, C)``
    logits.  The graph is parsed and every layer built in ``__init__``;
    a layer called N times (shared weights, legal in the Keras 2 functional
    API) is one module with N results, keyed by ``(layer, node)``.
    """

    def __init__(self, model_config: Dict[str, Any], weights: Weights) -> None:
        super().__init__()
        cfg = model_config["config"]
        layers: List[Dict[str, Any]] = cfg["layers"]
        sequential = model_config["class_name"] == "Sequential"
        if sequential:
            final: NodeKey = (layers[-1]["config"]["name"], 0)
        else:
            # Keras 2 nests specs ([["name", 0, 0], ...]); Keras 3 flattens a
            # single output to ["name", 0, 0].
            specs = cfg["output_layers"]
            if specs and isinstance(specs[0], str):
                specs = [specs]
            spec = specs[0]
            final = (spec[0], int(spec[1]) if len(spec) > 1 else 0)
        self.config = _make_config(layers)
        self.layers = nn.ModuleList()
        # Per layer: (name, sources), where sources is None for an input
        # layer, else one list of node keys per call (None = the model input).
        self._plan: List[Tuple[str, Optional[List[List[Optional[NodeKey]]]]]] = []
        last: Optional[NodeKey] = None
        for layer in layers:
            name = layer["config"]["name"]
            if name == final[0] and _is_softmax_layer(layer):
                # Dense(softmax) → linear; Activation(softmax) → identity.
                layer = copy.deepcopy(layer)
                layer["config"]["activation"] = "linear"
            self.layers.append(_build_layer(layer, weights.get(name, {})))
            nodes = _inbound_node_refs(layer.get("inbound_nodes"))
            if layer["class_name"] == "InputLayer":
                sources = None
            elif sequential or not nodes:
                # Keras 2 Sequential configs have no InputLayer entry: the
                # first real layer consumes the model input directly.
                sources = [[last]]
            else:
                sources = []
                for refs in nodes:
                    for src_name, _node, tensor_idx in refs:
                        if tensor_idx != 0:
                            raise ValueError(
                                f"layer {name!r} consumes output {tensor_idx} "
                                f"of {src_name!r} — multi-output layers are "
                                f"unsupported"
                            )
                    sources.append([(src, node) for src, node, _t in refs])
            self._plan.append((name, sources))
            last = (name, 0)
        self._final = final
        # The results each layer reads for the last time, dropped after it
        # so that a batch holds only the activations still to be read.
        last_read = {key: index for index, (_name, sources) in enumerate(self._plan)
                     for keys in sources or [] for key in keys if key is not None}
        self._drop: List[List[NodeKey]] = [[] for _ in self._plan]
        for key, index in last_read.items():
            if key != final:
                self._drop[index].append(key)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, L, 1)`` → logits ``(B, C)`` (trailing softmax stripped)."""
        if x.dim() == 2:
            x = x[:, :, None]
        x = x.float().transpose(1, 2)  # Keras (N, L, C) → (N, C, L)
        results: Dict[NodeKey, torch.Tensor] = {}
        for layer, (name, sources), drop in zip(self.layers, self._plan,
                                                self._drop):
            if sources is None:
                results[(name, 0)] = x
                continue
            for node, keys in enumerate(sources):
                results[(name, node)] = layer(
                    *(x if key is None else results[key] for key in keys))
            for key in drop:
                del results[key]
        out = results[self._final]
        return out.transpose(1, 2) if out.dim() == 3 else out


def _make_config(layers: List[Dict[str, Any]]) -> KerasModelConfig:
    input_length = None
    for layer in layers:
        shape = (layer["config"].get("batch_input_shape")
                 or layer["config"].get("batch_shape"))
        if shape and len(shape) >= 2 and shape[1]:
            input_length = int(shape[1])
            break
    classes = None
    for layer in reversed(layers):
        if layer["class_name"] == "Dense":
            classes = int(layer["config"]["units"])
            break
    # No silent guessing: the classify windows are sized from this value, so
    # a variable-length or shapeless input would classify with wrongly sized
    # windows and no shape error downstream.
    if input_length is None:
        raise ValueError(
            "Keras model declares no fixed input length "
            "(batch_input_shape[1] is None/absent in every layer); "
            "cannot size the classify windows from it"
        )
    if classes is None:
        raise ValueError("Keras model has no final Dense layer; cannot "
                         "determine the class count")
    return KerasModelConfig(input_length=input_length, num_classes=classes)


def _inbound_node_refs(inbound_nodes) -> List[List[Tuple[str, int, int]]]:
    """Normalise Keras 2 / Keras 3 inbound nodes → per-call reference lists.

    Returns one entry per node (= per call of the layer); each entry lists
    the ``(layer_name, node_index, tensor_index)`` tensors that call
    consumes.  Keras 2 stores ``[[name, node, tensor, kwargs], ...]`` lists;
    Keras 3 stores dicts whose keras_history triples carry the same data.
    """
    nodes: List[List[Tuple[str, int, int]]] = []
    for node in inbound_nodes or []:
        names: List[Tuple[str, int, int]] = []
        if isinstance(node, dict):  # Keras 3: {"args": [...], "kwargs": ...}
            def walk(obj):
                if isinstance(obj, dict):
                    if obj.get("class_name") == "__keras_tensor__":
                        history = obj["config"]["keras_history"]
                        names.append(
                            (history[0], int(history[1]), int(history[2]))
                        )
                    else:
                        for value in obj.values():
                            walk(value)
                elif isinstance(obj, (list, tuple)):
                    for item in obj:
                        walk(item)
            walk(node)
        else:  # Keras 2: [[name, node_idx, tensor_idx, kwargs], ...]
            for ref in node:
                names.append((ref[0], int(ref[1]), int(ref[2])))
        nodes.append(names)
    return nodes


def _read_weights(handle) -> Weights:
    import h5py

    group = handle["model_weights"] if "model_weights" in handle else handle
    weights: Weights = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            layer = name.split("/")[0]
            weights.setdefault(layer, {})[name] = np.asarray(obj[()])

    group.visititems(visit)
    return weights


def load_keras_model(path: str) -> Tuple[KerasGraphModel, KerasModelConfig,
                                         Dict[str, Any]]:
    """Load a Keras HDF5 model → (graph on the CPU, config, metadata).

    The return signature is :func:`~deepbinner_tpu_torch.models.checkpoint.load_model`'s
    for `.dbt` files.
    """
    import h5py

    with h5py.File(path, "r") as handle:
        raw = handle.attrs.get("model_config")
        if raw is None:
            raise ValueError(f"{path} has no model_config attr — not a Keras "
                             f"model file")
        if isinstance(raw, bytes):
            raw = raw.decode()
        model_config = json.loads(raw)
        weights = _read_weights(handle)
        keras_version = handle.attrs.get("keras_version", "?")
        if isinstance(keras_version, bytes):
            keras_version = keras_version.decode()

    model = KerasGraphModel(model_config, weights).eval()
    metadata = {"keras_version": str(keras_version), "source_file": path}
    return model, model.config, metadata
