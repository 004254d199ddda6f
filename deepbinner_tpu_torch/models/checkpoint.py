"""The `.dbt` model file, read and written without flax or msgpack.

Counterpart of ``deepbinner_tpu/models/checkpoint.py`` (``load_model``,
``save_model``).  A
`.dbt` file is a zip archive holding ``config.json`` (NetworkConfig, format
version, metadata) and ``params.msgpack``, the flax variables tree
(``params`` + ``batch_stats``) as written by ``flax.serialization.to_bytes``.

The machine with the card has no ``msgpack`` package, so this module
decodes the subset of MessagePack that flax writes: maps, arrays, str,
bin, nil, bools, ints, floats and ext type 1, flax's ndarray
(``packb([shape, dtype name, raw bytes])``), and encodes the same subset
as ``msgpack.packb`` does (:func:`msgpack_dumps`).  :func:`from_flax_variables`
maps the numpy tree onto :class:`DemuxNet`'s parameters, and
:func:`to_flax_variables` maps them back; the tests use them to give both
packages the same weights.  :func:`load_model` hands a Keras HDF5 file
(sniffed by its magic bytes) to
:func:`~deepbinner_tpu_torch.models.keras_import.load_keras_model`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import zipfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from deepbinner_tpu_torch.models.network import DemuxNet, NetworkConfig, unit_scopes

FORMAT_VERSION = 1
_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"
_EXT_NDARRAY = 1


class _Reader:
    """A cursor over one MessagePack buffer."""

    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, size: int) -> memoryview:
        end = self.pos + size
        if end > len(self.data):
            raise ValueError("msgpack data truncated")
        chunk = self.data[self.pos : end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode(reader: _Reader) -> Any:
    tag = reader.unpack(">B")
    if tag <= 0x7F:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if 0x80 <= tag <= 0x8F:
        return _decode_map(reader, tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
        return [_decode(reader) for _ in range(tag & 0x0F)]
    if 0xA0 <= tag <= 0xBF:
        return bytes(reader.take(tag & 0x1F)).decode()
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if tag in simple:
        return simple[tag]
    sized = {
        0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
        0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
        0xDC: (">H", "array"), 0xDD: (">I", "array"),
        0xDE: (">H", "map"), 0xDF: (">I", "map"),
    }
    if tag in sized:
        fmt, kind = sized[tag]
        size = reader.unpack(fmt)
        if kind == "bin":
            return bytes(reader.take(size))
        if kind == "str":
            return bytes(reader.take(size)).decode()
        if kind == "array":
            return [_decode(reader) for _ in range(size)]
        if kind == "map":
            return _decode_map(reader, size)
        return _decode_ext(reader.unpack(">b"), bytes(reader.take(size)))
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if tag in fixext:
        code = reader.unpack(">b")
        return _decode_ext(code, bytes(reader.take(fixext[tag])))
    numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if tag in numbers:
        return reader.unpack(numbers[tag])
    raise ValueError(f"unsupported msgpack tag 0x{tag:02x}")


def _decode_map(reader: _Reader, size: int) -> dict:
    out = {}
    for _ in range(size):
        key = _decode(reader)
        out[key] = _decode(reader)
    return out


def _decode_ext(code: int, payload: bytes) -> np.ndarray:
    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, raw = msgpack_loads(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def msgpack_loads(data: bytes) -> Any:
    """Decode one MessagePack object (the subset flax writes)."""
    reader = _Reader(data)
    value = _decode(reader)
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes "
                         f"after the msgpack object")
    return value


def _encode(value: Any, out: bytearray) -> None:
    """Append ``value`` as MessagePack in ``msgpack.packb``'s choice of forms."""
    if value is None:
        out += b"\xc0"
    elif isinstance(value, bool):
        out += b"\xc3" if value else b"\xc2"
    elif isinstance(value, int):
        if 0 <= value < 0x80 or -0x20 <= value < 0:
            out += struct.pack(">b" if value < 0 else ">B", value)
        elif value >= 0:
            for tag, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                  (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if value < top:
                    out += bytes([tag]) + struct.pack(fmt, value)
                    break
            else:
                raise ValueError(f"integer {value} does not fit msgpack")
        else:
            for tag, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                                  (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
                if value >= low:
                    out += bytes([tag]) + struct.pack(fmt, value)
                    break
            else:
                raise ValueError(f"integer {value} does not fit msgpack")
    elif isinstance(value, float):
        out += b"\xcb" + struct.pack(">d", value)
    elif isinstance(value, str):
        raw = value.encode()
        _encode_head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(value, (bytes, bytearray, memoryview)):
        raw = bytes(value)
        _encode_head(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(value, (list, tuple)):
        _encode_head(out, len(value), 0x90, 16, (None, 0xDC, 0xDD))
        for item in value:
            _encode(item, out)
    elif isinstance(value, dict):
        _encode_head(out, len(value), 0x80, 16, (None, 0xDE, 0xDF))
        for key, item in value.items():
            _encode(key, out)
            _encode(item, out)
    elif isinstance(value, np.ndarray):
        if value.dtype.hasobject or value.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be written")
        payload = msgpack_dumps([list(value.shape), value.dtype.name,
                                 value.tobytes("C")])
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(payload) in fixext:
            out.append(fixext[len(payload)])
        else:
            _encode_head(out, len(payload), None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY) + payload
    else:
        raise TypeError(f"cannot write {type(value).__name__} as msgpack")


def _encode_head(out: bytearray, size: int, fix: int | None, fix_limit: int,
                 tags: Tuple[int | None, int, int]) -> None:
    """A container or string header: the fix form below ``fix_limit``, else
    the 8-, 16- or 32-bit size form (a ``None`` tag has no such form)."""
    if fix is not None and size < fix_limit:
        out.append(fix | size)
        return
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and size < top:
            out += bytes([tag]) + struct.pack(fmt, size)
            return
    raise ValueError(f"{size} items or bytes do not fit msgpack")


def msgpack_dumps(value: Any) -> bytes:
    """Encode one object as ``msgpack.packb`` with flax's ndarray hook does:
    numpy arrays become ext type 1 (``[shape, dtype name, raw bytes]``)."""
    out = bytearray()
    _encode(value, out)
    return bytes(out)


def _config_to_json(config: NetworkConfig, metadata: Dict[str, Any]) -> str:
    """``config.json`` as the JAX package writes it (f32 models only)."""
    payload = dataclasses.asdict(config)
    payload["compute_dtype"] = "float32"
    return json.dumps(
        {"format_version": FORMAT_VERSION, "network": payload, "metadata": metadata},
        indent=2,
        sort_keys=True,
    )


def _config_from_json(text: str) -> Tuple[NetworkConfig, Dict[str, Any]]:
    payload = json.loads(text)
    if payload.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported .dbt format version "
                         f"{payload.get('format_version')!r}")
    net = dict(payload["network"])
    dtype = net.pop("compute_dtype", "float32")
    if dtype != "float32":
        raise ValueError(f"the port runs float32 models only, got {dtype}")
    net["block_features"] = tuple(net["block_features"])
    net["inception_features"] = tuple(net["inception_features"])
    return NetworkConfig(**net), payload.get("metadata", {})


def from_flax_variables(config: NetworkConfig, variables: dict
                        ) -> Dict[str, torch.Tensor]:
    """A flax variables tree of numpy arrays → :class:`DemuxNet` state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    state: Dict[str, torch.Tensor] = {}
    for scope in unit_scopes(config):
        node_p, node_s = params, stats
        for part in scope.split("/"):
            node_p, node_s = node_p[part], node_s[part]
        name = scope.replace("/", ".")
        leaves = {
            "kernel": node_p["conv"]["kernel"],
            "scale": node_p["bn"]["scale"],
            "bias": node_p["bn"]["bias"],
            "mean": node_s["bn"]["mean"],
            "var": node_s["bn"]["var"],
        }
        for leaf, value in leaves.items():
            state[f"{name}.{leaf}"] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    dense = params["classifier"]
    state["classifier.weight"] = torch.from_numpy(
        np.array(dense["kernel"], dtype=np.float32).T.copy())
    state["classifier.bias"] = torch.from_numpy(
        np.array(dense["bias"], dtype=np.float32))
    return state


def to_flax_variables(model: DemuxNet) -> dict:
    """:class:`DemuxNet`'s parameters → the flax variables tree of numpy
    arrays (the inverse of :func:`from_flax_variables`).

    Keys are sorted below ``params`` and ``batch_stats``, as
    ``jax.device_get`` leaves the JAX trainer's exported tree, so a model
    read from a shipped `.dbt` writes that file's ``params.msgpack`` again
    byte for byte.
    """

    def leaf(tensor: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(tensor.detach().cpu().numpy(),
                                    dtype=np.float32)

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for scope in unit_scopes(model.config):
        unit = model.get_submodule(scope.replace("/", "."))
        node_p, node_s = params, stats
        for part in scope.split("/"):
            node_p = node_p.setdefault(part, {})
            node_s = node_s.setdefault(part, {})
        node_p["conv"] = {"kernel": leaf(unit.kernel)}
        node_p["bn"] = {"scale": leaf(unit.scale), "bias": leaf(unit.bias)}
        node_s["bn"] = {"mean": leaf(unit.mean), "var": leaf(unit.var)}
    params["classifier"] = {
        "kernel": np.ascontiguousarray(leaf(model.classifier.weight).T),
        "bias": leaf(model.classifier.bias),
    }
    return {"params": _sorted_tree(params), "batch_stats": _sorted_tree(stats)}


def _sorted_tree(node: Any) -> Any:
    if isinstance(node, dict):
        return {key: _sorted_tree(node[key]) for key in sorted(node)}
    return node


def model_from_flax_variables(config: NetworkConfig, variables: dict) -> DemuxNet:
    """A :class:`DemuxNet` on the CPU holding the weights of a flax tree."""
    model = DemuxNet(config)
    model.load_state_dict(from_flax_variables(config, variables))
    return model.eval()


def is_keras_hdf5(path: str | os.PathLike) -> bool:
    try:
        with open(path, "rb") as handle:
            return handle.read(8) == _HDF5_MAGIC
    except OSError:
        return False


def save_model(
    path: str | os.PathLike,
    config: NetworkConfig,
    variables: dict,
    metadata: Dict[str, Any] | None = None,
) -> None:
    """Write a `.dbt` archive of a flax variables tree (tmp file + rename).

    ``variables`` is :func:`to_flax_variables`'s tree; the JAX package's
    ``load_model`` reads the file.
    """
    path = os.fspath(path)
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as archive:
        archive.writestr("config.json", _config_to_json(config, metadata or {}))
        archive.writestr("params.msgpack", msgpack_dumps(variables))
    os.replace(tmp, path)


def load_model(path: str | os.PathLike) -> Tuple[Any, Any, Dict[str, Any]]:
    """Load a model file → (model on the CPU, config, metadata).

    A `.dbt` archive gives a :class:`DemuxNet` and its
    :class:`NetworkConfig`; a Keras HDF5 file a
    :class:`~deepbinner_tpu_torch.models.keras_import.KerasGraphModel` and
    its ``KerasModelConfig``.
    """
    path = os.fspath(path)
    if is_keras_hdf5(path):
        from deepbinner_tpu_torch.models import keras_import

        return keras_import.load_keras_model(path)
    with zipfile.ZipFile(path, "r") as archive:
        config, metadata = _config_from_json(archive.read("config.json").decode())
        raw = archive.read("params.msgpack")
    return model_from_flax_variables(config, msgpack_loads(raw)), config, metadata
