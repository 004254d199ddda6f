"""Plain reference of a classify run: raw read ends in, calls out.

Everything the classify stream does that changes a number, written again
in plain numpy and PyTorch, from the raw signals the benchmark generated:

- the host path: open-pore trim of each read end's first ``trim_scan +
  scan_size`` samples (the end reversed) and int8 wire quantisation, a
  frozen copy of ``trim_starts_batch`` and ``quantise_wire`` in
  ``deepbinner_tpu_torch/runner/hostbatch.py``, the batch geometry of
  ``cli/classify.build_program`` and the pool workers' head/tail slices;
- the device path: masking, windowing and per-window z-score
  (``ops/preprocess.py``), DemuxNet (``models/network.py``: conv, BatchNorm
  on its running statistics, ReLU, the stage max pools, the inception
  branches, global average pool, dense layer, softmax) on ``F.conv1d`` in
  float32 with TF32 off;

all at commit 402717dbde1c47220f6674dc523b70c64264754a.  The weights are
read from the ``.dbt`` files themselves (a zip of ``config.json`` and flax's
msgpack; the msgpack subset is decoded here).  Combining the windows and the
calling rules are in ``benchmark/compare.py``.  Nothing of
``deepbinner_tpu_torch`` or ``deepbinner_tpu`` is imported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import struct
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np

BN_EPSILON = 1e-3
WIRE_SCALE = 16.0  # int8 wire: one step is 1/16 of the read end's std


# ------------------------------------------------------------ .dbt files

def _decode(data: memoryview, pos: int) -> Tuple[Any, int]:
    """One MessagePack object at ``pos`` (the subset flax writes)."""
    tag = data[pos]
    pos += 1
    if tag <= 0x7F:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if 0x80 <= tag <= 0x8F:
        return _decode_map(data, pos, tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
        return _decode_array(data, pos, tag & 0x0F)
    if 0xA0 <= tag <= 0xBF:
        end = pos + (tag & 0x1F)
        return bytes(data[pos:end]).decode(), end
    if tag in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[tag], pos
    sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
             0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
             0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
             0xDC: (">H", "array"), 0xDD: (">I", "array"),
             0xDE: (">H", "map"), 0xDF: (">I", "map")}
    if tag in sized:
        fmt, kind = sized[tag]
        (size,) = struct.unpack_from(fmt, data, pos)
        pos += struct.calcsize(fmt)
        if kind == "array":
            return _decode_array(data, pos, size)
        if kind == "map":
            return _decode_map(data, pos, size)
        if kind == "ext":
            (code,) = struct.unpack_from(">b", data, pos)
            pos += 1
            return _ext(code, bytes(data[pos:pos + size])), pos + size
        raw = bytes(data[pos:pos + size])
        return (raw if kind == "bin" else raw.decode()), pos + size
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if tag in fixext:
        (code,) = struct.unpack_from(">b", data, pos)
        end = pos + 1 + fixext[tag]
        return _ext(code, bytes(data[pos + 1:end])), end
    numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if tag in numbers:
        (value,) = struct.unpack_from(numbers[tag], data, pos)
        return value, pos + struct.calcsize(numbers[tag])
    raise ValueError(f"unsupported msgpack tag 0x{tag:02x}")


def _decode_array(data, pos, size):
    out = []
    for _ in range(size):
        value, pos = _decode(data, pos)
        out.append(value)
    return out, pos


def _decode_map(data, pos, size):
    out = {}
    for _ in range(size):
        key, pos = _decode(data, pos)
        out[key], pos = _decode(data, pos)
    return out, pos


def _ext(code: int, payload: bytes) -> np.ndarray:
    if code != 1:  # flax's ndarray: [shape, dtype name, raw bytes]
        raise ValueError(f"unsupported msgpack ext type {code}")
    (shape, dtype, raw), _ = _decode(memoryview(payload), 0)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def load_dbt(path: str) -> Tuple[dict, dict]:
    """A ``.dbt`` file → (its ``network`` config, flax's variables tree)."""
    with zipfile.ZipFile(path) as archive:
        config = json.loads(archive.read("config.json"))["network"]
        variables, _ = _decode(memoryview(archive.read("params.msgpack")), 0)
    if config.get("compute_dtype", "float32") != "float32":
        raise ValueError(f"{path}: a float32 model is expected")
    return config, variables


# ------------------------------------------------------------ geometry

@dataclasses.dataclass(frozen=True)
class Geometry:
    """What the classify stream does with each read end."""

    scan_size: int
    window: int
    stride: int
    trim_scan: int
    batch_size: int
    trim_window: int = 64
    trim_stride: int = 16
    trim_threshold: float = 0.25

    @property
    def raw_size(self) -> int:
        return self.trim_scan + self.scan_size

    @property
    def num_windows(self) -> int:
        return (self.scan_size - self.window) // self.stride + 1


def geometry(classify: dict, input_length: int) -> Geometry:
    """The CLI's geometry: stride half a window, the scan size rounded up
    to whole strides, trim search over at most 2048 samples."""
    window = input_length
    stride = max(window // 2, 1)
    scan = classify["scan_size"]
    if (scan - window) % stride:
        scan = window + ((scan - window + stride - 1) // stride) * stride
    return Geometry(scan_size=scan, window=window, stride=stride,
                    trim_scan=min(2048, scan),
                    batch_size=classify["batch_size"])


# ------------------------------------------------------------ host path

def trim_starts(raw: np.ndarray, lengths: np.ndarray, g: Geometry) -> np.ndarray:
    """Where each zero-padded row's read signal begins: the first window
    of ``trim_window`` samples (every ``trim_stride``) whose std reaches
    ``trim_threshold`` of the valid samples' std; never so far that fewer
    than ``window`` samples remain."""
    t = min(g.trim_scan, raw.shape[1])
    region = raw[:, :t].astype(np.float32)
    valid_i = np.clip(lengths, 0, t).astype(np.int64)
    valid = valid_i.astype(np.float32)[:, None]
    denom = np.maximum(valid, 1.0)
    n_out = (t - g.trim_window) // g.trim_stride + 1
    if n_out <= 0:
        return np.zeros(raw.shape[0], np.int64)
    zeros = np.zeros((raw.shape[0], 1), np.float32)
    c1 = np.concatenate([zeros, np.cumsum(region, axis=1)], axis=1)
    c2 = np.concatenate([zeros, np.cumsum(region * region, axis=1)], axis=1)
    rows = np.arange(raw.shape[0])
    mean = c1[rows, valid_i][:, None] / denom
    var = c2[rows, valid_i][:, None] / denom - mean * mean
    global_std = np.sqrt(np.maximum(var, 0.0))
    starts = np.arange(n_out) * g.trim_stride
    s1 = c1[:, starts + g.trim_window] - c1[:, starts]
    s2 = c2[:, starts + g.trim_window] - c2[:, starts]
    win_mean = s1 / g.trim_window
    win_std = np.sqrt(np.maximum(s2 / g.trim_window - win_mean * win_mean, 0.0))
    in_valid = (starts + g.trim_window)[None, :] <= valid
    good = (win_std >= g.trim_threshold * global_std) & in_valid
    start = np.where(good.any(axis=1), good.argmax(axis=1) * g.trim_stride, 0)
    return np.minimum(start, np.maximum(lengths - g.window, 0))


def quantise_int8(signal: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Z-score each row over its valid samples (sums in float64), times
    16, rounded and clipped to ±127; padding stays 0."""
    n_rows, t = signal.shape
    lens = np.clip(lengths[:n_rows], 0, t).astype(np.int64)
    n = np.maximum(lens, 1).astype(np.float64)
    x = signal.astype(np.float32)
    s1 = np.einsum("ij->i", x, dtype=np.float64)
    s2 = np.einsum("ij,ij->i", x, x, dtype=np.float64)
    mean = s1 / n
    var = np.maximum(s2 / n - mean * mean, 0.0)
    row_scale = (WIRE_SCALE / (np.sqrt(var) + 1e-8)).astype(np.float32)
    x -= mean.astype(np.float32)[:, None]
    x *= row_scale[:, None]
    np.rint(x, out=x)
    np.clip(x, -127.0, 127.0, out=x)
    for i in np.nonzero(lens < t)[0]:
        x[i, lens[i]:] = 0.0
    return x.astype(np.int8)


def wire_rows(ends: np.ndarray, sizes: np.ndarray, g: Geometry,
              reverse: bool) -> Tuple[np.ndarray, np.ndarray]:
    """One read end of each read as the card gets it: ``ends`` holds each
    read's first (or, ``reverse``, last) ``raw_size`` samples in read
    order; returns the int8 scan regions and their valid lengths."""
    k = np.minimum(sizes, g.raw_size)
    raw = np.zeros((ends.shape[0], g.raw_size), np.int16)
    for i, count in enumerate(k):
        raw[i, :count] = ends[i, :count][::-1] if reverse else ends[i, :count]
    offs = trim_starts(raw, k, g)
    scan = np.zeros((ends.shape[0], g.scan_size), np.int16)
    for i, o in enumerate(offs):
        scan[i] = raw[i, o:o + g.scan_size]
    lengths = np.clip(k - offs, 0, g.scan_size).astype(np.int32)
    return quantise_int8(scan, lengths), lengths


# ------------------------------------------------------------ device path

class DemuxNet:
    """DemuxNet's inference forward in plain PyTorch on ``(N, C, L)``."""

    def __init__(self, config: dict, variables: dict, device) -> None:
        import torch

        self.config = config
        params, stats = variables["params"], variables["batch_stats"]

        def tensor(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        def unit(*path):
            p, s = params, stats
            for part in path:
                p, s = p[part], s[part]
            # flax (K, C_in, C_out) → F.conv1d (C_out, C_in, K)
            return (tensor(p["conv"]["kernel"]).permute(2, 1, 0).contiguous(),
                    tensor(p["bn"]["scale"]), tensor(p["bn"]["bias"]),
                    tensor(s["bn"]["mean"]), tensor(s["bn"]["var"]))

        self.units = {"stem1": unit("stem1"), "stem2": unit("stem2")}
        for i in range(len(config["block_features"])):
            for conv in ("conv1", "conv2"):
                self.units[f"block{i}_{conv}"] = unit(f"block{i}_{conv}")
        for i in range(len(config["inception_features"])):
            for branch in ("branch1x1", "branch3", "branch_dilated",
                           "branch_pool"):
                self.units[f"inception{i}/{branch}"] = unit(f"inception{i}",
                                                            branch)
        self.units["head_conv"] = unit("head_conv")
        self.dense = (tensor(params["classifier"]["kernel"]),
                      tensor(params["classifier"]["bias"]))

    def _unit(self, scope: str, x, dilation: int = 1):
        import torch
        import torch.nn.functional as F

        kernel, gamma, beta, mean, var = self.units[scope]
        taps = kernel.shape[2]
        y = F.conv1d(x, kernel, padding=(taps - 1) // 2 * dilation,
                     dilation=dilation)
        y = ((y - mean[:, None]) * (gamma / torch.sqrt(var + BN_EPSILON))[:, None]
             + beta[:, None])
        return torch.relu(y)

    def probs(self, windows):
        """``(N, window)`` float32 → ``(N, classes)`` softmax probabilities."""
        import torch
        import torch.nn.functional as F

        x = F.max_pool1d(self._unit("stem2", self._unit("stem1",
                                                        windows[:, None, :])), 2)
        for i in range(len(self.config["block_features"])):
            x = self._unit(f"block{i}_conv1", x)
            x = F.max_pool1d(self._unit(f"block{i}_conv2", x), 2)
        for i in range(len(self.config["inception_features"])):
            scope = f"inception{i}"
            x = F.max_pool1d(torch.cat([
                self._unit(f"{scope}/branch1x1", x),
                self._unit(f"{scope}/branch3", x),
                self._unit(f"{scope}/branch_dilated", x, 2 ** (i + 1)),
                self._unit(f"{scope}/branch_pool",
                           F.max_pool1d(x, 3, stride=1, padding=1)),
            ], dim=1), 2)
        pooled = self._unit("head_conv", x).mean(dim=2)
        kernel, bias = self.dense
        return torch.softmax(pooled @ kernel + bias, dim=-1)


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 off (float32, the configuration's precision) or on (the
    control) for cuDNN and cuBLAS inside; the previous flags after."""
    import torch

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def windows_of(wire, lengths, g: Geometry, device):
    """int8 scan regions → normalised ``(B, W, window)`` windows and the
    ``(B, W)`` mask of windows inside the valid samples."""
    import torch

    signal = torch.as_tensor(wire, device=device).float()
    lengths = torch.as_tensor(lengths, device=device)
    positions = torch.arange(g.scan_size, device=device)[None, :]
    signal = signal * (positions < lengths[:, None])
    windows = signal.unfold(1, g.window, g.stride)[:, : g.num_windows]
    mean = windows.mean(dim=-1, keepdim=True)
    std = windows.std(dim=-1, keepdim=True, correction=0)
    windows = (windows - mean) / (std + 1e-8)
    ends = torch.arange(g.num_windows, device=device) * g.stride + g.window
    mask = ends[None, :] <= torch.clamp(lengths, 0, g.scan_size)[:, None]
    return windows, mask


class Reference:
    """A configuration's classify run, worked out again: per read end, the
    window probabilities ``(n, W, C)`` and the window mask ``(n, W)``."""

    def __init__(self, config: dict, root: str, device="cuda",
                 tf32: bool = False) -> None:
        self.device = device
        self.tf32 = tf32
        self.nets: List[DemuxNet] = []
        network: Optional[dict] = None
        for key in ("start_model", "end_model"):
            if config.get(key):
                net_config, variables = load_dbt(os.path.join(root, config[key]))
                if network is not None and net_config != network:
                    raise ValueError("start and end models differ in shape")
                network = net_config
                self.nets.append(DemuxNet(net_config, variables, device))
        self.geometry = geometry(config["classify"], network["input_length"])

    def window_probs(self, heads: np.ndarray, tails: np.ndarray,
                     sizes: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        """[(probs, mask)] for the start end, and the end end of a dual
        configuration, in blocks of ``batch_size`` reads."""
        import torch

        g = self.geometry
        out: List[Tuple[np.ndarray, np.ndarray]] = []
        for net, ends, reverse in zip(self.nets, (heads, tails), (False, True)):
            probs, masks = [], []
            for lo in range(0, ends.shape[0], g.batch_size):
                hi = min(lo + g.batch_size, ends.shape[0])
                wire, lengths = wire_rows(ends[lo:hi], sizes[lo:hi], g, reverse)
                with torch.inference_mode(), precision(self.tf32):
                    windows, mask = windows_of(wire, lengths, g, self.device)
                    p = net.probs(windows.reshape(-1, g.window))
                probs.append(p.reshape(hi - lo, g.num_windows, -1).cpu().numpy())
                masks.append(mask.cpu().numpy())
            out.append((np.concatenate(probs), np.concatenate(masks)))
        return out


def network_of(config: dict, root: str) -> dict:
    """The start model's ``network`` config, read from its ``.dbt``."""
    with zipfile.ZipFile(os.path.join(root, config["start_model"])) as archive:
        return json.loads(archive.read("config.json"))["network"]
