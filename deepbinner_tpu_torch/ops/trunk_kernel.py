"""The conv trunk after stem1 as one kernel launch: the port of the Pallas megakernel.

Counterpart of ``deepbinner_tpu/models/pallas_apply.py::_mega_kernel``,
``_run_segment``, ``_segment_spec`` and ``_mega_unit_scopes``.  One call of
:func:`trunk_segment` runs a named segment of DemuxNet's trunk (stem2
through the global average pool, or a part of it) on a batch of windows:

- on a CUDA tensor it launches the hand-written kernel
  ``csrc/trunk_megakernel.cu`` once (built by :mod:`.kernel_build`, bound
  with ctypes) or raises; nothing falls back;
- on a CPU tensor it runs :func:`trunk_segment_reference`, the plain
  PyTorch version of the same function, which is also the oracle the
  kernel is held against on the card.

The kernel picks its own tiling (one block per window, early units in row
tiles with recomputed halos), so the Pallas path's batch-tile arguments
have no counterpart here.  Every unit's folded weights live in one device
buffer (:class:`PackedTrunk`), built once by :func:`pack_trunk`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Tuple

import torch

from deepbinner_tpu_torch.models.network import pool3_same
from deepbinner_tpu_torch.ops import kernel_build
from deepbinner_tpu_torch.ops.conv_kernel import conv1d_bn_relu_reference

# Launches of the CUDA kernel in this process.  Only the launch site below
# adds to it; a run reads it before and after to show which path it took.
LAUNCHES = 0

_KERNEL = "trunk_megakernel"
SEGMENTS = ("all", "early", "late", "inc0", "late1")

Unit = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # kernel, scale, bias


def segment_spec(config, segment: str) -> Tuple[bool, int, int, bool]:
    """(early, inc_lo, inc_hi, head) for a named trunk segment.

    - "all":   stem2 → head_conv → global average pool;
    - "early": stem2 + blocks (ends at the last block pool);
    - "late":  inception stack → head_conv → global average pool;
    - "inc0":  inception 0 only;
    - "late1": inceptions 1.. → head_conv → global average pool.
    """
    n_inc = len(config.inception_features)
    return {
        "all": (True, 0, n_inc, True),
        "early": (True, 0, 0, False),
        "late": (False, 0, n_inc, True),
        "inc0": (False, 0, 1, False),
        "late1": (False, 1, n_inc, True),
    }[segment]


def mega_unit_scopes(config, segment: str = "all") -> List[Tuple[str, int]]:
    """(scope, dilation) of each unit in kernel execution order (stem1 excluded)."""
    early, inc_lo, inc_hi, head = segment_spec(config, segment)
    scopes = []
    if early:
        scopes.append(("stem2", 1))
        for i in range(len(config.block_features)):
            scopes += [(f"block{i}_conv1", 1), (f"block{i}_conv2", 1)]
    for i in range(inc_lo, inc_hi):
        scope = f"inception{i}"
        scopes += [(f"{scope}/branch1x1", 1), (f"{scope}/branch3", 1),
                   (f"{scope}/branch_dilated", 2 ** (i + 1)),
                   (f"{scope}/branch_pool", 1)]
    if head:
        scopes.append(("head_conv", 1))
    return scopes


def _unit_pools(scope: str) -> bool:
    """Whether the unit's epilogue ends with the stride-2 pool."""
    return not (scope.endswith("_conv1") or scope == "head_conv")


def _segment_pools(config, segment: str) -> int:
    """How many times the segment halves L."""
    early, inc_lo, inc_hi, _head = segment_spec(config, segment)
    return (1 + len(config.block_features) if early else 0) + (inc_hi - inc_lo)


def segment_input_channels(config, segment: str) -> int:
    early, inc_lo, _inc_hi, _head = segment_spec(config, segment)
    if early:
        return config.stem_features
    if inc_lo > 0:
        return config.inception_features[inc_lo - 1]
    return config.block_features[-1] if config.block_features else config.stem_features


def segment_output_shape(config, segment: str, n: int, length: int) -> Tuple[int, ...]:
    """Shape of the segment's output for an ``(n, length, C)`` input."""
    _early, inc_lo, inc_hi, head = segment_spec(config, segment)
    if head:
        return (n, config.head_features)
    if inc_hi > inc_lo:
        c_out = config.inception_features[inc_hi - 1]
    else:
        c_out = config.block_features[-1] if config.block_features else config.stem_features
    return (n, length // 2 ** _segment_pools(config, segment), c_out)


def trunk_segment_reference(x: torch.Tensor, units: Dict[str, Unit], config,
                            segment: str) -> torch.Tensor:
    """The plain version: the segment's units one by one, in f32."""
    early, inc_lo, inc_hi, head = segment_spec(config, segment)

    def unit(scope: str, x: torch.Tensor, dilation: int = 1,
             pool: bool = False) -> torch.Tensor:
        return conv1d_bn_relu_reference(x, *units[scope], dilation=dilation,
                                        pool=pool)

    x = x.float()
    if early:
        x = unit("stem2", x, pool=True)
        for i in range(len(config.block_features)):
            x = unit(f"block{i}_conv1", x)
            x = unit(f"block{i}_conv2", x, pool=True)
    for i in range(inc_lo, inc_hi):
        scope = f"inception{i}"
        x = torch.cat([
            unit(f"{scope}/branch1x1", x, pool=True),
            unit(f"{scope}/branch3", x, pool=True),
            unit(f"{scope}/branch_dilated", x, dilation=2 ** (i + 1), pool=True),
            unit(f"{scope}/branch_pool", pool3_same(x), pool=True),
        ], dim=-1)
    if head:
        return unit("head_conv", x).mean(dim=1)  # global average pool
    return x


@dataclasses.dataclass(frozen=True)
class PackedTrunk:
    """Every trunk unit's folded weights in one f32 buffer on one device."""

    units: Dict[str, Unit]                 # scope → (kernel, scale, bias)
    params: torch.Tensor                   # kernel, scale, bias of each unit
    offsets: Dict[str, Tuple[int, int]]    # scope → (kernel, scale) offset


def pack_trunk(config, units: Dict[str, Unit]) -> PackedTrunk:
    """Pack the units of the whole trunk ("all") into one buffer, once.

    Each unit's kernel starts on a 16-byte boundary (the kernel copies it
    with float4 loads); its scale follows the kernel and its bias the scale.
    """
    parts, offsets, at = [], {}, 0
    for scope, _dilation in mega_unit_scopes(config, "all"):
        kernel, scale, bias = units[scope]
        pad = -at % 4
        if pad:
            parts.append(kernel.new_zeros(pad, dtype=torch.float32))
            at += pad
        offsets[scope] = (at, at + kernel.numel())
        for t in (kernel, scale, bias):
            parts.append(t.detach().float().reshape(-1))
            at += t.numel()
    params = torch.cat(parts).contiguous() if parts else torch.zeros(0)
    return PackedTrunk(units, params, offsets)


def _unit_table(packed: PackedTrunk, config, segment: str) -> List[int]:
    """Seven ints per unit, in the order csrc/trunk_megakernel.cu reads them."""
    table = []
    for scope, dilation in mega_unit_scopes(config, segment):
        taps, c_in, c_out = packed.units[scope][0].shape
        kernel_at, scale_at = packed.offsets[scope]
        table += [c_in, c_out, taps, dilation, int(_unit_pools(scope)), kernel_at,
                  scale_at]
    return table


def _check_input(x: torch.Tensor, config, segment: str) -> None:
    if x.dim() != 3:
        raise ValueError(f"expected x (N, L, C), got {tuple(x.shape)}")
    c_in = segment_input_channels(config, segment)
    if x.shape[2] != c_in:
        raise ValueError(f"segment {segment!r} takes {c_in} channels, got "
                         f"{x.shape[2]}")
    pools = _segment_pools(config, segment)
    if x.shape[1] % (2 ** pools):
        raise ValueError(f"segment {segment!r} pools {pools} times; length "
                         f"{x.shape[1]} is not a multiple of {2 ** pools}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's C entry points, built and bound on first use."""
    lib = kernel_build.load(_KERNEL)
    # Every pointer and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit int and cut the address.
    lib.deepbinner_trunk_segment.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p])
    lib.deepbinner_trunk_segment.restype = ctypes.c_int
    lib.deepbinner_trunk_smem_bytes.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int])
    lib.deepbinner_trunk_smem_bytes.restype = ctypes.c_longlong
    return lib


def _plan_args(packed: PackedTrunk, config, segment: str, length: int,
               c_in: int) -> tuple:
    early, inc_lo, inc_hi, head = segment_spec(config, segment)
    n_early = 1 + 2 * len(config.block_features) if early else 0
    table = _unit_table(packed, config, segment)
    ints = (ctypes.c_int * len(table))(*table)
    return (length, c_in, n_early, inc_hi - inc_lo, int(head), ints,
            len(table) // 7)


def shared_memory_bytes(packed: PackedTrunk, config, segment: str,
                        length: int) -> int:
    """Dynamic shared memory one block of the kernel takes for a segment."""
    c_in = segment_input_channels(config, segment)
    return int(_library().deepbinner_trunk_smem_bytes(
        *_plan_args(packed, config, segment, length, c_in)))


def trunk_segment(x: torch.Tensor, packed: PackedTrunk, config,
                  segment: str) -> torch.Tensor:
    """One named trunk segment over ``(N, L, C)`` float32 windows.

    Returns ``(N, head_features)`` for the segments that end at the global
    average pool ("all", "late", "late1"), else the ``(N, L', C')``
    activation.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel once.
    """
    if segment not in SEGMENTS:
        raise ValueError(f"unknown segment {segment!r}; one of {SEGMENTS}")
    _check_input(x, config, segment)
    if x.device.type == "cpu":
        return trunk_segment_reference(x, packed.units, config, segment)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("x", x), ("params", packed.params)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, length, c_in = x.shape
    out = torch.empty(segment_output_shape(config, segment, n, length),
                      dtype=torch.float32, device=x.device)
    launch = _library().deepbinner_trunk_segment
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(x.data_ptr(), packed.params.data_ptr(), out.data_ptr(), n,
                    *_plan_args(packed, config, segment, length, c_in), stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
