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

The kernel's tiling is fixed (one block per window, early units in row
tiles with recomputed halos), so the Pallas path's batch-tile arguments
have no counterpart here; how many rows each thread takes in each unit is
planned here, by :func:`plan_segment`, and handed to the kernel with the
unit table.  Every unit's folded weights live in one device buffer
(:class:`PackedTrunk`), built once by :func:`pack_trunk`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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

# The kernel's constants (csrc/trunk_megakernel.cu); a test reads each one
# from the source.
THREADS = 512           # kThreads: one block of this many threads per window
TILE = 32               # kTile: early-output rows per tile
SLACK = 8               # kSlack: rows a row tile may read past a buffer
W_FLOATS = 16384        # kWFloats: the weight stage, in floats
UNIT_INTS = 8           # kUnitInts: ints per unit in the C interface's table
SMEM_LIMIT = 232_448    # kMaxSmem: dynamic shared memory a block may take
# Rows per thread the kernel was built for (DEEPBINNER_TRUNK_ROW_TILES), and
# the (taps, dilation) pairs with a "window" loop (path_of); every other
# pair takes the "generic" loop, and an inception's pool branch "pool3".
ROW_TILES = (2, 4, 6, 8)
WINDOW_TAPS = frozenset({(1, 1), (3, 1), (3, 2), (3, 4)})


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


class UnitGeometry(NamedTuple):
    """One unit of the trunk as the kernel sees it."""

    scope: str
    c_in: int
    c_out: int
    taps: int
    dilation: int
    pool: bool


def segment_geometry(config, segment: str) -> List[UnitGeometry]:
    """Each unit of a segment in kernel execution order (the order of
    :func:`mega_unit_scopes`), with the widths network.DemuxNet gives it."""
    early, inc_lo, inc_hi, head = segment_spec(config, segment)
    width = segment_input_channels(config, segment)
    units: List[UnitGeometry] = []

    def add(scope: str, c_out: int, taps: int, dilation: int = 1) -> None:
        units.append(UnitGeometry(scope, width, c_out, taps, dilation,
                                  _unit_pools(scope)))

    if early:
        add("stem2", config.stem_features, 3)
        width = config.stem_features
        for i, features in enumerate(config.block_features):
            add(f"block{i}_conv1", features, 3)
            width = features
            add(f"block{i}_conv2", features, 3)
    for i in range(inc_lo, inc_hi):
        features = config.inception_features[i]
        quarter = features // 4
        scope = f"inception{i}"
        add(f"{scope}/branch1x1", quarter, 1)
        add(f"{scope}/branch3", features - 3 * quarter, 3)
        add(f"{scope}/branch_dilated", quarter, 3, 2 ** (i + 1))
        add(f"{scope}/branch_pool", quarter, 1)
        width = features
    if head:
        add("head_conv", config.head_features, 3)
    return units


class UnitPlan(NamedTuple):
    """One pass of the kernel: a unit, or an inception's four branches.

    ``lanes`` is the share of the block's thread-rows that compute a row of
    the pass: rows × 4-channel groups over passes × row_tile × threads.
    ``useful`` is the share of those rows that lie in the early tile's own
    rows rather than its recomputed halo (1 for the late units).
    """

    units: Tuple[UnitGeometry, ...]
    paths: Tuple[str, ...]  # "window", "generic" or "pool3", per unit
    row_tile: int           # RT: rows per thread
    rows: int               # pre-pool rows the pass computes (per early tile)
    items: int              # (unit, row tile, 4-channel group) items
    passes: int             # rounds of `threads` items
    lanes: float
    useful: float
    flops: int              # the units' FLOPs per window

    @property
    def scopes(self) -> Tuple[str, ...]:
        return tuple(u.scope for u in self.units)


class SegmentPlan(NamedTuple):
    """What one launch of the kernel runs for a segment."""

    tile: int                   # early-output rows per tile
    threads: int                # threads per block
    units: Tuple[UnitPlan, ...]
    smem_bytes: int             # dynamic shared memory per block
    lanes: float                # FLOP-weighted lanes used (weighted_lanes)


def _path(unit: UnitGeometry, pool3: bool) -> str:
    if pool3:
        return "pool3"
    return "window" if (unit.taps, unit.dilation) in WINDOW_TAPS else "generic"


def _loads(row_tile: int, unit: UnitGeometry, path: str) -> int:
    """Shared-memory loads per input channel of one item on its loop."""
    if path == "pool3":
        return row_tile + 2 + unit.taps
    if path == "window":
        return row_tile + (unit.taps - 1) * unit.dilation + unit.taps
    return unit.taps * (row_tile + 1)


def plan_pass(units: Sequence[UnitGeometry], rows: int, useful: float,
              row_tiles: Sequence[int] = ROW_TILES,
              threads: int = THREADS) -> UnitPlan:
    """The row tile of one pass over ``rows`` pre-pool rows.

    Picks the RT of ``row_tiles`` (even where the pass pools) that
    minimises passes × RT / e(RT), where e(RT) is the share of FMAs among
    the inner loops' FMAs and shared-memory loads: the time of the pass in
    issued instructions per thread, up to a constant.  On a tie the larger
    RT.  Raises ``ValueError`` when no row tile fits.

    The formula is a count, not a model calibrated on the card: it fills
    the block's lanes, but a late pass at full lanes and a small RT can
    lose to one at half lanes and a larger RT (PERF.md §6).
    """
    pool = units[0].pool
    inception = len(units) == 4
    paths = tuple(_path(u, inception and i == 3) for i, u in enumerate(units))
    groups = [-(-u.c_out // 4) for u in units]
    best = None
    for rt in row_tiles:
        if pool and rt % 2:
            continue
        items = -(-rows // rt) * sum(groups)
        passes = -(-items // threads)
        fmas = sum(g * 4 * rt * u.taps for g, u in zip(groups, units))
        loads = sum(g * _loads(rt, u, p)
                    for g, u, p in zip(groups, units, paths))
        key = (passes * rt * (fmas + loads) / fmas, -rt)
        if best is None or key < best[0]:
            best = (key, rt, items, passes)
    if best is None:
        raise ValueError(f"no row tile of {tuple(row_tiles)} fits "
                         f"{[u.scope for u in units]}")
    _key, rt, items, passes = best
    lanes = rows * sum(groups) / (passes * rt * threads)
    return UnitPlan(tuple(units), paths, rt, rows, items, passes, lanes,
                    useful, 0)


def weighted_lanes(units: Sequence[UnitPlan]) -> float:
    """Useful FLOPs over the FLOPs the block's lanes could do in the time
    the passes take: Σ flops / Σ flops / (lanes × useful)."""
    return (sum(u.flops for u in units)
            / sum(u.flops / (u.lanes * u.useful) for u in units))


def _round4(v: int) -> int:
    return (v + 3) & ~3


def _halo(unit: UnitGeometry) -> int:
    return (unit.taps - 1) // 2 * unit.dilation


def _early_rows(early: Sequence[UnitGeometry]) -> List[Tuple[int, int]]:
    """(a, b) input rows of each early unit for the tile [0, TILE): the C
    side's make_plan and tile loop walk them from the last unit back."""
    spans = [(0, 0)] * len(early)
    a, b = 0, TILE
    for i in reversed(range(len(early))):
        h = _halo(early[i])
        a, b = (2 * a - h, 2 * b + h) if early[i].pool else (a - h, b + h)
        spans[i] = (a, b)
    return spans


def _smem_bytes(groups: Sequence[Sequence[UnitGeometry]], n_early: int,
                head: bool, length: int, c_in0: int) -> int:
    """make_plan's shared-memory layout: the unit table, the weight stage,
    then the buffers p0 and p1 (p1 shared by the early tile's two)."""
    units = [u for group in groups for u in group]
    early = units[:n_early]
    incs = [g for g in groups if len(g) == 4]
    w_floats = _round4(min(W_FLOATS, max(
        sum(u.taps * _round4(u.c_out) for u in g) * g[0].c_in for g in groups)))
    a_need = b_need = 0
    level, width = length, c_in0
    for i, (a, b) in enumerate(_early_rows(early)):
        need = (b - a + SLACK) * (early[i].c_in | 1)
        if i % 2 == 0:
            a_need = max(a_need, need)
        else:
            b_need = max(b_need, need)
    for unit in early:
        level //= 2 if unit.pool else 1
    if early:
        width = early[-1].c_out

    def pad(k: int) -> int:  # consumer_pad of the k-th late pass
        if k < len(incs):
            return max(_halo(u) for u in incs[k])
        return _halo(groups[-1][0]) if head else 0

    need = [0, 0]
    if incs or head:
        need[0] = (level + 2 * pad(0) + SLACK) * (width | 1)
        which = 0
        for k, branches in enumerate(incs):
            f = sum(u.c_out for u in branches)
            level //= 2
            if k < len(incs) - 1 or head:
                need[1 - which] = max(need[1 - which],
                                      (level + 2 * pad(k + 1) + SLACK) * (f | 1))
            which = 1 - which
        if head:
            need[1 - which] = max(need[1 - which],
                                  (level + SLACK) * (groups[-1][0].c_out | 1))
    w_at = _round4(UNIT_INTS * len(units))
    p1_at = w_at + w_floats + _round4(need[0])
    return 4 * (p1_at + _round4(max(_round4(a_need) + b_need, need[1])))


@functools.lru_cache(maxsize=None)
def plan_segment(config, segment: str, threads: int = THREADS,
                 length: Optional[int] = None) -> SegmentPlan:
    """Each pass's row tile for one launch on ``(N, length, C)`` windows
    (``length`` defaults to the segment's at ``config.input_length``).

    Mirrors the kernel's row arithmetic (csrc/trunk_megakernel.cu
    ``make_plan`` and its tile loop): an early unit computes the rows of
    one kTile tile of the early output plus their halo, a late pass every
    row of its window.  Plain Python: the CPU tests check it against the
    source's constants and the card tests against the C side's count.
    Cached, so that a launch does not plan again.
    """
    early_on, inc_lo, inc_hi, head = segment_spec(config, segment)
    if length is None:
        length = config.input_length
        if not early_on:
            length //= 2 ** (1 + len(config.block_features) + inc_lo)
    geometry = segment_geometry(config, segment)
    n_early = 1 + 2 * len(config.block_features) if early_on else 0
    early = geometry[:n_early]
    groups = [[u] for u in early]
    groups += [geometry[i:i + 4] for i in range(n_early, n_early + 4 * (inc_hi - inc_lo), 4)]
    if head:
        groups.append([geometry[-1]])
    plans = []
    level = length
    n_tiles = -(-(length >> sum(u.pool for u in early)) // TILE)
    spans = _early_rows(early)
    for k, group in enumerate(groups):
        unit = group[0]
        if k < n_early:
            # The unit's rows for one tile: its input span less the halo.
            a, b = spans[k]
            rows = b - a - 2 * _halo(unit)
            useful = min(1.0, level / (n_tiles * rows))
        else:
            rows, useful = level, 1.0
        plan = plan_pass(group, rows, useful, threads=threads)
        flops = sum(2 * level * u.taps * u.c_in * u.c_out for u in group)
        plans.append(plan._replace(flops=flops))
        level //= 2 if unit.pool else 1
    smem = _smem_bytes(groups, n_early, head, length,
                       segment_input_channels(config, segment))
    return SegmentPlan(TILE, threads, tuple(plans), smem, weighted_lanes(plans))


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
    # make_plan's arguments per (config, segment, length, plan), built at a
    # launch's first use.
    plan_args: Dict[tuple, tuple] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)


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


def _unit_table(packed: PackedTrunk, plan: SegmentPlan) -> List[int]:
    """UNIT_INTS ints per unit, in the order csrc/trunk_megakernel.cu reads
    them; the kernel shapes must be the plan's."""
    table = []
    for unit_plan in plan.units:
        for unit in unit_plan.units:
            shape = tuple(packed.units[unit.scope][0].shape)
            if shape != (unit.taps, unit.c_in, unit.c_out):
                raise ValueError(f"{unit.scope}: kernel {shape}, but the "
                                 f"config gives {(unit.taps, unit.c_in, unit.c_out)}")
            kernel_at, scale_at = packed.offsets[unit.scope]
            table += [unit.c_in, unit.c_out, unit.taps, unit.dilation,
                      int(unit.pool), kernel_at, scale_at, unit_plan.row_tile]
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
               plan: SegmentPlan) -> tuple:
    """make_plan's arguments, from the unit table on: cached on ``packed``."""
    key = (config, segment, length, plan)
    if key not in packed.plan_args:
        early, inc_lo, inc_hi, head = segment_spec(config, segment)
        n_early = 1 + 2 * len(config.block_features) if early else 0
        table = _unit_table(packed, plan)
        ints = (ctypes.c_int * len(table))(*table)
        packed.plan_args[key] = (length, segment_input_channels(config, segment),
                                 n_early, inc_hi - inc_lo, int(head), ints,
                                 len(table) // UNIT_INTS)
    return packed.plan_args[key]


def shared_memory_bytes(packed: PackedTrunk, config, segment: str,
                        length: int) -> int:
    """Dynamic shared memory one block takes for a segment, as the C side
    counts it (-1 for a plan it does not take)."""
    plan = plan_segment(config, segment, length=length)
    return int(_library().deepbinner_trunk_smem_bytes(
        *_plan_args(packed, config, segment, length, plan)))


def trunk_segment(x: torch.Tensor, packed: PackedTrunk, config,
                  segment: str) -> torch.Tensor:
    """One named trunk segment over ``(N, L, C)`` float32 windows.

    Returns ``(N, head_features)`` for the segments that end at the global
    average pool ("all", "late", "late1"), else the ``(N, L', C')``
    activation.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel once, with the row tiles of :func:`plan_segment`.
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
    n, length, _c_in = x.shape
    out = torch.empty(segment_output_shape(config, segment, n, length),
                      dtype=torch.float32, device=x.device)
    plan = plan_segment(config, segment, length=length)
    launch = _library().deepbinner_trunk_segment
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(x.data_ptr(), packed.params.data_ptr(), out.data_ptr(), n,
                    *_plan_args(packed, config, segment, length, plan), stream)
    if rc != 0:
        raise RuntimeError(f"{_KERNEL} launch failed for row tiles "
                           f"{[u.row_tile for u in plan.units]}: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
