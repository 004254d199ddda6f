"""The classify program: trim → normalise → window → CNN → call, on one
device or data parallel over several.

Counterpart of ``deepbinner_tpu/runner/pipeline.py``.  PyTorch runs eagerly,
so there is no compile step: :class:`ClassifyProgram` folds each model's
BatchNorm and puts its weights on each of its devices once, then every batch
is a sequence of launches on each device's current stream.  With D devices
(the JAX program's ``('data',)`` mesh) a batch's rows are split into D
contiguous parts, each part runs on its device, and the D call tables are
gathered in row order on the first.  With ``model = M`` above 1 the devices
form a ``D/M × M`` grid (the JAX dry run's ``('data', 'model')`` mesh):
the rows split over the grid's D/M rows, and each part runs on its row's
M devices through the column-parallel composition
(:func:`~deepbinner_tpu_torch.models.kernel_apply.apply_inference_kernels_tp`),
each device holding its rank's column shard of the weights.  On a CUDA device the CNN
runs one of the kernel compositions of
:mod:`~deepbinner_tpu_torch.models.kernel_apply`, chosen by
``ClassifyConfig.kernel_path``; on the CPU the same composition runs each
kernel's plain version.  A model imported from Keras HDF5
(:class:`~deepbinner_tpu_torch.models.keras_import.KerasGraphModel`) runs
as its own graph on every device, with no kernel of the port (the JAX
program's ``model.apply`` branch); it takes ``kernel_path="unit"`` only.

The reference computes in f32, so every call of the program runs with TF32
off for cuBLAS and cuDNN (:func:`full_f32`), whatever the host program has
set, and gives the caller's settings back afterwards.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepbinner_tpu_torch import resolve_device
from deepbinner_tpu_torch.models.kernel_apply import (
    FoldedNet,
    apply_inference_kernels,
    apply_inference_kernels_fused,
    apply_inference_kernels_hybrid,
    apply_inference_kernels_split3,
    apply_inference_kernels_tp,
    fold_network,
    shard_network,
)
from deepbinner_tpu_torch.models.keras_import import KerasGraphModel
from deepbinner_tpu_torch.models.network import DemuxNet
from deepbinner_tpu_torch.ops.calling import (
    CallingConfig,
    call_one_end,
    combine_window_probs,
    reconcile_calls,
)
from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig, preprocess_batch
from deepbinner_tpu_torch.parallel.mesh import make_grid, split_rows


class CallTable(NamedTuple):
    """Per-batch output — everything the host needs for TSV rows."""

    calls: torch.Tensor        # (B,) int32 final class index (0 = none)
    start_calls: torch.Tensor  # (B,) int32 start-model call
    end_calls: torch.Tensor    # (B,) int32 end-model call (== start when single)
    start_probs: torch.Tensor  # (B, C) combined start probabilities
    end_probs: torch.Tensor    # (B, C) combined end probabilities (zeros when single)


@dataclasses.dataclass(frozen=True)
class ClassifyConfig:
    """Everything static about a classify run."""

    preprocess: PreprocessConfig = PreprocessConfig()
    calling: CallingConfig = CallingConfig()
    dual_model: bool = False
    # The CNN composition; the JAX package's use_pallas / pallas_fused /
    # pallas_path map onto it as:
    #   "unit"   one unit-kernel launch per ConvBNReLU unit (JAX: the flax
    #            graph without --pallas, or pallas_path="unit");
    #   "fused"  stem1, then the whole trunk in one megakernel launch (JAX:
    #            use_pallas with pallas_fused, what `classify --pallas` runs);
    #   "split3" stem1, then three megakernel launches (JAX: pallas_path=
    #            "split3");
    #   "hybrid" the unit kernel at the units of HYBRID_KERNEL_UNITS, the
    #            library's conv at the others (JAX: pallas_path="hybrid").
    kernel_path: str = "unit"

    def __post_init__(self) -> None:
        if self.kernel_path not in KERNEL_PATHS:
            raise ValueError(f"unknown kernel_path {self.kernel_path!r}; one "
                             f"of {sorted(KERNEL_PATHS)}")


KERNEL_PATHS = {
    "unit": apply_inference_kernels,
    "fused": apply_inference_kernels_fused,
    "split3": apply_inference_kernels_split3,
    "hybrid": apply_inference_kernels_hybrid,
}

# What a program holds for one model on one device: DemuxNet folded for the
# kernels, or an imported Keras graph on that device; or, for one group of
# the 'model' axis, each rank's column shard of DemuxNet on its device.
Net = Union[FoldedNet, KerasGraphModel, Tuple[FoldedNet, ...]]
Model = Union[DemuxNet, KerasGraphModel]


def _one_end_probs(net: Net, cfg: ClassifyConfig, signal: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """(B, buffer) signal → (B, C) combined probabilities for one read end."""
    windows, mask = preprocess_batch(signal, lengths, cfg.preprocess)
    batch, num_windows, width = windows.shape
    flat = windows.reshape(batch * num_windows, width)
    if isinstance(net, tuple):
        probs = apply_inference_kernels_tp(net, flat)
    elif isinstance(net, FoldedNet):
        probs = KERNEL_PATHS[cfg.kernel_path](net, flat)
    else:
        probs = torch.softmax(net(flat), dim=-1)
    probs = probs.reshape(batch, num_windows, -1)
    return combine_window_probs(probs, mask, rule=cfg.calling.combine)


def classify_step(
    cfg: ClassifyConfig,
    start_net: Net,
    end_net: Optional[Net],
    start_signal: torch.Tensor,
    start_lengths: torch.Tensor,
    end_signal: Optional[torch.Tensor] = None,
    end_lengths: Optional[torch.Tensor] = None,
) -> CallTable:
    """The call table for one padded batch already on the device."""
    start_probs = _one_end_probs(start_net, cfg, start_signal, start_lengths)
    start_call = call_one_end(start_probs, cfg.calling)
    if cfg.dual_model:
        if end_net is None or end_signal is None or end_lengths is None:
            raise ValueError("dual_model needs the end model and end signal")
        end_probs = _one_end_probs(end_net, cfg, end_signal, end_lengths)
        end_call = call_one_end(end_probs, cfg.calling)
        final = reconcile_calls(start_call, end_call, cfg.calling)
    else:
        end_probs = torch.zeros_like(start_probs)
        end_call = start_call
        final = start_call
    return CallTable(final, start_call, end_call, start_probs, end_probs)


def pack_call_table(table: CallTable) -> torch.Tensor:
    """Flatten a CallTable into ONE (B, 3 + 2C) f32 tensor (one copy to the
    host per batch; calls are small ints, exact in f32)."""
    return torch.cat(
        [
            table.calls[:, None].float(),
            table.start_calls[:, None].float(),
            table.end_calls[:, None].float(),
            table.start_probs,
            table.end_probs,
        ],
        dim=1,
    )


def unpack_call_table(packed) -> CallTable:
    """Host-side inverse of pack_call_table (tensor or numpy in, numpy out)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    packed = np.asarray(packed)
    classes = (packed.shape[1] - 3) // 2
    return CallTable(
        calls=packed[:, 0].astype(np.int32),
        start_calls=packed[:, 1].astype(np.int32),
        end_calls=packed[:, 2].astype(np.int32),
        start_probs=packed[:, 3 : 3 + classes],
        end_probs=packed[:, 3 + classes :],
    )


def _read_flag(read):
    try:
        return read()
    except RuntimeError:  # the caller mixed torch's two TF32 interfaces
        return None


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """TF32 off for cuBLAS and cuDNN inside; the caller's settings after.

    Both flags are process-wide, so they are set and given back around each
    call rather than once.  The matmul setting is given back through
    ``torch.set_float32_matmul_precision`` where it reads as one of its
    levels ("medium" does not survive a round trip through the flag).
    """
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    precision = _read_flag(torch.get_float32_matmul_precision)
    allow_matmul = _read_flag(lambda: matmul.allow_tf32)
    allow_cudnn = _read_flag(lambda: cudnn.allow_tf32)
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        if allow_cudnn is not None:
            cudnn.allow_tf32 = allow_cudnn
        if precision is not None:
            torch.set_float32_matmul_precision(precision)
        elif allow_matmul is not None:
            matmul.allow_tf32 = allow_matmul


def _on(device: torch.device):
    """``device`` as the current CUDA device inside (nothing on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _place(model: Model, kernel_path: str, device: torch.device) -> Net:
    """``model`` ready to run on ``device``: DemuxNet folded for the kernels,
    a Keras graph copied onto the device (each device its own copy)."""
    if isinstance(model, DemuxNet):
        return fold_network(model, device)
    if not isinstance(model, KerasGraphModel):
        raise TypeError(f"expected a DemuxNet or a KerasGraphModel, got "
                        f"{type(model).__name__}")
    if kernel_path != "unit":
        raise ValueError(f"kernel_path {kernel_path!r} runs DemuxNet on the "
                         f"port's kernels; an imported Keras graph runs as "
                         f"its own graph (kernel_path='unit')")
    return copy.deepcopy(model).to(device).eval()


class ClassifyProgram:
    """A classify step bound to its model(s), config and device(s).

    One instance per run.  The weights are folded (DemuxNet) or copied (a
    Keras graph; each end brings its own) and put on each device when it is
    built; each call uploads one batch, runs the step and returns the
    result on the (first) device (``device=None`` means the card).
    ``devices`` (a list; one entry may repeat) makes it data parallel: each
    call splits the batch's rows over them in order.  ``model`` above 1
    makes the devices a ``data × model`` grid (:func:`make_grid`): the rows
    split over the grid's rows, and each row's devices run its part with
    column shards of DemuxNet (the unit path only).
    """

    def __init__(
        self,
        start_model: Model,
        cfg: ClassifyConfig,
        end_model: Optional[Model] = None,
        device=None,
        devices: Optional[Sequence] = None,
        model: int = 1,
    ) -> None:
        if cfg.dual_model and end_model is None:
            raise ValueError("dual_model requires end_model")
        if devices is not None and not devices:
            raise ValueError("devices must name at least one device")
        if model > 1:
            if cfg.kernel_path != "unit":
                raise ValueError(
                    f"kernel_path {cfg.kernel_path!r} cannot run on a model "
                    f"axis of {model}: the megakernel's one launch and the "
                    f"hybrid's library units take no column shards; the "
                    f"column-parallel composition is the unit path's")
            if not all(isinstance(m, DemuxNet) for m in (start_model, end_model)
                       if m is not None):
                raise ValueError(f"an imported Keras graph runs as its own "
                                 f"graph; it cannot run on a model axis of "
                                 f"{model}")
        self.cfg = cfg
        self.devices = [resolve_device(d) for d in
                        (devices if devices is not None else [device])]
        self.grid = make_grid(self.devices, model=model)
        # Each grid row's rows of a batch go to its first device.
        self.leaders = [row[0] for row in self.grid]
        self.device = self.devices[0]
        folded, by_row = {}, {}

        def place(end: int, dev: torch.device, rank: int) -> Optional[Net]:
            """Model ``end`` (0 start, 1 end) for ``rank`` on ``dev``: folded
            once per device; with ``model`` above 1, that rank's column
            shard (two ranks on one card hold different shards)."""
            m = (start_model, end_model)[end]
            if m is None:
                return None
            if (dev, end) not in folded:
                folded[dev, end] = _place(m, cfg.kernel_path, dev)
            if model == 1:
                return folded[dev, end]
            return shard_network(folded[dev, end], rank, model)

        def row_nets(row) -> Tuple[Net, Optional[Net]]:
            if model == 1:
                return place(0, row[0], 0), place(1, row[0], 0)
            start = tuple(place(0, dev, k) for k, dev in enumerate(row))
            if end_model is None:
                return start, None
            return start, tuple(place(1, dev, k) for k, dev in enumerate(row))

        self.nets = []  # (start, end) of each grid row; equal rows share one
        for row in self.grid:
            if tuple(row) not in by_row:
                by_row[tuple(row)] = row_nets(row)
            self.nets.append(by_row[tuple(row)])
        self.start_net, self.end_net = self.nets[0]

    def _upload(self, array, device: torch.device) -> Optional[torch.Tensor]:
        if array is None:
            return None
        tensor = torch.as_tensor(array)
        # Host memory that is already pinned (a reader pool's registered
        # shared-memory slot) goes to the card as it is; anything else is
        # staged through a pinned copy so that the upload is asynchronous.
        if (device.type == "cuda" and tensor.device.type == "cpu"
                and not tensor.is_pinned()):
            tensor = tensor.pin_memory()
        with _on(device):
            return tensor.to(device, non_blocking=True)

    def _upload_parts(self, array) -> Optional[List[torch.Tensor]]:
        """Rows of ``array`` split over the devices in order (a list of
        parts already uploaded is returned as it is)."""
        if array is None or isinstance(array, list):
            return array
        tensor = torch.as_tensor(array)
        return [self._upload(tensor[lo:hi], dev) for (lo, hi), dev in
                zip(split_rows(tensor.shape[0], len(self.leaders)),
                    self.leaders)]

    def upload(self, start_signal, start_lengths, end_signal=None,
               end_lengths=None) -> Tuple:
        """One batch's arrays on the device(s), enqueued on each device's
        current stream (the host memory of pinned arrays is read until the
        copies are done).  With one grid row, the four tensors; with D, four
        lists of D row parts, each on its row's first device."""
        arrays = (start_signal, start_lengths, end_signal, end_lengths)
        if len(self.leaders) == 1:
            return tuple(self._upload(a, self.device) for a in arrays)
        return tuple(self._upload_parts(a) for a in arrays)

    def upload_events(self) -> List["torch.cuda.Event"]:
        """One event per device an upload goes to (each grid row's first),
        recorded on its current stream: once all have completed, every
        upload enqueued before is done (none on the CPU, where an upload is
        done when it returns)."""
        events = []
        if self.device.type == "cuda":
            for dev in dict.fromkeys(self.leaders):
                with torch.cuda.device(dev):
                    event = torch.cuda.Event()
                    event.record()
                    events.append(event)
        return events

    def _tables(self, arrays) -> List[CallTable]:
        """The call table of each grid row's rows."""
        parts = self.upload(*arrays)
        if len(self.leaders) == 1:
            return [classify_step(self.cfg, self.start_net, self.end_net,
                                  *parts)]
        tables = []
        for k, dev in enumerate(self.leaders):
            with _on(dev):
                tables.append(classify_step(
                    self.cfg, *self.nets[k],
                    *(None if p is None else p[k] for p in parts)))
        return tables

    def __call__(self, start_signal, start_lengths, end_signal=None,
                 end_lengths=None) -> CallTable:
        with full_f32(), torch.inference_mode():
            tables = self._tables((start_signal, start_lengths, end_signal,
                                   end_lengths))
            if len(tables) == 1:
                return tables[0]
            return CallTable(*(torch.cat([t.to(self.device) for t in field])
                               for field in zip(*tables)))

    def call_packed(self, start_signal, start_lengths, end_signal=None,
                    end_lengths=None) -> torch.Tensor:
        """The CallTable packed into one (B, 3+2C) f32 tensor on the (first)
        device; the streaming executor unpacks it with
        :func:`unpack_call_table`.  With D grid rows each packs its rows
        and the D tables are gathered in row order."""
        with full_f32(), torch.inference_mode():
            packed = [pack_call_table(t) for t in self._tables(
                (start_signal, start_lengths, end_signal, end_lengths))]
            if len(packed) == 1:
                return packed[0]
            return torch.cat([p.to(self.device) for p in packed])

    def warm_up(self, batch_size: int) -> None:
        """Run one all-zero batch end to end on every device (kernel build,
        first launches, first copy back) so the first real batch runs at
        steady state."""
        pre = self.cfg.preprocess
        wire = np.int8 if pre.wire in ("int8", "int4") else np.int16
        sig = np.zeros((batch_size, pre.wire_cols), wire)
        lengths = np.full((batch_size,), pre.buffer_size, np.int32)
        ends = (sig, lengths) if self.cfg.dual_model else ()
        self.call_packed(sig, lengths, *ends).cpu()
