"""The classify program: trim → normalise → window → CNN → call, on one device.

Counterpart of ``deepbinner_tpu/runner/pipeline.py``.  PyTorch runs eagerly,
so there is no compile step: :class:`ClassifyProgram` folds each model's
BatchNorm and puts its weights on the device once, then every batch is a
sequence of launches on the current stream.  On a CUDA device the CNN
runs one of the kernel compositions of
:mod:`~deepbinner_tpu_torch.models.kernel_apply`, chosen by
``ClassifyConfig.kernel_path``; on the CPU the same composition runs each
kernel's plain version.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from deepbinner_tpu_torch import resolve_device
from deepbinner_tpu_torch.models.kernel_apply import (
    FoldedNet,
    apply_inference_kernels,
    apply_inference_kernels_fused,
    apply_inference_kernels_split3,
    fold_network,
)
from deepbinner_tpu_torch.models.network import DemuxNet
from deepbinner_tpu_torch.ops.calling import (
    CallingConfig,
    call_one_end,
    combine_window_probs,
    reconcile_calls,
)
from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig, preprocess_batch


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
    #            "split3").
    kernel_path: str = "unit"

    def __post_init__(self) -> None:
        if self.kernel_path not in KERNEL_PATHS:
            raise ValueError(f"unknown kernel_path {self.kernel_path!r}; one "
                             f"of {sorted(KERNEL_PATHS)}")


KERNEL_PATHS = {
    "unit": apply_inference_kernels,
    "fused": apply_inference_kernels_fused,
    "split3": apply_inference_kernels_split3,
}


def _one_end_probs(net: FoldedNet, cfg: ClassifyConfig, signal: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """(B, buffer) signal → (B, C) combined probabilities for one read end."""
    windows, mask = preprocess_batch(signal, lengths, cfg.preprocess)
    batch, num_windows, width = windows.shape
    apply = KERNEL_PATHS[cfg.kernel_path]
    probs = apply(net, windows.reshape(batch * num_windows, width))
    probs = probs.reshape(batch, num_windows, -1)
    return combine_window_probs(probs, mask, rule=cfg.calling.combine)


def classify_step(
    cfg: ClassifyConfig,
    start_net: FoldedNet,
    end_net: Optional[FoldedNet],
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


class ClassifyProgram:
    """A classify step bound to its model(s), config and device.

    One instance per run.  The weights are folded and put on the device
    when it is built; each call uploads one batch, runs the step and
    returns the result on the device (``device=None`` means the card).
    """

    def __init__(
        self,
        model: DemuxNet,
        cfg: ClassifyConfig,
        end_model: Optional[DemuxNet] = None,
        device=None,
    ) -> None:
        if cfg.dual_model and end_model is None:
            raise ValueError("dual_model requires end_model")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.start_net = fold_network(model, self.device)
        self.end_net = (fold_network(end_model, self.device)
                        if end_model is not None else None)

    def _upload(self, array) -> Optional[torch.Tensor]:
        if array is None:
            return None
        tensor = torch.as_tensor(array)
        if self.device.type == "cuda" and tensor.device.type == "cpu":
            tensor = tensor.pin_memory()
        return tensor.to(self.device, non_blocking=True)

    def __call__(self, start_signal, start_lengths, end_signal=None,
                 end_lengths=None) -> CallTable:
        with torch.inference_mode():
            return classify_step(
                self.cfg, self.start_net, self.end_net,
                self._upload(start_signal), self._upload(start_lengths),
                self._upload(end_signal), self._upload(end_lengths),
            )

    def call_packed(self, start_signal, start_lengths, end_signal=None,
                    end_lengths=None) -> torch.Tensor:
        """The CallTable packed into one (B, 3+2C) f32 tensor on the device;
        the streaming executor unpacks it with :func:`unpack_call_table`."""
        with torch.inference_mode():
            return pack_call_table(
                self(start_signal, start_lengths, end_signal, end_lengths))

    def warm_up(self, batch_size: int) -> None:
        """Run one all-zero batch end to end (kernel build, first launches,
        first copy back) so the first real batch runs at steady state."""
        pre = self.cfg.preprocess
        wire = np.int8 if pre.wire in ("int8", "int4") else np.int16
        sig = np.zeros((batch_size, pre.wire_cols), wire)
        lengths = np.full((batch_size,), pre.buffer_size, np.int32)
        if self.cfg.dual_model:
            out = self.call_packed(sig, lengths, sig, lengths)
        else:
            out = self.call_packed(sig, lengths)
        out.cpu()
