"""DemuxNet inference on the port's kernels.

Counterpart of ``deepbinner_tpu/models/pallas_apply.py``:

- :func:`apply_inference_kernels` (``apply_inference_pallas``): one
  :func:`~deepbinner_tpu_torch.ops.conv_kernel.fused_conv1d_bn_relu` call
  per unit, stem1 included, so 15 launches per model per batch at the
  flagship geometry.  The stage pools are fused into the unit epilogues
  (the trailing pool commutes with the inception concat, so each branch
  pools in its own epilogue); ``pool3_same``, the concat, the global
  average pool, the dense layer and the softmax stay plain torch.
- :func:`apply_inference_kernels_fused`, ``_split`` and ``_split3``
  (``apply_inference_pallas_fused``, ``_split``, ``_split3``): stem1 on the
  unit kernel, then the rest of the trunk as one, two or three launches of
  the trunk megakernel (:func:`~deepbinner_tpu_torch.ops.trunk_kernel.trunk_segment`),
  then the dense layer and the softmax.  The megakernel picks its own
  tiling, so the Pallas versions' batch-tile arguments have no counterpart.

The BatchNorm affine is folded and the trunk's weights are packed once,
when the network is put on its device (:func:`fold_network`), not on every
call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from deepbinner_tpu_torch.models.network import (
    DemuxNet,
    NetworkConfig,
    pool3_same,
    unit_scopes,
)
from deepbinner_tpu_torch.ops.conv_kernel import fused_conv1d_bn_relu
from deepbinner_tpu_torch.ops.trunk_kernel import (
    PackedTrunk,
    pack_trunk,
    trunk_segment,
)

Unit = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # kernel, scale, bias


@dataclasses.dataclass(frozen=True)
class FoldedNet:
    """DemuxNet weights ready for the kernels, on one device."""

    config: NetworkConfig
    units: Dict[str, Unit]       # flax scope → folded (kernel, scale, bias)
    dense_weight: torch.Tensor   # (num_classes, head_features)
    dense_bias: torch.Tensor     # (num_classes,)
    trunk: PackedTrunk           # the units after stem1, packed for the megakernel


def fold_network(model: DemuxNet, device: torch.device) -> FoldedNet:
    """Fold every unit's BatchNorm and put the weights on ``device`` once."""
    units = {}
    with torch.no_grad():
        for scope in unit_scopes(model.config):
            unit = model.get_submodule(scope.replace("/", "."))
            units[scope] = tuple(t.detach().to(device, torch.float32).contiguous()
                                 for t in unit.folded())
        weight = model.classifier.weight.detach().to(device).contiguous()
        bias = model.classifier.bias.detach().to(device).contiguous()
    return FoldedNet(model.config, units, weight, bias,
                     pack_trunk(model.config, units))


def _as_windows(windows: torch.Tensor) -> torch.Tensor:
    """``(N, L)`` or ``(N, L, 1)`` windows as a contiguous f32 ``(N, L, 1)``."""
    x = windows.float()
    if x.dim() == 2:
        x = x[:, :, None]
    return x.contiguous()


def _classify(net: FoldedNet, pooled: torch.Tensor) -> torch.Tensor:
    logits = torch.nn.functional.linear(pooled, net.dense_weight, net.dense_bias)
    return torch.softmax(logits, dim=-1)


def apply_inference_kernels(net: FoldedNet, windows: torch.Tensor) -> torch.Tensor:
    """Softmax probabilities for ``(N, L)`` or ``(N, L, 1)`` signal windows."""
    x = _as_windows(windows)

    def unit(scope: str, x: torch.Tensor, dilation: int = 1,
             pool: bool = False) -> torch.Tensor:
        return fused_conv1d_bn_relu(x, *net.units[scope], dilation=dilation,
                                    pool=pool)

    x = unit("stem1", x)
    x = unit("stem2", x, pool=True)
    for i in range(len(net.config.block_features)):
        x = unit(f"block{i}_conv1", x)
        x = unit(f"block{i}_conv2", x, pool=True)
    for i in range(len(net.config.inception_features)):
        scope = f"inception{i}"
        x = torch.cat([
            unit(f"{scope}/branch1x1", x, pool=True),
            unit(f"{scope}/branch3", x, pool=True),
            unit(f"{scope}/branch_dilated", x, dilation=2 ** (i + 1), pool=True),
            unit(f"{scope}/branch_pool", pool3_same(x).contiguous(), pool=True),
        ], dim=-1)
    return _classify(net, unit("head_conv", x).mean(dim=1))  # GAP


def _trunk(net: FoldedNet, windows: torch.Tensor, segments) -> torch.Tensor:
    """stem1 on the unit kernel, then one megakernel launch per segment."""
    x = fused_conv1d_bn_relu(_as_windows(windows), *net.units["stem1"])
    for segment in segments:
        x = trunk_segment(x, net.trunk, net.config, segment)
    return _classify(net, x)


def apply_inference_kernels_fused(net: FoldedNet, windows: torch.Tensor
                                  ) -> torch.Tensor:
    """Softmax probabilities with the whole trunk after stem1 in ONE launch."""
    return _trunk(net, windows, ("all",))


def apply_inference_kernels_split(net: FoldedNet, windows: torch.Tensor
                                  ) -> torch.Tensor:
    """Two-launch trunk: {stem2 + blocks}, then {inceptions + head + GAP}."""
    return _trunk(net, windows, ("early", "late"))


def apply_inference_kernels_split3(net: FoldedNet, windows: torch.Tensor
                                   ) -> torch.Tensor:
    """Three-launch trunk: {stem2 + blocks} / {inception 0} / {the rest + GAP}."""
    return _trunk(net, windows, ("early", "inc0", "late1"))
