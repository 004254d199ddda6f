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
- :func:`apply_inference_kernels_hybrid` (``apply_inference_pallas_hybrid``):
  the unit composition with the unit kernel only at the scopes of a table
  (default :data:`HYBRID_KERNEL_UNITS`, the JAX package's
  ``HYBRID_PALLAS_UNITS``) and the library's conv everywhere else.  The
  kernel plans its own tiles (:func:`~deepbinner_tpu_torch.ops.conv_kernel.plan_unit`),
  so the table's Pallas tile arguments have no counterpart.
- :func:`apply_inference_kernels_tp` (the JAX dry run's ``classify_step``
  under ``param_sharding``'s column-parallel weights): the unit composition
  over the ranks of one ``'model'`` group, each holding a column shard of
  every unit (:func:`shard_network`).  Each unit runs the unit kernel on
  every rank's shard, on that rank's device, and the slices are gathered in
  rank order along C on the group's first device, which hands the whole
  activation to every rank for the next unit.

The BatchNorm affine is folded and the trunk's weights are packed once,
when the network is put on its device (:func:`fold_network`), not on every
call.
"""

from __future__ import annotations

import dataclasses
from typing import Collection, Dict, FrozenSet, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deepbinner_tpu_torch.models.network import (
    DemuxNet,
    NetworkConfig,
    pool3_same,
    unit_scopes,
)
from deepbinner_tpu_torch.ops.conv_kernel import (
    conv1d_bn_relu_reference,
    fused_conv1d_bn_relu,
    plan_unit,
)
from deepbinner_tpu_torch.ops.trunk_kernel import (
    PackedTrunk,
    pack_trunk,
    trunk_segment,
)
from deepbinner_tpu_torch.parallel.mesh import shard_columns, split_axis
from deepbinner_tpu_torch.runner import spans

Unit = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # kernel, scale, bias

# What the column-parallel composition did in this process: gathers of the
# ranks' slices of a unit's output, and copies of an activation between two
# devices (a unit's input to a rank, a slice back to the group's first
# device).  Only apply_inference_kernels_tp adds to them.
GATHERS = 0
PEER_COPIES = 0


@dataclasses.dataclass(frozen=True)
class FoldedNet:
    """DemuxNet weights ready for the kernels, on one device; or one rank's
    column shard of them (:func:`shard_network`), whose ``split`` names the
    units whose output features it holds a block of."""

    config: NetworkConfig
    units: Dict[str, Unit]       # flax scope → folded (kernel, scale, bias)
    dense_weight: torch.Tensor   # (num_classes, head_features)
    dense_bias: torch.Tensor     # (num_classes,)
    trunk: Optional[PackedTrunk]  # the units after stem1, packed for the
                                  # megakernel (None in a column shard)
    split: FrozenSet[str] = frozenset()


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


def shard_network(net: FoldedNet, rank: int, model: int) -> FoldedNet:
    """Rank ``rank`` of ``model``'s column shard of ``net``, on ``net``'s
    device: each unit's ``(kernel[..., lo:hi], scale[lo:hi], bias[lo:hi])``,
    made contiguous once here, where the unit's C_out divides by ``model``
    (:func:`~deepbinner_tpu_torch.parallel.mesh.split_axis`); a unit whose
    C_out does not, and the dense head (13 classes), stay whole.  The scale
    and bias are per output channel, so they follow their kernel's split.
    A shard has no packed trunk: the megakernel's one launch cannot take
    column shards."""
    units, split = {}, set()
    for scope, (kernel, scale, bias) in net.units.items():
        if split_axis("kernel", kernel.shape, model) is None:
            units[scope] = (kernel, scale, bias)
            continue
        units[scope] = tuple(
            shard_columns(t, t.dim() - 1, rank, model).contiguous()
            for t in (kernel, scale, bias))
        split.add(scope)
    if split_axis("weight", net.dense_weight.shape, model) is not None:
        raise ValueError(f"a dense head of {net.dense_weight.shape[0]} "
                         f"classes would split over {model} ranks; the "
                         f"column-parallel composition gathers conv units "
                         f"only")
    return FoldedNet(net.config, units, net.dense_weight, net.dense_bias,
                     None, frozenset(split))


def _as_windows(windows: torch.Tensor) -> torch.Tensor:
    """``(N, L)`` or ``(N, L, 1)`` windows as a contiguous f32 ``(N, L, 1)``."""
    x = windows.float()
    if x.dim() == 2:
        x = x[:, :, None]
    return x.contiguous()


def _classify(net: FoldedNet, pooled: torch.Tensor) -> torch.Tensor:
    logits = torch.nn.functional.linear(pooled, net.dense_weight, net.dense_bias)
    return torch.softmax(logits, dim=-1)


def _demuxnet(net: FoldedNet, windows: torch.Tensor, unit) -> torch.Tensor:
    """DemuxNet's inference graph with each ConvBNReLU unit computed by
    ``unit(scope, x, dilation, pool)`` on ``(N, L, C)``."""
    x = unit("stem1", _as_windows(windows), 1, False)
    x = unit("stem2", x, 1, True)
    for i in range(len(net.config.block_features)):
        x = unit(f"block{i}_conv1", x, 1, False)
        x = unit(f"block{i}_conv2", x, 1, True)
    for i in range(len(net.config.inception_features)):
        scope = f"inception{i}"
        x = torch.cat([
            unit(f"{scope}/branch1x1", x, 1, True),
            unit(f"{scope}/branch3", x, 1, True),
            unit(f"{scope}/branch_dilated", x, 2 ** (i + 1), True),
            unit(f"{scope}/branch_pool", pool3_same(x).contiguous(), 1, True),
        ], dim=-1)
    return _classify(net, unit("head_conv", x, 1, False).mean(dim=1))  # GAP


def apply_inference_kernels(net: FoldedNet, windows: torch.Tensor) -> torch.Tensor:
    """Softmax probabilities for ``(N, L)`` or ``(N, L, 1)`` signal windows.

    While the program's spans record, the counter ``k1/units`` gets each
    unit kernel launch's ``(scope, (N, L, C_in, C_out, taps, dilation,
    pool), loop)``, in launch order, where ``loop`` is the path of the
    kernel's plan (:func:`~deepbinner_tpu_torch.ops.conv_kernel.plan_unit`):
    "pipelined" or "generic"."""
    launches = spans.counter("k1/units")

    def unit(scope, x, dilation, pool):
        return fused_conv1d_bn_relu(x, *net.units[scope], dilation=dilation,
                                    pool=pool)

    def counted(scope, x, dilation, pool):
        taps, c_in, c_out = net.units[scope][0].shape
        plan = plan_unit(c_in, c_out, taps, dilation, x.shape[1])
        launches.append((spans.clock(), (scope, (
            x.shape[0], x.shape[1], c_in, c_out, taps, dilation, pool),
            plan.path)))
        return unit(scope, x, dilation, pool)

    return _demuxnet(net, windows, unit if launches is None else counted)


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``, counting the copy where the devices differ."""
    global PEER_COPIES
    if x.device == device:
        return x
    PEER_COPIES += 1
    return x.to(device)


def apply_inference_kernels_tp(shards: Sequence[FoldedNet],
                               windows: torch.Tensor) -> torch.Tensor:
    """Softmax probabilities of one ``'model'`` group: ``shards[k]`` is rank
    k's column shard (:func:`shard_network`) on rank k's device, and the
    windows lie on rank 0's.

    A unit that is split runs the unit kernel on every rank's shard, on
    that rank's device, and its slices are gathered in rank order along C
    on rank 0's device; an inception branch is gathered before the branch
    concat, so the concat sees the unsharded channel order.  A unit that
    is not split runs once, on rank 0.  ``pool3_same``, the global average
    pool and the dense head run on the gathered tensor on rank 0.
    """
    leader = shards[0]

    def unit(scope, x, dilation, pool):
        global GATHERS
        if scope not in leader.split:
            return fused_conv1d_bn_relu(x, *leader.units[scope],
                                        dilation=dilation, pool=pool)
        parts = []
        for shard in shards:
            weights = shard.units[scope]
            parts.append(fused_conv1d_bn_relu(
                _to(x, weights[0].device), *weights, dilation=dilation,
                pool=pool))
        GATHERS += 1
        return torch.cat([_to(p, x.device) for p in parts], dim=-1)

    return _demuxnet(leader, windows, unit)


# The JAX package's HYBRID_PALLAS_UNITS: the units where a TPU sweep
# measured its unit kernel ahead of XLA's conv.  A scope matches by its
# full name or its last component.
HYBRID_KERNEL_UNITS = frozenset({"block0_conv2", "block1_conv2", "head_conv"})


def _library_unit(x: torch.Tensor, kernel: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, dilation: int, pool: bool) -> torch.Tensor:
    """One unit as library calls on the card: ``F.conv1d`` on ``(N, C, L)``,
    the folded affine, ReLU and the stride-2 max pool (the classify program
    runs it with TF32 off)."""
    taps = kernel.shape[0]
    y = F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0),
                 padding=(taps - 1) // 2 * dilation, dilation=dilation)
    y = torch.relu(y * scale[:, None] + bias[:, None])
    if pool:
        y = F.max_pool1d(y, 2)
    return y.transpose(1, 2).contiguous()


def apply_inference_kernels_hybrid(net: FoldedNet, windows: torch.Tensor,
                                   units: Collection[str] = HYBRID_KERNEL_UNITS
                                   ) -> torch.Tensor:
    """Softmax probabilities with the unit kernel only at ``units``.

    The units in the table launch the kernel; on the card every other unit
    runs :func:`_library_unit` (the JAX version's "XLA elsewhere").  On the
    CPU every unit runs the plain version, as the kernel's wrapper does.
    """

    def unit(scope, x, dilation, pool):
        weights = net.units[scope]
        if scope in units or scope.split("/")[-1] in units:
            return fused_conv1d_bn_relu(x, *weights, dilation=dilation,
                                        pool=pool)
        if x.device.type == "cpu":
            return conv1d_bn_relu_reference(x, *weights, dilation=dilation,
                                            pool=pool)
        return _library_unit(x, *weights, dilation=dilation, pool=pool)

    return _demuxnet(net, windows, unit)


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
