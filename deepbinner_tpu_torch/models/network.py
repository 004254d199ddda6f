"""DemuxNet, the barcode-classifier 1D CNN, as PyTorch modules.

Counterpart of ``deepbinner_tpu/models/network.py``.  The module tree and
parameter names mirror the flax variables, with ``/`` written as ``.``:
``stem1.kernel`` is flax ``params/stem1/conv/kernel``, ``stem1.scale`` and
``stem1.bias`` are ``params/stem1/bn/{scale,bias}``, ``stem1.mean`` and
``stem1.var`` are ``batch_stats/stem1/bn/{mean,var}``.  Conv kernels keep
flax's ``(K, C_in, C_out)`` layout and activations JAX's ``(N, L, C)``.

:meth:`DemuxNet.forward` is the plain composition, the counterpart of flax
``model.apply``: every unit through the plain conv, pools after each
stage.  The classify program runs the kernel composition of
:mod:`deepbinner_tpu_torch.models.kernel_apply` instead.

``forward(windows, train=True, generator=g)`` is flax's
``apply(..., train=True)``: GaussianNoise at the input, each unit's
BatchNorm on the batch statistics (which also updates the running ones),
dropout before the dense layer.  With ``shard=`` (a
:class:`~deepbinner_tpu_torch.parallel.dist.RowShard`) the windows are one
rank's rows of a global batch: the noise and the dropout mask are drawn at
the global batch's shape and cut to those rows, and BatchNorm's statistics
are summed over the ranks (the JAX trainer's one jit over the global batch:
SyncBN).  The mode is an argument, never
``nn.Module.training``, which starts as True and would put every classify
path that calls ``model(...)`` on batch statistics.  The training forward
runs in PyTorch's ``(N, C, L)`` layout on ``F.conv1d`` (the JAX trainer
leaves this conv to XLA, outside any Pallas kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deepbinner_tpu_torch import NUM_CLASSES
from deepbinner_tpu_torch.ops.conv_kernel import (
    conv1d_bn_relu_reference,
    fold_batchnorm,
)


BN_EPSILON = 1e-3   # Keras BatchNormalization's default, as flax's units use
BN_MOMENTUM = 0.9   # flax's convention: running = 0.9 * running + 0.1 * batch


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """Architecture hyper-parameters for DemuxNet (f32 only)."""

    num_classes: int = NUM_CLASSES
    input_length: int = 1024
    stem_features: int = 48
    block_features: Tuple[int, ...] = (64, 96)
    inception_features: Tuple[int, ...] = (128, 128)
    head_features: int = 128
    noise_stddev: float = 0.02
    dropout_rate: float = 0.15


class ConvBNRelu(nn.Module):
    """Conv1D (no bias) + BatchNorm (eps 1e-3) + ReLU — the basic unit."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 dilation: int = 1) -> None:
        super().__init__()
        self.dilation = dilation
        self.kernel = nn.Parameter(torch.zeros(kernel_size, in_features, features))
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(kernel, scale, bias) with the BatchNorm folded into the affine."""
        scale, bias = fold_batchnorm(self.scale, self.bias, self.mean, self.var)
        return self.kernel, scale, bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_bn_relu_reference(x, *self.folded(), dilation=self.dilation)

    def forward_train(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        """The training unit on ``(N, C_in, L)``: conv, BatchNorm on the batch
        statistics, ReLU; the running statistics take one momentum step.

        The statistics are flax 0.12's: mean over (N, L), variance
        E[x²] − E[x]² clipped at 0, over every row of the batch (padding rows
        of weight 0 included).  The running variance takes the biased batch
        variance, as flax's does (``torch.nn.BatchNorm1d`` takes the unbiased
        one, with its momentum the other way round).  Under ``shard`` the
        batch is the global one: Σy and Σy² are summed over the ranks.
        """
        taps = self.kernel.shape[0]
        y = F.conv1d(x, self.kernel.permute(2, 1, 0),
                     padding=(taps - 1) // 2 * self.dilation,
                     dilation=self.dilation)
        if shard is None:
            mean = y.mean(dim=(0, 2))
            var = torch.clamp((y * y).mean(dim=(0, 2)) - mean * mean, min=0.0)
        else:
            count = shard.total * y.shape[2]
            sums = shard.sum(torch.stack([y.sum(dim=(0, 2)),
                                          (y * y).sum(dim=(0, 2))]))
            mean = sums[0] / count
            var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + BN_EPSILON) * self.scale
        return torch.relu((y - mean[:, None]) * mul[:, None] + self.bias[:, None])


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """Window-2 stride-2 VALID max pool over L of ``(N, L, C)``."""
    n, length, c = x.shape
    return x[:, : length - length % 2, :].reshape(n, length // 2, 2, c).amax(dim=2)


def pool3_same(x: torch.Tensor) -> torch.Tensor:
    """Window-3 stride-1 SAME max pool over L of ``(N, L, C)`` (pad -inf)."""
    padded = torch.nn.functional.pad(x, (0, 0, 1, 1), value=float("-inf"))
    length = x.shape[1]
    return torch.maximum(
        torch.maximum(padded[:, 0:length], padded[:, 1 : length + 1]),
        padded[:, 2 : length + 2],
    )


class InceptionModule(nn.Module):
    """Parallel 1×1, k3, k3-dilated and pool3→1×1 branches, concatenated."""

    def __init__(self, in_features: int, features: int, dilation: int = 2) -> None:
        super().__init__()
        quarter = features // 4
        self.branch1x1 = ConvBNRelu(in_features, quarter, 1)
        self.branch3 = ConvBNRelu(in_features, features - 3 * quarter, 3)
        self.branch_dilated = ConvBNRelu(in_features, quarter, 3, dilation)
        self.branch_pool = ConvBNRelu(in_features, quarter, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1x1(x), self.branch3(x),
                          self.branch_dilated(x),
                          self.branch_pool(pool3_same(x))], dim=-1)

    def forward_train(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        """Training forward on ``(N, C, L)`` (max pool padding is -inf)."""
        pooled = F.max_pool1d(x, 3, stride=1, padding=1)
        return torch.cat([self.branch1x1.forward_train(x, shard),
                          self.branch3.forward_train(x, shard),
                          self.branch_dilated.forward_train(x, shard),
                          self.branch_pool.forward_train(pooled, shard)], dim=1)


class DemuxNet(nn.Module):
    """Input ``(B, input_length)`` or ``(B, input_length, 1)`` → ``(B, C)`` logits.

    Parameters start as zeros; real weights come from
    :func:`deepbinner_tpu_torch.models.checkpoint.load_model`,
    :func:`~deepbinner_tpu_torch.models.checkpoint.from_flax_variables` or,
    to train, :func:`init_weights`.
    """

    def __init__(self, config: NetworkConfig = NetworkConfig()) -> None:
        super().__init__()
        self.config = config
        stem = config.stem_features
        self.stem1 = ConvBNRelu(1, stem)
        self.stem2 = ConvBNRelu(stem, stem)
        width = stem
        for i, feats in enumerate(config.block_features):
            self.add_module(f"block{i}_conv1", ConvBNRelu(width, feats))
            self.add_module(f"block{i}_conv2", ConvBNRelu(feats, feats))
            width = feats
        for i, feats in enumerate(config.inception_features):
            self.add_module(f"inception{i}",
                            InceptionModule(width, feats, dilation=2 ** (i + 1)))
            width = feats
        self.head_conv = ConvBNRelu(width, config.head_features)
        self.classifier = nn.Linear(config.head_features, config.num_classes)
        nn.init.zeros_(self.classifier.weight)
        nn.init.zeros_(self.classifier.bias)

    def forward(self, windows: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                shard=None) -> torch.Tensor:
        """Logits; ``train=True`` draws noise and dropout from ``generator``
        (``shard``: the windows are one rank's rows of a global batch)."""
        if train:
            return self._forward_train(windows, generator, shard)
        x = windows.float()
        if x.dim() == 2:
            x = x[:, :, None]
        x = _pool2(self.stem2(self.stem1(x)))
        for i in range(len(self.config.block_features)):
            x = getattr(self, f"block{i}_conv1")(x)
            x = _pool2(getattr(self, f"block{i}_conv2")(x))
        for i in range(len(self.config.inception_features)):
            x = _pool2(getattr(self, f"inception{i}")(x))
        x = self.head_conv(x).mean(dim=1)  # global average pool over L
        return self.classifier(x)

    def _forward_train(self, windows: torch.Tensor,
                       generator: Optional[torch.Generator],
                       shard) -> torch.Tensor:
        cfg = self.config
        x = windows.to(self.classifier.weight.dtype)  # f32 unless made f64
        if x.dim() == 3:
            x = x[:, :, 0]
        if generator is None and (cfg.noise_stddev > 0 or cfg.dropout_rate > 0):
            raise ValueError("a training forward with noise or dropout needs "
                             "a torch.Generator")
        if cfg.noise_stddev > 0:  # GaussianNoise
            x = x + cfg.noise_stddev * _draw(torch.randn, x, generator, shard)
        x = x[:, None, :]  # (N, 1, L)
        x = F.max_pool1d(self.stem2.forward_train(
            self.stem1.forward_train(x, shard), shard), 2)
        for i in range(len(cfg.block_features)):
            x = getattr(self, f"block{i}_conv1").forward_train(x, shard)
            x = F.max_pool1d(getattr(self, f"block{i}_conv2").forward_train(
                x, shard), 2)
        for i in range(len(cfg.inception_features)):
            x = F.max_pool1d(getattr(self, f"inception{i}").forward_train(
                x, shard), 2)
        x = self.head_conv.forward_train(x, shard).mean(dim=2)
        if cfg.dropout_rate > 0:  # flax Dropout: keep with 1 - rate, scale up
            keep = 1.0 - cfg.dropout_rate
            mask = _draw(torch.rand, x, generator, shard) < keep
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        return self.classifier(x)


def _draw(sample, x: torch.Tensor, generator: Optional[torch.Generator],
          shard) -> torch.Tensor:
    """``sample`` (``torch.randn`` or ``torch.rand``) at ``x``'s shape, or
    under ``shard`` at the global batch's shape, cut to this rank's rows."""
    if shard is None:
        return sample(x.shape, generator=generator, device=x.device)
    return sample((shard.total, *x.shape[1:]), generator=generator,
                  device=x.device)[shard.rows]


def _lecun_normal_(tensor: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, variance 1/fan_in."""
    # 0.8796... is the std of a unit normal truncated at ±2, as in JAX's
    # variance_scaling, so that the truncated draw has variance 1/fan_in.
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(tensor, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def init_weights(model: DemuxNet, generator: torch.Generator) -> DemuxNet:
    """Initialise ``model`` as flax's ``init`` does, from ``generator``.

    Conv kernels ``(K, C_in, C_out)`` and the dense kernel take
    ``lecun_normal`` (fan_in K·C_in and C_in), biases are 0, BatchNorm
    scales 1, running means 0 and variances 1.  The distributions are
    flax's; the values cannot equal JAX's for the same seed (another
    generator).  Draws run on the CPU in execution order, so a seed gives
    the same weights whatever device the model goes to afterwards.
    """
    with torch.no_grad():
        for scope in unit_scopes(model.config):
            unit = model.get_submodule(scope.replace("/", "."))
            taps, c_in, _c_out = unit.kernel.shape
            _lecun_normal_(unit.kernel, taps * c_in, generator)
            unit.scale.fill_(1.0)
            unit.bias.zero_()
            unit.mean.zero_()
            unit.var.fill_(1.0)
        _lecun_normal_(model.classifier.weight, model.classifier.in_features,
                       generator)
        model.classifier.bias.zero_()
    return model


def unit_scopes(config: NetworkConfig) -> Iterator[str]:
    """Flax scope of every ConvBNRelu unit, in execution order."""
    yield "stem1"
    yield "stem2"
    for i in range(len(config.block_features)):
        yield f"block{i}_conv1"
        yield f"block{i}_conv2"
    for i in range(len(config.inception_features)):
        for branch in ("branch1x1", "branch3", "branch_dilated", "branch_pool"):
            yield f"inception{i}/{branch}"
    yield "head_conv"


def apply_inference(model: DemuxNet, windows: torch.Tensor) -> torch.Tensor:
    """Softmax probabilities for a flat batch of windows ``(N, L)`` or ``(N, L, 1)``."""
    with torch.inference_mode():
        return torch.softmax(model(windows), dim=-1)
