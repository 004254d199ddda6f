"""Operations, bytes and the card's peaks: the yardstick of the roofline
and utilisation metrics.

The arithmetic is a frozen copy of ``chip_smoke.py``'s ``unit_geometries``
and the ``bound_ms`` of its ``phase_kernels`` at commit
402717dbde1c47220f6674dc523b70c64264754a: a ConvBNReLU unit on ``N``
windows of length ``L`` does ``2·N·L·K·C_in·C_out`` operations and moves at
least its input, output, kernel, scale and bias once, in float32 (4 bytes);
its least time is the larger of operations over the float32 peak and bytes
over the memory bandwidth.
"""

from __future__ import annotations

from typing import List, NamedTuple

# NVIDIA H100 SXM data sheet (dense, at the 700 W power limit).
FP32_FLOP_PER_S = 67e12      # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


class Unit(NamedTuple):
    """One ConvBNReLU launch: windows, input length, widths, taps,
    dilation, and whether a stride-2 max pool follows in its epilogue."""

    n: int
    length: int
    c_in: int
    c_out: int
    taps: int
    dilation: int
    pool: bool

    @property
    def flops(self) -> int:
        return 2 * self.n * self.length * self.taps * self.c_in * self.c_out

    @property
    def bytes(self) -> int:
        out_length = self.length // 2 if self.pool else self.length
        return 4 * (self.n * self.length * self.c_in
                    + self.n * out_length * self.c_out
                    + self.taps * self.c_in * self.c_out + 2 * self.c_out)

    @property
    def bound_s(self) -> float:
        """The least time the card can take for this launch."""
        return max(self.flops / FP32_FLOP_PER_S, self.bytes / HBM_BYTES_PER_S)


def units(network: dict, n: int) -> List[Unit]:
    """DemuxNet's 15 units (at the shipped widths) on ``n`` windows, in
    execution order; ``network`` is a ``.dbt`` file's ``network`` config."""
    length = network["input_length"]
    stem = network["stem_features"]
    out = [Unit(n, length, 1, stem, 3, 1, False),
           Unit(n, length, stem, stem, 3, 1, True)]
    width = stem
    length //= 2
    for feats in network["block_features"]:
        out += [Unit(n, length, width, feats, 3, 1, False),
                Unit(n, length, feats, feats, 3, 1, True)]
        width = feats
        length //= 2
    for i, feats in enumerate(network["inception_features"]):
        quarter = feats // 4
        out += [Unit(n, length, width, quarter, 1, 1, True),
                Unit(n, length, width, feats - 3 * quarter, 3, 1, True),
                Unit(n, length, width, quarter, 3, 2 ** (i + 1), True),
                Unit(n, length, width, quarter, 1, 1, True)]
        width = feats
        length //= 2
    out.append(Unit(n, length, width, network["head_features"], 3, 1, False))
    return out


def forward_flops_per_window(network: dict) -> int:
    """Operations of one window through DemuxNet: every unit's
    convolution and the dense layer (the pools, the affine and the softmax
    are a small fraction and not counted)."""
    return (sum(u.flops for u in units(network, 1))
            + 2 * network["head_features"] * network["num_classes"])
