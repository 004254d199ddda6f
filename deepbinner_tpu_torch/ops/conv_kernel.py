"""Fused Conv1D + BatchNorm + ReLU (+ maxpool2): the port of the Pallas unit kernel.

Counterpart of ``deepbinner_tpu/ops/conv_pallas.py``.  One ConvBNReLU unit
of DemuxNet is one call of :func:`fused_conv1d_bn_relu`:

- on a CUDA tensor it launches the hand-written kernel
  ``csrc/conv1d_bn_relu.cu`` (built by :mod:`.kernel_build`, bound with
  ctypes) with the tiles :func:`plan_unit` picks, or raises; nothing falls
  back;
- on a CPU tensor it runs :func:`conv1d_bn_relu_reference`, the plain
  PyTorch version of the same function, which is also the oracle the
  kernel is held against on the card.

The layouts are the JAX package's: x ``(N, L, C_in)``, kernel
``(K, C_in, C_out)`` (flax Conv), out ``(N, L or L/2, C_out)``; f32 only.
Unlike the Pallas kernel, C_in = 1 (stem1) goes through the same kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from deepbinner_tpu_torch.ops import kernel_build

# Launches of the CUDA kernel in this process.  Only the launch site below
# adds to it; a run reads it before and after to show which path it took.
LAUNCHES = 0

_KERNEL = "conv1d_bn_relu"

# The kernel's template instances: the row tile built for each output-channel
# tile (``DEEPBINNER_CONV_TILES`` in the source), and the (taps, dilation)
# pairs with a "window" loop.  Every other pair runs the "generic" loop.
ROW_TILES = {32: 256, 48: 128, 64: 128}
CO_TILES = tuple(ROW_TILES)
WINDOW_TAPS = frozenset({(1, 1), (3, 1), (3, 2), (3, 4)})
CI_CHUNK = 32           # input channels staged per pass (kCiChunk)
ROWS_PER_THREAD = 8     # kRows; a thread's rows share a window when L % 8 == 0
COLS_PER_THREAD = 4     # kCols: one float4 of output channels
SMEM_LIMIT = 232_448    # dynamic shared memory one block may take on an H100
_ERRORS = {-1: "no kernel instance was built for this plan",
           -2: "the plan's threads, shared memory or path do not fit its tiles"}


class UnitPlan(NamedTuple):
    """What one launch of the kernel runs: its tiles, block and inner loop."""

    co_tile: int     # output channels per block
    row_tile: int    # flattened (N·L) rows per block
    threads: int     # threads per block
    path: str        # "window" or "generic"
    smem_bytes: int  # dynamic shared memory per block


def plan_unit(c_in: int, c_out: int, taps: int, dilation: int,
              length: int) -> UnitPlan:
    """The kernel's tiles for one unit geometry.

    The output-channel tile is the one of ``CO_TILES`` that computes the
    fewest columns, ``ceil(c_out / t) · t``, the widest on a tie: no column
    is wasted at any flagship unit (48, 64, 96 = 2 × 48, 32, 128 = 2 × 64).
    C_in does not change the plan: the kernel stages it 32 channels at a
    time whatever its size.  Raises ``ValueError`` on a geometry the kernel
    cannot take.
    """
    if min(c_in, c_out, taps, dilation, length) < 1:
        raise ValueError(f"no plan for c_in={c_in}, c_out={c_out}, "
                         f"taps={taps}, dilation={dilation}, length={length}")
    co_tile = min(CO_TILES, key=lambda t: (-(-c_out // t) * t, -t))
    row_tile = ROW_TILES[co_tile]
    threads = row_tile // ROWS_PER_THREAD * (co_tile // COLS_PER_THREAD)
    window = (taps, dilation) in WINDOW_TAPS and length % ROWS_PER_THREAD == 0
    halo = (taps - 1) // 2 * dilation
    smem = 4 * (taps * CI_CHUNK * co_tile
                + (row_tile + 2 * halo) * (CI_CHUNK + 1))
    if smem > SMEM_LIMIT:
        raise ValueError(f"{taps} taps at dilation {dilation} need {smem} B "
                         f"of shared memory per block, over {SMEM_LIMIT}")
    return UnitPlan(co_tile, row_tile, threads,
                    "window" if window else "generic", smem)


def fold_batchnorm(
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference-time BN → (scale, bias) affine over channels."""
    scale = gamma * torch.rsqrt(var + eps)
    bias = beta - mean * scale
    return scale, bias


def _check_geometry(x, kernel, scale, bias, pool) -> None:
    if x.dim() != 3 or kernel.dim() != 3:
        raise ValueError(f"expected x (N, L, C_in) and kernel (K, C_in, C_out), "
                         f"got {tuple(x.shape)} and {tuple(kernel.shape)}")
    taps, k_cin, c_out = kernel.shape
    if k_cin != x.shape[2]:
        raise ValueError(f"kernel C_in {k_cin} != input C_in {x.shape[2]}")
    if taps % 2 == 0:
        raise ValueError(f"SAME padding needs an odd tap count, got {taps}")
    if scale.shape != (c_out,) or bias.shape != (c_out,):
        raise ValueError(f"scale/bias must be ({c_out},), got "
                         f"{tuple(scale.shape)} and {tuple(bias.shape)}")
    if pool and x.shape[1] % 2:
        raise ValueError(f"fused pool needs even length, got {x.shape[1]}")


def conv1d_bn_relu_reference(
    x: torch.Tensor,
    kernel: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    dilation: int = 1,
    relu: bool = True,
    pool: bool = False,
) -> torch.Tensor:
    """The plain version: Σ_k shift(x, k·d) @ W[k] in f32, then the epilogue."""
    _check_geometry(x, kernel, scale, bias, pool)
    n, length, _c_in = x.shape
    taps = kernel.shape[0]
    halo = (taps - 1) // 2 * dilation
    x = x.float()
    padded = torch.nn.functional.pad(x, (0, 0, halo, halo))
    out = None
    for k in range(taps):
        term = padded[:, k * dilation : k * dilation + length, :] @ kernel[k].float()
        out = term if out is None else out + term
    out = out * scale + bias
    if relu:
        out = torch.relu(out)
    if pool:
        out = torch.maximum(out[:, 0::2, :], out[:, 1::2, :])
    return out


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel's C entry point, built and bound on first use."""
    fn = kernel_build.load(_KERNEL).deepbinner_conv1d_bn_relu
    # Every pointer and the stream as c_void_p: a bare Python int would be
    # passed as a 32-bit int and cut the address.
    # 8 ints of geometry and 5 of the plan; a stale count would pass garbage.
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_conv1d_bn_relu(
    x: torch.Tensor,
    kernel: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    dilation: int = 1,
    relu: bool = True,
    pool: bool = False,
) -> torch.Tensor:
    """SAME-padded 1D conv fused with a channel affine (+ReLU, +maxpool2).

    Args:
      x: ``(N, L, C_in)`` float32.
      kernel: ``(K, C_in, C_out)`` (flax Conv layout), K odd.
      scale, bias: ``(C_out,)`` folded BatchNorm affine.
      pool: fuse a trailing stride-2 window-2 maxpool (L must be even).

    Returns ``(N, L', C_out)`` float32 with L' = L//2 when pooling.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel with
    the plan of :func:`plan_unit`.
    """
    if x.device.type == "cpu":
        return conv1d_bn_relu_reference(x, kernel, scale, bias,
                                        dilation=dilation, relu=relu, pool=pool)
    _check_geometry(x, kernel, scale, bias, pool)
    plan = plan_unit(x.shape[2], kernel.shape[2], kernel.shape[0], dilation,
                     x.shape[1])
    return launch_planned(x, kernel, scale, bias, plan, dilation=dilation,
                          relu=relu, pool=pool)


def launch_planned(
    x: torch.Tensor,
    kernel: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    plan: UnitPlan,
    dilation: int = 1,
    relu: bool = True,
    pool: bool = False,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors with a given ``plan``.

    :func:`fused_conv1d_bn_relu` passes :func:`plan_unit`'s plan; a caller
    that times one inner loop against the other passes its own.  A plan the
    library was not built for raises ``RuntimeError``: the C side launches
    nothing and picks no other plan.
    """
    if x.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, x is on {x.device}")
    _check_geometry(x, kernel, scale, bias, pool)
    for name, t in (("x", x), ("kernel", kernel), ("scale", scale),
                    ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, length, c_in = x.shape
    taps, _, c_out = kernel.shape
    out = torch.empty((n, length // 2 if pool else length, c_out),
                      dtype=torch.float32, device=x.device)
    launch = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(x.data_ptr(), kernel.data_ptr(), scale.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), n, length, c_in, c_out,
                    taps, dilation, int(relu), int(pool), plan.co_tile,
                    plan.row_tile, plan.threads, int(plan.path == "window"),
                    plan.smem_bytes, stream)
    if rc != 0:
        reason = _ERRORS.get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"{_KERNEL} launch failed for {plan}: {reason}")
    global LAUNCHES
    LAUNCHES += 1
    return out
