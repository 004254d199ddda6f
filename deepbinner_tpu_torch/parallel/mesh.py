"""The devices of one process, how a batch's rows split over them, and how
a weight's output columns split over the ``'model'`` axis.

Counterpart of ``deepbinner_tpu/parallel/mesh.py``.  The JAX package builds
a ``('data', 'model')`` mesh and lets ``jit`` shard a batch and the weights
over it; the port does both by hand on a ``data × model`` grid of
``torch.device`` entries (:func:`make_grid`):

- along ``'data'`` a batch's rows are split into one contiguous part per
  grid row (:func:`split_rows`), and each part runs on its row;
- along ``'model'`` (tensor parallel) every rank of a row gets the same
  rows, and each conv kernel ``(K, C_in, C_out)`` and dense weight is split
  into contiguous blocks of its output features, one per rank
  (:func:`shard_columns`), where that axis divides by the rank count
  (:func:`split_axis`, ``param_sharding``'s rule leaf by leaf); every other
  tensor is whole on every rank.  The ranks' outputs are gathered in rank
  order (``models/kernel_apply.apply_inference_kernels_tp``).

As in the JAX package, the ``'model'`` axis is a scaling demonstration at
this model size, not a win; ``classify`` builds ``model = 1`` only, and the
dry run (``deepbinner_tpu_torch/entry.py``) builds ``model = 2``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def process_cards() -> List[int]:
    """The card indices this process may use.

    Under a multi-process launch on one host (``LOCAL_WORLD_SIZE`` above 1,
    as ``torchrun`` sets it) local rank r of w takes every w-th card from
    card r, so one process per card gets a card each and one process per
    host gets them all; where there are more local ranks than cards, rank r
    shares card ``r % cards``.  Otherwise every card is the process's.
    """
    cards = list(range(torch.cuda.device_count()))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if local_world <= 1 or not cards:
        return cards
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return cards[local_rank::local_world] or [cards[local_rank % len(cards)]]


def ranks_share_cards() -> bool:
    """Whether this host runs more processes than it has cards."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return local_world > torch.cuda.device_count()


def local_devices(device: str = "cuda", count: int = 0) -> List[torch.device]:
    """The ``torch.device``\\ s of this process, ``count`` of them (0: all).

    On ``cuda`` they are this process's cards (:func:`process_cards`); more
    than it has is an error.  On ``cpu`` they are ``count`` (at least one)
    entries of the CPU, as the JAX tests' virtual CPU devices, so that the
    split arithmetic runs on the CPU.
    """
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * max(count, 1)
    cards = process_cards()
    if count > len(cards):
        raise ValueError(f"{count} devices asked for; this process has "
                         f"{len(cards)} card(s)")
    return [torch.device("cuda", card) for card in cards[: count or len(cards)]]


def make_grid(devices: Sequence, data: int = 0,
              model: int = 1) -> List[List[torch.device]]:
    """A ``data × model`` grid of ``devices``, as rows of ``model`` entries
    (``make_mesh``'s ``('data', 'model')`` mesh).  ``data = 0`` takes all
    the devices.  One entry may repeat, so that one card stands for several
    devices.  Raises ``ValueError`` as ``make_mesh`` does: ``model`` below
    1, a device count that ``model`` does not divide, or too few devices."""
    devices = [torch.device(d) for d in devices]
    if model < 1:
        raise ValueError("model axis must be >= 1")
    if data <= 0:
        if len(devices) % model:
            raise ValueError(f"{len(devices)} devices not divisible by "
                             f"model={model}")
        data = len(devices) // model
    count = data * model
    if count > len(devices):
        raise ValueError(f"need {count} devices, have {len(devices)}")
    return [devices[row * model:(row + 1) * model] for row in range(data)]


def output_axis(name: str, ndim: int) -> int:
    """The output-feature axis of a DemuxNet state-dict tensor: dim 0 of an
    ``nn.Linear`` ``weight`` ``(out, in)``, the trailing one of a conv
    ``kernel`` ``(K, C_in, C_out)`` (flax's layout, where JAX shards it)."""
    return 0 if name.endswith("weight") else ndim - 1


def split_axis(name: str, shape: Sequence[int], model: int) -> Optional[int]:
    """The axis ``model`` ranks split this state-dict tensor along, or None
    where every rank holds it whole: ``param_sharding``'s rule, which splits
    the output features of a tensor of two or more dims where they divide
    by ``model`` (the dense head's 13 classes do not divide by 2 or 4) and
    leaves every 1-D leaf whole."""
    if model <= 1 or len(shape) < 2:
        return None
    axis = output_axis(name, len(shape))
    return axis if shape[axis] % model == 0 else None


def shard_columns(tensor: torch.Tensor, axis: int, rank: int,
                  model: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous block of ``tensor``'s output features along
    ``axis`` where that axis divides by ``model``, else the whole tensor (a
    view; the caller makes it contiguous once)."""
    if not 0 <= rank < model:
        raise ValueError(f"rank {rank} outside a model axis of {model}")
    size = tensor.shape[axis]
    if size % model:
        return tensor
    width = size // model
    return tensor.narrow(axis, rank * width, width)


def split_rows(n: int, parts: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` row ranges of ``parts`` contiguous parts of ``n`` rows, in
    order; the first ``n % parts`` parts take one row more."""
    if parts < 1:
        raise ValueError("parts must be >= 1")
    base, extra = divmod(n, parts)
    bounds, lo = [], 0
    for part in range(parts):
        hi = lo + base + (part < extra)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad `axis` up to a multiple (batch must divide the data axis for DP)."""
    size = array.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return array
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, target - size)
    return np.pad(array, pad)
