"""The devices of one process and how a batch's rows split over them.

Counterpart of ``deepbinner_tpu/parallel/mesh.py``.  The JAX package builds
a ``('data', 'model')`` mesh and lets ``jit`` shard a batch over it; the port
is data parallel by hand: a batch's rows are split into one contiguous part
per device (:func:`split_rows`), the weights are copied to each device, and
each part runs on its device.  The ``'model'`` axis (tensor-parallel
shardings, ``param_sharding``) is not ported.
"""

from __future__ import annotations

import os
from typing import List, Tuple

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
