"""Multi-process runs: the process group, file sharding, the table gather,
and the sums of data-parallel training.

Counterpart of ``deepbinner_tpu/parallel/dist.py``, on ``torch.distributed``:

1. a process is one rank of a job when ``WORLD_SIZE`` above 1 is in its
   environment, with ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` and
   ``LOCAL_RANK`` (and ``LOCAL_WORLD_SIZE``), as ``torchrun`` sets them;
   :func:`maybe_initialize` then joins the process group, and a group that
   does not come up fails the run;
2. every process classifies a deterministic shard of the *sorted* file list
   (stride by process index), then the per-shard ``(read_id, call)`` tables
   and ``--verbose`` lines are all-gathered as fixed-width uint8 buffers over
   gloo, on the CPU (they are host data), and merged in sorted order, so
   process 0's table is byte-identical to a single process's;
3. data-parallel training sums across ranks (:class:`RowShard`): BatchNorm's
   statistics, the loss denominator, the gradients and the eval totals.

Collectives on CUDA tensors go over NCCL where every rank of a host has a
card of its own, and over gloo on the CPU or where ranks share a card (NCCL
refuses two ranks on one card).  The layout decides, never a failure.
Single-process runs skip every collective.  ``DEEPBINNER_TPU_PROCESS_INDEX``
and ``DEEPBINNER_TPU_PROCESS_COUNT`` simulate the sharding with no process
group, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from deepbinner_tpu_torch.parallel.mesh import (
    process_cards,
    ranks_share_cards,
    split_rows,
)
from deepbinner_tpu_torch.utils.log import log


def collective_backend(device_type: str) -> str:
    """The process group's backend for this layout: gloo for CPU tensors
    always; NCCL for CUDA tensors only where each rank has its own card."""
    if device_type == "cuda" and not ranks_share_cards():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def free_port() -> int:
    """A TCP port on localhost that is free now (for ``MASTER_PORT``)."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def rank_environ(rank: int, world: int, port: int) -> Dict[str, str]:
    """The launch variables of rank ``rank`` of ``world`` ranks on this
    host, as ``torchrun --nproc_per_node world`` sets them."""
    return {"RANK": str(rank), "LOCAL_RANK": str(rank),
            "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def spawn_ranks(target, args: tuple, world: int, device_type: str) -> None:
    """Run ``target(*args)`` as ``world`` ranks of one process group on this
    host (spawned processes, ``localhost`` and a free port) and wait for
    them.  Each rank joins the group before ``target`` runs and leaves it
    after.  If one rank fails, the others are stopped and
    ``torch.multiprocessing``'s ``ProcessRaisedException`` or
    ``ProcessExitedException`` is raised."""
    import torch.multiprocessing as mp

    port = free_port()
    log(f"  process group on localhost:{port}")
    mp.spawn(_spawned_rank, args=(target, args, world, port, device_type),
             nprocs=world, join=True)


def _spawned_rank(local_rank: int, target, args: tuple, world: int, port: int,
                  device_type: str) -> None:
    """One rank of :func:`spawn_ranks` (a spawned process)."""
    os.environ.update(rank_environ(local_rank, world, port))
    maybe_initialize(device_type)
    ok = False
    try:
        target(*args)
        ok = True
    finally:
        shutdown(ok)


def maybe_initialize(device_type: str = "cuda") -> None:
    """Join the process group when launched as one rank of a job.

    A no-op unless ``WORLD_SIZE`` is above 1.  Errors of
    ``init_process_group`` (a peer that never comes, a port in use)
    propagate: the run fails rather than carry on as a single process.
    """
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or tdist.is_initialized():
        return
    if device_type == "cuda" and process_cards():
        # NCCL works on the current device: make it this rank's card.
        torch.cuda.set_device(process_cards()[0])
    backend = collective_backend(device_type)
    tdist.init_process_group(backend=backend, init_method="env://")
    reason = ("ranks share a card" if device_type == "cuda"
              and backend == "gloo" else f"device {device_type}")
    log(f"  process group: rank {tdist.get_rank()} of "
        f"{tdist.get_world_size()} over {backend} ({reason})")


def barrier() -> None:
    """Wait for every rank, over gloo on the CPU (so a run whose only
    collectives are host data starts no NCCL communicator for it)."""
    if tdist.is_initialized():
        tdist.all_reduce(torch.zeros(1))


def shutdown(ok: bool = True) -> None:
    """Leave the process group.  After a clean run every rank meets at a
    barrier first; after a failure the group is destroyed at once, which
    closes its connections, so a peer waiting in a collective fails instead
    of hanging."""
    if not tdist.is_initialized():
        return
    try:
        if ok:
            barrier()
    finally:
        tdist.destroy_process_group()


def _env_override() -> Tuple[int, int] | None:
    index = os.environ.get("DEEPBINNER_TPU_PROCESS_INDEX")
    count = os.environ.get("DEEPBINNER_TPU_PROCESS_COUNT")
    if index is not None and count is not None:
        return int(index), int(count)
    return None


def process_index() -> int:
    override = _env_override()
    if override is not None:
        return override[0]
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    override = _env_override()
    if override is not None:
        return override[1]
    return tdist.get_world_size() if tdist.is_initialized() else 1


def is_primary_host() -> bool:
    return process_index() == 0


def should_emit_table() -> bool:
    """Whether this process prints its merged call table.

    With a process group the merge is global, so only process 0 prints.
    Under env-simulated sharding there is no group: each simulated process
    holds only its own shard and prints it.
    """
    return _env_override() is not None or process_index() == 0


def shard_files(files: Sequence[str]) -> List[str]:
    """Deterministic per-process shard: sorted list, stride by process index."""
    count = process_count()
    if count <= 1:
        return list(files)
    ordered = sorted(files)
    return ordered[process_index()::count]


def _encode_rows(rows: Sequence[Tuple[str, str]], width: int) -> np.ndarray:
    payload = json.dumps(rows).encode()
    if len(payload) > width:
        raise ValueError(f"shard table {len(payload)}B exceeds buffer {width}B")
    out = np.zeros((width + 8,), np.uint8)
    out[:8] = np.frombuffer(np.uint64(len(payload)).tobytes(), np.uint8)
    out[8 : 8 + len(payload)] = np.frombuffer(payload, np.uint8)
    return out


def _decode_rows(buffer: np.ndarray) -> list:
    length = int(np.frombuffer(buffer[:8].tobytes(), np.uint64)[0])
    payload = buffer[8 : 8 + length].tobytes().decode()
    return json.loads(payload)


def _allgather_json(payload_rows: list) -> List[list]:
    """All-gather one JSON-serialisable list per process → list of lists.

    The sizes are gathered first, then every process's payload padded to the
    largest, as CPU uint8 tensors (gloo).
    """
    world = tdist.get_world_size()
    size = torch.tensor([len(json.dumps(payload_rows).encode())], dtype=torch.int64)
    sizes = [torch.zeros_like(size) for _ in range(world)]
    tdist.all_gather(sizes, size)
    width = int(max(int(s) for s in sizes))
    encoded = torch.from_numpy(_encode_rows(payload_rows, width))
    gathered = [torch.zeros_like(encoded) for _ in range(world)]
    tdist.all_gather(gathered, encoded)
    return [_decode_rows(g.numpy()) for g in gathered]


def merge_call_tables(
    local_rows: Sequence[Tuple[str, str]]
) -> List[Tuple[str, str]]:
    """All-gather per-shard call tables and merge canonically (sorted ids)."""
    from deepbinner_tpu_torch.utils.table import merge_shard_tables

    if process_count() <= 1 or _env_override() is not None:
        return merge_shard_tables([list(local_rows)])
    shards = _allgather_json([list(r) for r in local_rows])
    return merge_shard_tables(
        [[tuple(item) for item in shard] for shard in shards]
    )


def merge_lines(local_lines: Sequence[str]) -> List[str]:
    """All-gather per-shard text lines and return the sorted union (the
    ``--verbose`` table; duplicates collapse as at every process count)."""
    if process_count() <= 1 or _env_override() is not None:
        return sorted(set(local_lines))
    merged: List[str] = []
    for shard in _allgather_json(list(local_lines)):
        merged.extend(shard)
    return sorted(set(merged))


def all_sum(tensor: torch.Tensor) -> torch.Tensor:
    """Σ over the ranks of a tensor outside autograd, as a new tensor."""
    out = tensor.detach().clone()
    tdist.all_reduce(out)
    return out


def all_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Σ over the ranks of several tensors in place, in one collective."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    tdist.all_reduce(flat)
    at = 0
    for t in tensors:
        t.copy_(flat[at : at + t.numel()].view_as(t))
        at += t.numel()


@dataclasses.dataclass(frozen=True)
class RowShard:
    """One rank's rows of every global batch in data-parallel training.

    Every rank holds the same global batch of ``total`` rows and takes rows
    :attr:`rows` of it (:func:`split_rows`).  Random draws are made at the
    global batch's shape and cut to those rows; :meth:`sum` is the sum over
    the ranks that BatchNorm's statistics take.
    """

    rank: int
    world: int
    total: int

    @property
    def rows(self) -> slice:
        lo, hi = split_rows(self.total, self.world)[self.rank]
        return slice(lo, hi)

    def sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """Σ over ranks, with a backward that sums the gradient over ranks."""
        return _SumOverRanks.apply(tensor)


class _SumOverRanks(torch.autograd.Function):
    """y = Σ_ranks x.  Each rank's loss is its share of the global loss, so
    the gradient of x is Σ_ranks ∂loss_rank/∂y: the backward sums too."""

    @staticmethod
    def forward(ctx, tensor: torch.Tensor) -> torch.Tensor:
        return all_sum(tensor)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return all_sum(grad)


def group_rank_and_size() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if not tdist.is_initialized():
        return 0, 1
    return tdist.get_rank(), tdist.get_world_size()
