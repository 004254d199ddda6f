"""The port's top-level entry points: the flagship classify step and the
multi-device dry run.

Counterpart of ``__graft_entry__.py``:

- :func:`entry` returns the flagship classify step
  (:func:`~deepbinner_tpu_torch.runner.pipeline.classify_step`) and its
  example arguments, on the card unless ``device="cpu"`` is asked for;
- :func:`dryrun_multichip` builds a ``data × model`` grid of n devices
  (``model = 2`` at four or more even devices), takes one data-parallel
  train step and an eval of the tiny network over the grid's data axis,
  then classifies simulated reads with the committed tiny model twice, data
  parallel and with column-parallel weights over the ``'model'`` axis, and
  requires equal calls spread over at least 3 classes.

    python -m deepbinner_tpu_torch.entry [--device cpu] [--devices N]

runs the dry run where N is above 1 and the forward step otherwise.  On the
CPU the n devices are n entries of the CPU; on the card, where there are
fewer cards than n, entries repeat.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepbinner_tpu_torch import resolve_device
from deepbinner_tpu_torch.models.checkpoint import load_model
from deepbinner_tpu_torch.models.kernel_apply import fold_network
from deepbinner_tpu_torch.models.network import DemuxNet, NetworkConfig, init_weights
from deepbinner_tpu_torch.ops.calling import CallingConfig
from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
from deepbinner_tpu_torch.parallel import dist, mesh
from deepbinner_tpu_torch.runner.pipeline import (
    CallTable,
    ClassifyConfig,
    ClassifyProgram,
    classify_step,
    full_f32,
)
from deepbinner_tpu_torch.train.trainer import TINY_PRESET, TrainConfig, Trainer
from deepbinner_tpu_torch.utils import simulate

TINY_MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "deepbinner_tpu", "models", "data", "TINY_dryrun.dbt")
ENTRY_BATCH = 32


def entry(device=None) -> Tuple[Callable[..., CallTable], tuple]:
    """``(fn, example_args)``: the flagship classify step and a batch of 32
    all-zero reads of the buffer size, on ``device`` (the card unless
    ``"cpu"`` is asked for).  The weights come from
    :func:`~deepbinner_tpu_torch.models.network.init_weights` on a generator
    seeded 0, folded for the kernels; ``fn(net, signal, lengths)`` returns
    the batch's :class:`~deepbinner_tpu_torch.runner.pipeline.CallTable`."""
    device = resolve_device(device)
    model = init_weights(DemuxNet(NetworkConfig()),
                         torch.Generator().manual_seed(0))
    cfg = ClassifyConfig(preprocess=PreprocessConfig(),
                         calling=CallingConfig(), dual_model=False)
    buffer = cfg.preprocess.buffer_size
    signal = torch.zeros((ENTRY_BATCH, buffer), dtype=torch.float32,
                         device=device)
    lengths = torch.full((ENTRY_BATCH,), buffer, dtype=torch.int32,
                         device=device)

    def fn(net, signal, lengths) -> CallTable:
        with full_f32(), torch.inference_mode():
            return classify_step(cfg, net, None, signal, lengths)

    return fn, (fold_network(model, device), signal, lengths)


def model_axis(n_devices: int) -> int:
    """The dry run's ``'model'`` axis: 2 at four or more even devices."""
    return 2 if n_devices % 2 == 0 and n_devices >= 4 else 1


def dryrun_devices(n_devices: int, device="cuda") -> List[torch.device]:
    """``n_devices`` entries: of the CPU, or of the cards in turn (repeating
    where there are fewer cards than entries)."""
    device = resolve_device(device)
    if device.type == "cpu":
        return [device] * n_devices
    cards = torch.cuda.device_count()
    return [torch.device("cuda", k % cards) for k in range(n_devices)]


def _train_batch(batch: int) -> Tuple[np.ndarray, np.ndarray]:
    """The dry run's global training batch: rows of twice the tiny input."""
    rng = np.random.default_rng(0)
    signals = rng.normal(450, 50, (batch, 2 * TINY_PRESET.input_length)
                         ).astype(np.float32)
    labels = rng.integers(0, 13, batch).astype(np.int32)
    return signals, labels


def dryrun_train_step(device_type: str, batch: int, out_dir: str,
                      world: int) -> dict:
    """One train step and an eval of the tiny network on the global batch,
    as rank ``r`` of ``world`` spawned ranks (:func:`_dryrun_train`).  Writes ``{"rank", "world", "device", "loss", "eval"}`` to
    ``out_dir/rank<r>.json`` and returns it."""
    rank, group = dist.group_rank_and_size()
    if group != world:
        raise RuntimeError(f"rank {rank}: process group of {group}, "
                           f"expected {world}")
    device = (torch.device("cpu") if device_type == "cpu"
              else torch.device("cuda", mesh.process_cards()[0]))
    cfg = TrainConfig(network=TINY_PRESET, batch_size=batch, epochs=1,
                      test_fraction=0.0, seed=0)
    trainer = Trainer(cfg, device, rank=rank, world=world)
    signals, labels = _train_batch(batch)
    loss = float(trainer.run_train_step(signals, labels)["loss"])
    evaluation = trainer.run_eval(signals, labels)
    result = {"rank": rank, "world": world, "device": str(device),
              "loss": loss, "eval": evaluation}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as handle:
        json.dump(result, handle)
    return result


def _dryrun_train(world: int, device_type: str, batch: int) -> List[dict]:
    """:func:`dryrun_train_step` over ``world`` spawned ranks (gloo on the
    CPU or where ranks share a card); each rank's result, in rank order."""
    with tempfile.TemporaryDirectory(prefix="dryrun-train-") as out_dir:
        dist.spawn_ranks(dryrun_train_step, (device_type, batch, out_dir,
                                             world), world, device_type)
        results = []
        for rank in range(world):
            with open(os.path.join(out_dir, f"rank{rank}.json")) as handle:
                results.append(json.load(handle))
    return results


class DryrunClassify(NamedTuple):
    """What :func:`_dryrun_classify` found."""

    calls: np.ndarray    # (B,) data-parallel calls (== the model-axis calls)
    truth: np.ndarray    # (B,) each read's simulated barcode
    n_params: int        # parameters of the model
    probs: np.ndarray    # (B, C) combined probabilities, model-axis path
    signal: np.ndarray   # (B, buffer) int16 reads as classified
    lengths: np.ndarray  # (B,) int32


def dryrun_reads(n_devices: int, pre: PreprocessConfig
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``__graft_entry__._dryrun_classify``'s reads: barcode ``i % 13`` from
    seed 3 at genome length 400, ``max(2n, 13)`` of them rounded up to a
    multiple of n.  Returns (signal, lengths, truth)."""
    batch = max(2 * n_devices, 13)
    batch += (-batch) % n_devices
    rng = np.random.default_rng(3)
    sig = np.zeros((batch, pre.buffer_size), np.int16)
    lens = np.zeros((batch,), np.int32)
    truth = np.zeros((batch,), np.int32)
    for i in range(batch):
        read = simulate.simulate_read("EXP-NBD103", i % 13, rng,
                                      genome_length=400)
        n = min(read.signal.size, pre.buffer_size)
        sig[i, :n] = read.signal[:n]
        lens[i] = n
        truth[i] = i % 13
    return sig, lens, truth


def _dryrun_classify(grid: List[List[torch.device]],
                     mutate: Optional[Callable[[DemuxNet], DemuxNet]] = None
                     ) -> DryrunClassify:
    """The committed tiny model on simulated reads, classified data
    parallel over every device of ``grid`` and with column-parallel weights
    over its ``'model'`` axis; asserts that both give the same calls.
    ``mutate`` (tests only) transforms the loaded model before both run."""
    model, net_cfg, _meta = load_model(TINY_MODEL)
    if mutate is not None:
        model = mutate(model)
    window = net_cfg.input_length
    pre = PreprocessConfig(scan_size=3 * window, window=window,
                           stride=window // 2)
    cfg = ClassifyConfig(preprocess=pre, calling=CallingConfig())
    devices = [dev for row in grid for dev in row]
    sig, lens, truth = dryrun_reads(len(devices), pre)
    dp = ClassifyProgram(model, cfg, devices=devices)
    tp = ClassifyProgram(model, cfg, devices=devices, model=len(grid[0]))
    dp_calls = dp(sig, lens).calls.cpu().numpy()
    tp_table = tp(sig, lens)
    tp_calls = tp_table.calls.cpu().numpy()
    if not np.array_equal(dp_calls, tp_calls):
        raise AssertionError(f"data-parallel calls {dp_calls.tolist()} != "
                             f"model-axis calls {tp_calls.tolist()}")
    n_params = sum(p.numel() for p in model.parameters())
    n_params += sum(b.numel() for b in model.buffers())
    return DryrunClassify(dp_calls, truth, n_params,
                          tp_table.start_probs.cpu().numpy(), sig, lens)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One data-parallel train step and eval, then the data-parallel and
    model-axis classify check, over ``n_devices`` devices; prints what it
    found and returns it."""
    devices = dryrun_devices(n_devices, device)
    model = model_axis(n_devices)
    grid = mesh.make_grid(devices, model=model)
    shape = {"data": len(grid), "model": model}
    print(f"dryrun grid: {shape} on {[str(d) for d in devices]}")

    ranks = _dryrun_train(len(grid), devices[0].type, 2 * n_devices)
    losses = [r["loss"] for r in ranks]
    if not all(math.isfinite(loss) for loss in losses):
        raise AssertionError(f"non-finite loss {losses}")
    if not all(math.isfinite(r["eval"]["loss"]) for r in ranks):
        raise AssertionError(f"non-finite eval loss {ranks}")
    print(f"dryrun ok: train loss {losses[0]:.4f}, eval acc "
          f"{ranks[0]['eval']['accuracy']:.3f} over {len(ranks)} rank(s) "
          f"of {n_devices} devices")

    result = _dryrun_classify(grid)
    dist_ = np.bincount(result.calls, minlength=13)
    distinct = int((dist_ > 0).sum())
    if distinct < 3:
        raise AssertionError(
            f"degenerate call distribution {dist_.tolist()}: the data-"
            f"parallel == model-axis check has no sensitivity (is "
            f"TINY_dryrun.dbt missing or untrained?)")
    accuracy = float((result.calls == result.truth).mean())
    print(f"dryrun classify ok: dp calls == tp calls on {result.truth.size} "
          f"simulated reads ({distinct} distinct classes, distribution "
          f"{dist_.tolist()}, truth match {accuracy:.2f}); "
          f"{result.n_params} params, grid {shape}, torch {torch.__version__}")
    return {"grid": shape, "devices": [str(d) for d in devices],
            "losses": losses, "eval": ranks[0]["eval"],
            "calls": result.calls.tolist(), "truth": result.truth.tolist(),
            "distribution": dist_.tolist(), "distinct": distinct,
            "truth_match": accuracy, "n_params": result.n_params}


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m deepbinner_tpu_torch.entry",
        description="The port's forward entry (one device) or multi-device "
                    "dry run")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Device kind (default cuda; cpu must be asked "
                             "for)")
    parser.add_argument("--devices", type=int, default=0,
                        help="Devices of the dry run (0 = the cards present; "
                             "1 on the CPU)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    count = args.devices or (torch.cuda.device_count()
                             if device.type == "cuda" else 1)
    print(f"devices: {count} ({device.type})")
    if count > 1:
        dryrun_multichip(count, device.type)
        return
    fn, example = entry(device)
    out = fn(*example)
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"entry ok: calls shape {tuple(out.calls.shape)}")


if __name__ == "__main__":
    main()
