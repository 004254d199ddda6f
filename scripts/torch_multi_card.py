#!/usr/bin/env python3
"""The PyTorch/CUDA port's multi-card paths on one host with several cards.

    python3 scripts/torch_multi_card.py

Needs two or more CUDA cards on one host (it exits non-zero with fewer)
and the repository's sources; ``chip_smoke.py`` holds the same paths on
one card.  It builds the port's kernels, then prints one JSON line per
phase:

1. ``cards_split``: ``classify --device_count D`` (``build_program``) for D
   = 1, 2 and every card, at batch 256 and 1024, on 2048 simulated reads:
   calls equal to D = 1's, 15 K1 launches per card per batch, the time
   of one batch split over the D cards (host clock around 10 calls from
   pinned host memory, every card synchronised): the scaling of the split
   program; and where that time goes (``profile``: the host ms to enqueue
   each card's step, and each card's kernel span in a ``torch.profiler``
   trace of one call).
2. ``cards_classify``: `simulate` writes 2048 reads in 8 pod5 files, one
   process classifies them on one card, then one CLI rank per card
   (``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` as
   ``torchrun`` sets them; each rank on its own card, so the process group
   is ``cpu:gloo,cuda:nccl``) classifies a file shard each: rank 0's table
   must equal the single process's byte for byte, the others print none.
3. ``cards_train``: the rows of ``chip_smoke.py``'s ``train`` phase; the
   first 5 flagship Trainer steps in float64 as one process and as one
   rank per card (NCCL), losses within 1e-4 relative; then 6 epochs in f32
   through the CLI as one process and as one rank per card: the ranks'
   states bit-identical after every epoch, the median ms per step of each
   layout, rank 0's ``.dbt`` at the accuracy floor through K1, and one
   process's step on one card at the full batch and at a rank's share of
   it; then ``train --dp <cards>`` for one epoch through the CLI's own
   spawn.
4. ``cards_tp``: the ``'model'`` axis on real cards.  ``ClassifyProgram``
   over a ``make_grid`` of the cards, data 1 × model 2, data 2 × model 2
   and data 1 × model 4 (those that fit the cards present), on the 2048
   reads at batch 1024: calls equal to the one-card unit path's on every
   read, combined probabilities within 1e-5, 2 × 15 K1 launches per grid
   row per batch; the host ms per batch (every card synchronised) beside
   the one-card unit path's and the data-parallel split's over as many
   cards, and the gathers and peer copies (an activation sent between two
   cards) per batch.

The last lines are each card's ``nvidia-smi`` name and power limit and
``{"ok": true, ...}``.  Any failure raises, so the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (the repository root, above)

SPLIT_REPS = 10


def _sync_all() -> None:
    import torch

    for card in range(torch.cuda.device_count()):
        torch.cuda.synchronize(card)


def _split_ms(program, sig, lens) -> float:
    """Host ms per batch over SPLIT_REPS calls from pinned host memory,
    every card synchronised after the last."""
    program.call_packed(sig, lens)
    _sync_all()
    start = time.perf_counter()
    for _ in range(SPLIT_REPS):
        program.call_packed(sig, lens)
    _sync_all()
    return (time.perf_counter() - start) / SPLIT_REPS * 1e3


def _split_profile(program, sig, lens) -> dict:
    """Where one split batch's time goes: the host ms to enqueue each
    device's step (no synchronisation), and from a ``torch.profiler`` trace
    of one call each device's first kernel start, last kernel end (µs from
    the first kernel of the call) and kernel ms; overlapping spans mean the
    cards ran at once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepbinner_tpu_torch.runner.pipeline import _on, classify_step, full_f32

    # Each array's per-device parts (one device: the tensor itself).
    parts = [p if p is None or isinstance(p, list) else [p]
             for p in program.upload(sig, lens)]
    _sync_all()
    enqueue = []
    with full_f32(), torch.inference_mode():
        for k, dev in enumerate(program.leaders):
            start = time.perf_counter()
            with _on(dev):
                classify_step(program.cfg, *program.nets[k],
                              *(None if p is None else p[k] for p in parts))
            enqueue.append((time.perf_counter() - start) * 1e3)
    _sync_all()
    start = time.perf_counter()
    program.call_packed(sig, lens)
    call_enqueue_ms = (time.perf_counter() - start) * 1e3
    _sync_all()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        program.call_packed(sig, lens)
        _sync_all()
    spans = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            spans.setdefault(event.device_index, []).append(
                (event.time_range.start, event.time_range.end))
    origin = min((s for ranges in spans.values() for s, _e in ranges),
                 default=0)
    return {"step_enqueue_ms": enqueue, "call_enqueue_ms": call_enqueue_ms,
            "kernels": {str(dev): {
                "first_us": min(s for s, _e in r) - origin,
                "last_us": max(e for _s, e in r) - origin,
                "kernel_ms": sum(e - s for s, e in r) / 1e3,
                "count": len(r)} for dev, r in sorted(spans.items())}}


def phase_split(reads, cards: int) -> dict:
    import torch

    from deepbinner_tpu_torch.parallel import mesh
    from deepbinner_tpu_torch.runner.executor import build_batch

    counts = sorted({1, 2, cards})
    lines = {}
    for batch in (256, 1024):
        base = None
        for count in counts:
            program = smoke._build_program(extra=[
                "--device_count", str(count), "--batch_size", str(batch)])
            want = mesh.local_devices(program.device.type, count)
            if program.devices != want:
                raise AssertionError(f"cards_split: --device_count {count} "
                                     f"gave {program.devices}")
            program.warm_up(batch)
            smoke.BATCH = batch
            calls, stats, seconds, launches = smoke._run_stream(program, reads)
            smoke._check_launches(launches, stats.batches,
                                  {"conv1d_bn_relu": 15 * count,
                                   "trunk_megakernel": 0},
                                  f"cards_split D={count} batch {batch}")
            if base is None:
                base = calls
            smoke._same_calls(f"cards_split D={count}", calls, base)
            _ids, sig, lens, _e, _el = build_batch(
                reads[:batch], program.cfg.preprocess, batch, False)
            sig = torch.from_numpy(sig).pin_memory()
            lens = torch.from_numpy(lens).pin_memory()
            lines[f"b{batch}_d{count}"] = {
                "devices": [str(d) for d in program.devices],
                "batches": stats.batches, "stream_s": seconds,
                "stream_reads_per_s": len(reads) / seconds,
                "launches": launches, "batch_ms": _split_ms(program, sig, lens),
                "profile": _split_profile(program, sig, lens)}
            del program
            torch.cuda.empty_cache()
    smoke.BATCH = 256
    smoke.emit("cards_split", cards=cards, reads=len(reads),
               reps=SPLIT_REPS, **lines)
    return lines


def phase_cards_classify(cards: int) -> dict:
    root = os.path.join(smoke.WORK_DIR, "cards_cli")
    shutil.rmtree(root, ignore_errors=True)
    smoke._run_cli(["simulate", root, "--container", "pod5",
                    "--reads_per_barcode", "170", "--none_reads", "8",
                    "--genome_length", "1200", "--seed", "5"])
    pod5_dir = os.path.join(root, "fast5s")
    argv = ["classify", pod5_dir, "-s", smoke.START_MODEL, "-e",
            smoke.END_MODEL, "--batch_size", str(smoke.BATCH)]
    single, _err, single_s = smoke._run_cli(argv + ["--device_count", "1"])
    ranks = smoke._run_ranks("cards_classify", argv, world=cards)
    if ranks[0][0] != single:
        raise AssertionError("cards_classify: rank 0's table differs from "
                             "the single process's")
    if any(out for out, _e, _s, _r in ranks[1:]):
        raise AssertionError("cards_classify: a rank other than 0 printed")
    for rank, (_out, err, _s, result) in enumerate(ranks):
        if f"device: cuda:{rank}" not in err or "cpu:gloo,cuda:nccl" not in err:
            raise AssertionError(f"cards_classify: rank {rank} is not on "
                                 f"card {rank} with NCCL for CUDA tensors")
        smoke._check_launches(result["launches"], smoke._logged_batches(err),
                              {"conv1d_bn_relu": 30, "trunk_megakernel": 0},
                              f"cards_classify rank {rank}")
    line = {"ranks": cards, "rows": len(single.splitlines()) - 1,
            "single_s": single_s, "rank_s": [r[2] for r in ranks],
            "rank_reads_per_s_logged": [smoke._cli_throughput(r[1])
                                        for r in ranks],
            "rank_batches": [smoke._logged_batches(r[1]) for r in ranks]}
    smoke.emit("cards_classify", table_identical=True, **line)
    shutil.rmtree(root, ignore_errors=True)
    return line


def _one_card_step_ms(rows: str, batch: int, steps: int = 12) -> float:
    """Median ms (CUDA events, after two warm-up steps) of one process's
    flagship Trainer step on one card at ``batch`` rows: what a rank's
    share of the batch costs without its collectives."""
    import numpy as np
    import torch

    from deepbinner_tpu_torch.models.network import NetworkConfig
    from deepbinner_tpu_torch.train.data import load_training_set
    from deepbinner_tpu_torch.train.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(network=NetworkConfig(), batch_size=batch),
                      torch.device("cuda", 0))
    signals, labels = load_training_set(rows)
    times = []
    for step in range(steps):
        index = np.arange(step * batch, (step + 1) * batch) % len(labels)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.run_train_step(signals[index], labels[index])
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times[2:])


def phase_cards_train(cards: int) -> dict:
    from deepbinner_tpu_torch.train.data import write_samples

    root = os.path.join(smoke.WORK_DIR, "cards_train")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    prepped, balanced = (os.path.join(root, "prep.tsv"),
                         os.path.join(root, "balanced.tsv"))
    write_samples(prepped, smoke._training_rows(
        smoke.TRAIN_READS_PER_BARCODE, seed=11))
    smoke._run_cli(["balance", prepped, "--out", balanced, "--none_fraction",
                    str(smoke.TRAIN_NONE_FRACTION), "--seed", "0"])

    single_f64 = os.path.join(root, "f64.json")
    smoke._f64_steps(balanced, single_f64)
    with open(single_f64) as handle:
        f64_single = json.load(handle)["losses"]
    f64_ranks = [r[3]["losses"] for r in smoke._run_ranks(
        "cards_f64", ["f64_steps", balanced], world=cards)]
    f64_rel = [abs(got - want) / abs(want)
               for got, want in zip(f64_ranks[0], f64_single)]
    if max(f64_rel) > 1e-4 or any(r != f64_ranks[0] for r in f64_ranks):
        raise AssertionError(f"cards_train: float64 steps {f64_rel}, ranks "
                             f"{f64_ranks}")

    epochs = smoke.DP_TRAIN_EPOCHS
    with smoke._watch_trainer() as single:
        smoke._run_cli(smoke._train_argv(
            balanced, os.path.join(root, "single.dbt"), epochs))
    ranks_out = os.path.join(root, "ranks.dbt")
    ranks = smoke._run_ranks("cards_train", smoke._train_argv(
        balanced, ranks_out, epochs), world=cards)
    results = [r[3] for r in ranks]
    if any(r["digests"] != results[0]["digests"] for r in results):
        raise AssertionError("cards_train: the ranks' states differ after an "
                             "epoch")
    program = smoke._build_program(start_model=ranks_out)
    program.warm_up(smoke.BATCH)
    floor_reads, floor_truth = smoke._floor_reads()
    calls, stats, _s, launches = smoke._run_stream(program, floor_reads)
    smoke._check_launches(launches, stats.batches,
                          {"conv1d_bn_relu": 15, "trunk_megakernel": 0},
                          "cards_train")
    exact, wrong = smoke._score(calls, floor_truth)
    if wrong or exact < 38:
        raise AssertionError(f"cards_train: floor {exact}/40, {wrong} wrong")

    spawn_out = os.path.join(root, "spawned.dbt")
    _o, spawn_err, spawn_s = smoke._run_cli(smoke._train_argv(
        balanced, spawn_out, 1, "--dp", str(cards)))
    if (not os.path.exists(spawn_out)
            or f"data-parallel: {cards} ranks on this host" not in spawn_err):
        raise AssertionError("cards_train: train --dp wrote no model")

    per_epoch = len(single["steps"]) // epochs
    single_ms = [s.elapsed_time(e) for s, e, _l in single["steps"][per_epoch:]]
    single_losses = [float(l) for _s, _e, l in single["steps"]]
    line = {
        "ranks": cards, "epochs": epochs, "f64_first5_rel": f64_rel,
        "f32_first5_rel": [abs(got - want) / abs(want) for got, want in
                           zip(results[0]["losses"][:5], single_losses[:5])],
        "ranks_bit_identical_each_epoch": True,
        "single_step_ms_median": statistics.median(single_ms),
        "rank_step_ms_median": [statistics.median(r["step_ms"][per_epoch:])
                                for r in results],
        "single_val_accuracy": [e["accuracy"] for e in single["evals"]],
        "rank_val_accuracy": [e["accuracy"] for e in results[0]["evals"]],
        "one_card_step_ms": {str(b): _one_card_step_ms(balanced, b) for b in
                             (smoke.TRAIN_BATCH, smoke.TRAIN_BATCH // cards)},
        "rank_s": [r[2] for r in ranks], "floor_exact": exact,
        "floor_wrong": wrong, "spawn_one_epoch_s": spawn_s}
    smoke.emit("cards_train", **line)
    shutil.rmtree(root, ignore_errors=True)
    return line


TP_BATCH = 1024
TP_LAYOUTS = ((1, 2), (2, 2), (1, 4))   # (data, model)


def phase_cards_tp(reads, cards: int) -> dict:
    import numpy as np
    import torch

    from deepbinner_tpu_torch.models import kernel_apply
    from deepbinner_tpu_torch.models.checkpoint import load_model
    from deepbinner_tpu_torch.runner.executor import build_batch
    from deepbinner_tpu_torch.runner.pipeline import ClassifyProgram

    model = load_model(smoke.START_MODEL)[0]
    smoke.BATCH = TP_BATCH
    one = smoke._build_program(extra=["--batch_size", str(TP_BATCH)])
    cfg = one.cfg
    one.warm_up(TP_BATCH)
    base_probs = {}
    base, _stats, _s, _l = smoke._run_stream(one, reads, base_probs)
    _ids, sig, lens, _e, _el = build_batch(reads[:TP_BATCH], cfg.preprocess,
                                           TP_BATCH, False)
    sig = torch.from_numpy(sig).pin_memory()
    lens = torch.from_numpy(lens).pin_memory()
    lines = {"one_card_ms": _split_ms(one, sig, lens)}
    for data, model_axis in TP_LAYOUTS:
        count = data * model_axis
        if count > cards:
            lines[f"d{data}_m{model_axis}"] = f"not run: {cards} cards"
            continue
        devices = [torch.device("cuda", k) for k in range(count)]
        program = ClassifyProgram(model, cfg, devices=devices, model=model_axis)
        program.warm_up(TP_BATCH)
        probs = {}
        calls, stats, seconds, launches = smoke._run_stream(program, reads,
                                                            probs)
        what = f"cards_tp data {data} × model {model_axis}"
        smoke._check_launches(launches, stats.batches,
                              {"conv1d_bn_relu": 15 * count,
                               "trunk_megakernel": 0}, what)
        smoke._same_calls(what, calls, base)
        diff = max(float(np.abs(p - base_probs[rid]).max())
                   for rid, p in probs.items())
        if diff > 1e-5:
            raise AssertionError(f"{what}: combined probabilities differ "
                                 f"from one card's by {diff}")
        kernel_apply.GATHERS = kernel_apply.PEER_COPIES = 0
        program.call_packed(sig, lens).cpu()
        gathers, copies = kernel_apply.GATHERS, kernel_apply.PEER_COPIES
        split = ClassifyProgram(model, cfg, devices=devices)
        split.warm_up(TP_BATCH)
        lines[f"d{data}_m{model_axis}"] = {
            "grid": [[str(d) for d in row] for row in program.grid],
            "batches": stats.batches, "stream_s": seconds,
            "launches": launches, "same_calls": len(calls),
            "max_prob_diff_vs_one_card": diff,
            "batch_ms": _split_ms(program, sig, lens),
            "data_parallel_batch_ms": _split_ms(split, sig, lens),
            "gathers_per_batch": gathers, "peer_copies_per_batch": copies}
        del program, split
        torch.cuda.empty_cache()
    smoke.BATCH = 256
    smoke.emit("cards_tp", cards=cards, reads=len(reads), batch=TP_BATCH,
               reps=SPLIT_REPS, **lines)
    return lines


def main() -> int:
    import subprocess

    import torch

    if not os.path.isdir(smoke.PACKAGE):
        print("torch_multi_card: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"torch_multi_card: {cards} CUDA card(s); this script needs "
              f"two or more", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    os.makedirs(smoke.WORK_DIR, exist_ok=True)
    try:
        smoke.emit("env", nvidia_smi=smi, cards=cards,
                   torch=torch.__version__, kernel_build_s=smoke.build_kernels())
        reads, _truth = smoke._simulated_reads(2048, seed=2024)
        phase_split(reads, cards)
        phase_cards_tp(reads, cards)
        phase_cards_classify(cards)
        phase_cards_train(cards)
    finally:
        stopped = smoke.stop_child_processes()
    smoke.emit("processes", **stopped)
    if stopped["workers"] or stopped["others"]:
        raise AssertionError(f"processes left running: {stopped}")
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
