"""`classify` workload: batch inference over a directory of fast5/pod5 files.

Counterpart of ``deepbinner_tpu/cli/classify.py``.  The TSV goes to stdout
(read_ID, barcode_call, and the per-class probabilities with --verbose),
progress to stderr, in the same format as the JAX CLI, so a plain table is
byte-identical to the JAX package's for the same reads and weights.  A
model is a `.dbt` file or a Keras HDF5 file, as the JAX CLI takes them.

Files are decoded and batches built in reader worker processes on the card
(``--reader_processes``, the JAX CLI's default on an accelerator) or in
reader threads on the CPU.  Each batch is split over the process's devices
(``--device_count``; 0 = all its cards).  Under a process group of several
ranks (:mod:`deepbinner_tpu_torch.parallel.dist`) each rank classifies its
shard of the sorted file list, the tables are gathered, and only rank 0
prints the merged table, byte-identical to a single process's.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
from typing import List, Tuple

import numpy as np

from deepbinner_tpu_torch import resolve_device
from deepbinner_tpu_torch.utils import table
from deepbinner_tpu_torch.utils.fast5 import find_signal_files
from deepbinner_tpu_torch.utils.log import Progress, log, quit_with_error, section


def _resolve_inputs(path: str) -> List[str]:
    if os.path.isdir(path):
        files = find_signal_files(path)
        if not files:
            quit_with_error(f"no fast5/pod5 files found in {path}")
        return files
    if os.path.isfile(path) and path.endswith((".fast5", ".pod5")):
        return [path]
    quit_with_error(
        f"{path} is neither a signal-file directory nor a fast5/pod5 file"
    )


def build_program(args):
    """Load model(s) and build the classify program from CLI args.

    A model is a `.dbt` file or a Keras HDF5 file (``load_model`` tells them
    apart); ``--pallas`` applies to `.dbt` models only.  Returns
    (ClassifyProgram, the model's NetworkConfig or KerasModelConfig).
    """
    from deepbinner_tpu_torch.models.checkpoint import load_model
    from deepbinner_tpu_torch.models.network import NetworkConfig
    from deepbinner_tpu_torch.ops.calling import CallingConfig
    from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
    from deepbinner_tpu_torch.runner.pipeline import ClassifyConfig, ClassifyProgram

    try:
        device = resolve_device(getattr(args, "device", "cuda"))
    except RuntimeError as exc:  # --device cuda without a card
        quit_with_error(str(exc))
    section("Loading models")
    model, net_cfg, meta = load_model(args.start_model)
    log(f"  start model: {args.start_model} "
        f"(input {net_cfg.input_length}, kit {meta.get('kit', '?')})")
    end_model = None
    if args.end_model:
        end_model, end_cfg, end_meta = load_model(args.end_model)
        if end_cfg != net_cfg:
            quit_with_error("start and end models have different architectures")
        log(f"  end model:   {args.end_model} (kit {end_meta.get('kit', '?')})")

    window = net_cfg.input_length
    scan_size = args.scan_size
    stride = max(window // 2, 1)
    if (scan_size - window) % stride != 0:
        # Round scan size up so the window grid tiles it exactly.
        scan_size = window + ((scan_size - window + stride - 1) // stride) * stride
        log(f"  scan size rounded to {scan_size} (window {window}, stride {stride})")
    host_trim = not bool(getattr(args, "device_trim", False))
    # Wire default: int8 under host trim (quantisation runs after the trim,
    # on the host), int16 with --device_trim.
    wire = getattr(args, "wire", None)
    if wire is None:
        wire = "int8" if host_trim else "int16"
    elif wire in ("int8", "int4") and not host_trim:
        quit_with_error(f"--wire {wire} requires host-side trim "
                        "(drop --device_trim)")
    pre = PreprocessConfig(
        scan_size=scan_size,
        window=window,
        stride=stride,
        trim_scan=min(2048, scan_size),
        host_trim=host_trim,
        wire=wire,
    )
    calling = CallingConfig(
        min_score=args.min_score,
        score_diff=args.score_diff,
        require_both=bool(getattr(args, "require_both", False)),
        combine=getattr(args, "combine", "neighbour"),
    )
    use_pallas = bool(getattr(args, "pallas", False))
    if use_pallas and not isinstance(net_cfg, NetworkConfig):
        log("  --pallas only supports native .dbt models; using the graph "
            "path for this imported Keras graph")
        use_pallas = False
    cfg = ClassifyConfig(preprocess=pre, calling=calling,
                         dual_model=end_model is not None,
                         kernel_path="fused" if use_pallas else "unit")
    program = ClassifyProgram(model, cfg, end_model=end_model,
                              devices=_data_parallel_devices(args, device))
    log(f"  device: {program.device}")
    return program, net_cfg


def _data_parallel_devices(args, device) -> list:
    """This process's devices for the run, as the JAX CLI picks them:
    ``--device_count`` of them (0 = all; more than the process has is an
    error), dropped to the largest count that divides the batch size."""
    from deepbinner_tpu_torch.parallel import mesh

    requested = int(getattr(args, "device_count", 0) or 0)
    try:
        devices = mesh.local_devices(device.type, requested)
    except ValueError as exc:
        quit_with_error(f"--device_count {requested}: {exc}")
    use = len(devices)
    while use > 1 and args.batch_size % use:
        use -= 1
    if use > 1:
        log(f"  data-parallel over {use} device(s)")
    return devices[:use]


def result_to_row(result, verbose: bool, dual: bool) -> str:
    call = table.class_index_to_call(result.call)
    if not verbose:
        return table.format_row(result.read_id, call)
    scores: List[float] = list(np.asarray(result.start_probs, dtype=np.float64))
    extra: List[str] = []
    if dual:
        extra = [
            table.class_index_to_call(result.start_call),
            table.class_index_to_call(result.end_call),
        ]
        scores += list(np.asarray(result.end_probs, dtype=np.float64))
    parts = [result.read_id, call] + extra + [f"{s:.4f}" for s in scores]
    return "\t".join(parts)


class StreamRunner:
    """One classify run's streaming machinery, reusable across work shards.

    Owns either a persistent reader worker pool (the default on the card:
    workers decode files and build batches, which go to the card straight
    from pinned shared-memory slots) or the in-process reader threads (the
    default on the CPU: no spawn or import cost).  `classify(files)`
    streams ReadResults for any subset of files, so the resumable shard
    loop reuses the program AND the pool.  `close()` stops the pool.
    """

    def __init__(self, program, args, stats) -> None:
        self.program = program
        self.args = args
        self.stats = stats
        self.pool = None
        reader_processes = int(getattr(args, "reader_processes", -1))
        if reader_processes < 0:
            # Auto: scale decode with the host but leave cores for the
            # feeder and the classify thread; in-process on the CPU.
            reader_processes = (0 if program.device.type == "cpu"
                                else max(2, min(8, (os.cpu_count() or 2) - 2)))
        if reader_processes > 0:
            from deepbinner_tpu_torch.runner.executor import (
                MIN_SHM_SLOTS,
                batch_spec_for,
            )
            from deepbinner_tpu_torch.runner.mp_reader import ReaderPool

            log(f"  {reader_processes} reader worker process(es), "
                f"worker-side batch assembly"
                + ("" if not program.cfg.preprocess.host_trim
                   else " + host-side trim"))
            spec = batch_spec_for(program.cfg.preprocess, args.batch_size,
                                  program.cfg.dual_model)
            # The zero-copy path holds a slot for every batch in the
            # classify pipeline's in-flight window, so fewer slots than the
            # window would stall the writers: clamp up, loudly.
            shm_slots = int(getattr(args, "shm_slots", MIN_SHM_SLOTS + 2))
            if 0 < shm_slots < MIN_SHM_SLOTS:
                log(f"  --shm_slots {shm_slots} is below the classify "
                    f"pipeline's in-flight window; using {MIN_SHM_SLOTS}")
                shm_slots = MIN_SHM_SLOTS
            self.pool = ReaderPool(
                num_workers=reader_processes, batch_spec=spec,
                use_native=not getattr(args, "no_native_reader", False),
                shm_slots=shm_slots,
                pin_memory=program.device.type == "cuda",
            )
            if self.pool.use_native:
                log("  using native C++ fast5 reader")
        else:
            self.read_fn = _select_read_fn(args)

    def classify(self, files):
        from deepbinner_tpu_torch.runner.executor import (
            classify_batches,
            classify_files,
        )

        if self.pool is not None:
            # copy=False: each batch stays in its slot until its upload is
            # done, and goes to the card from there.
            return classify_batches(
                self.program, self.pool.iter_batches(files, self.stats,
                                                     copy=False),
                stats=self.stats,
            )
        return classify_files(
            self.program, files, batch_size=self.args.batch_size,
            num_readers=self.args.num_readers, stats=self.stats,
            read_fn=self.read_fn,
        )

    def close(self) -> None:
        if self.pool is not None:
            self.pool.close()


def _select_read_fn(args):
    """The in-process readers' ReadFn: the native C++ fast5 reader where it
    can be built (unless ``--no_native_reader``), else h5py; pod5 always
    through the pod5 parser."""
    from deepbinner_tpu_torch.native import build, fast5_reader
    from deepbinner_tpu_torch.runner.executor import _default_read_fn

    if getattr(args, "no_native_reader", False):
        return _default_read_fn
    if fast5_reader.available():
        log("  using native C++ fast5 reader")

        def dispatch(path: str):
            if path.endswith(".pod5"):
                return _default_read_fn(path)
            return fast5_reader.read_file(path)

        return dispatch
    if getattr(args, "native_reader", False):
        log(f"  native reader cannot be built here "
            f"({build.missing('fast5_reader')}); reading through h5py")
    return _default_read_fn


def _run_fingerprint(args, program) -> str:
    """Identity of everything that determines a shard's calls: the model
    files' bytes and the full classify config."""
    hasher = hashlib.sha256()
    for path in [args.start_model, getattr(args, "end_model", None)]:
        if path:
            with open(path, "rb") as handle:
                hasher.update(hashlib.sha256(handle.read()).digest())
    hasher.update(repr(program.cfg).encode())
    return hasher.hexdigest()


def _classify_resumable(
    runner: StreamRunner,
    files: List[str],
    shard_dir: str,
    shard_files: int,
    progress: Progress,
    fingerprint: str,
) -> Tuple[List[Tuple[str, str]], int]:
    """Classify in work shards with atomic per-shard TSVs + skip-on-rerun.

    Shard k = sorted(files)[k*N:(k+1)*N].  A manifest pins the input set,
    the model weights and the calling config, so stale shard tables never
    leak into another run's output.  Finished shards are loaded, not
    reclassified; a shard's unreadable files are recorded beside it and
    retried on the next run.  Returns (rows, resumed_read_count).
    """
    from deepbinner_tpu_torch.parallel import dist

    host = dist.process_index()
    ordered = sorted(files)
    digest = hashlib.sha256("\n".join(ordered).encode()).hexdigest()
    os.makedirs(shard_dir, exist_ok=True)
    manifest_path = os.path.join(shard_dir, f"manifest_h{host:04d}.json")
    manifest = {"input_sha256": digest, "shard_files": shard_files,
                "n_files": len(ordered), "run_fingerprint": fingerprint,
                "process_count": dist.process_count()}
    if os.path.exists(manifest_path):
        with open(manifest_path) as handle:
            found = json.load(handle)
        if found != manifest:
            quit_with_error(
                f"{shard_dir} holds shards for a different input set, model, "
                f"or config ({found} != {manifest}); use a fresh --shard_dir"
            )
    else:
        table.write_rows_atomic(manifest_path, [json.dumps(manifest)])

    def classify_chunk(chunk: List[str]) -> Tuple[List[Tuple[str, str]], List[str]]:
        """Classify files; returns (rows, paths that failed this attempt)."""
        failed_before = len(runner.stats.failed_paths)
        chunk_rows = []
        for result in runner.classify(chunk):
            chunk_rows.append(
                (result.read_id, table.class_index_to_call(result.call))
            )
            progress.update()
        return chunk_rows, runner.stats.failed_paths[failed_before:]

    def write_shard(shard_path: str, shard_rows, failed: List[str]) -> None:
        shard_rows = sorted(shard_rows)
        table.write_rows_atomic(
            shard_path, (table.format_row(r, c) for r, c in shard_rows)
        )
        sidecar = shard_path + ".failed"
        if failed:
            table.write_rows_atomic(sidecar, sorted(set(failed)))
        elif os.path.exists(sidecar):
            os.unlink(sidecar)

    rows: List[Tuple[str, str]] = []
    resumed_reads = 0
    resumed_files = 0
    for k in range(0, len(ordered), shard_files):
        chunk = ordered[k : k + shard_files]
        shard_path = os.path.join(
            shard_dir, f"shard_h{host:04d}_{k // shard_files:06d}.tsv"
        )
        sidecar = shard_path + ".failed"
        if os.path.exists(shard_path):
            parsed = list(table.parse_classification_file(shard_path).items())
            if os.path.exists(sidecar):
                with open(sidecar) as handle:
                    previously_failed = [l.strip() for l in handle if l.strip()]
                log(f"  retrying {len(previously_failed)} previously "
                    f"unreadable file(s) in {os.path.basename(shard_path)}")
                retry_rows, still_failed = classify_chunk(previously_failed)
                merged = sorted(set(parsed) | set(retry_rows))
                write_shard(shard_path, merged, still_failed)
                rows.extend(merged)
            else:
                rows.extend(parsed)
            resumed_reads += len(parsed)
            resumed_files += len(chunk)
            continue
        shard_rows, failed = classify_chunk(chunk)
        write_shard(shard_path, shard_rows, failed)
        rows.extend(sorted(shard_rows))
    if resumed_files:
        log(f"  resumed: {resumed_files} file(s) / {resumed_reads} read(s) "
            f"already classified in {shard_dir}")
    return rows, resumed_reads


def _profiled(profile_dir, device):
    """``torch.profiler`` over the run inside when ``profile_dir`` is set
    (the host ops, and the card's kernels and copies where the device is the
    card); the trace is written into ``profile_dir`` as Chrome JSON
    (``<host>_<pid>.<ms>.pt.trace.json``) when the run ends."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    log(f"  writing a torch.profiler trace to {profile_dir}")
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def classify_fast5_files(args) -> None:
    from deepbinner_tpu_torch.parallel import dist
    from deepbinner_tpu_torch.runner.executor import ExecutorStats

    files = _resolve_inputs(args.input)
    shard = dist.shard_files(files)
    section(f"Classifying {len(files)} fast5 file(s)"
            + (f" (this host: {len(shard)})" if len(shard) != len(files) else ""))

    shard_dir = getattr(args, "shard_dir", None)
    if shard_dir and args.verbose:
        quit_with_error("--shard_dir stores plain call tables; it cannot be "
                        "combined with --verbose")

    program, _ = build_program(args)
    dual = program.cfg.dual_model
    stats = ExecutorStats()
    progress = Progress("reads classified")
    rows: List[Tuple[str, str]] = []
    verbose_rows: List[str] = []

    runner = StreamRunner(program, args, stats)
    resumed_reads = 0
    try:
        with _profiled(getattr(args, "profile_dir", None), program.device):
            if shard_dir:
                rows, resumed_reads = _classify_resumable(
                    runner, shard, shard_dir,
                    int(getattr(args, "shard_files", 0) or 256), progress,
                    _run_fingerprint(args, program),
                )
            else:
                for result in runner.classify(shard):
                    rows.append((result.read_id,
                                 table.class_index_to_call(result.call)))
                    if args.verbose:
                        verbose_rows.append(result_to_row(result, True, dual))
                    progress.update()
    finally:
        runner.close()
    elapsed = progress.finish()
    if stats.failed_files:
        sample = ", ".join(os.path.basename(p) for p in stats.failed_paths[:3])
        errors = [e for e in stats.failed_errors if e]
        log(f"  skipped {stats.failed_files} unreadable file(s) "
            f"(e.g. {sample}"
            + (f"; first error: {errors[0]}" if errors else "") + ")")
        # Every input failing is a format/environment problem: an empty
        # table would silently discard the dataset.
        if stats.reads == 0 and resumed_reads == 0 and shard:
            quit_with_error(
                f"all {stats.failed_files} input file(s) were unreadable; "
                f"refusing to emit an empty classification table"
            )
    log(f"  throughput: {stats.reads / max(elapsed, 1e-9):.1f} reads/s "
        f"(this host; {stats.reads} classified in {stats.batches} batch(es)"
        + (f" + {resumed_reads} resumed" if resumed_reads else "") + ")")

    # Verbose rows are gathered and sorted like the plain table, so both
    # are the same at every process count.
    if args.verbose:
        merged_lines = dist.merge_lines(verbose_rows)
        if dist.should_emit_table():
            print(table.header_line(True, dual))
            for row in merged_lines:
                print(row)
    else:
        merged = dist.merge_call_tables(rows)
        if dist.should_emit_table():
            print(table.header_line(False, dual))
            for read_id, call in merged:
                print(table.format_row(read_id, call))
    sys.stdout.flush()
