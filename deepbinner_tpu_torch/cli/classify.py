"""`classify` workload: batch inference over a directory of fast5/pod5 files.

Counterpart of ``deepbinner_tpu/cli/classify.py``.  The TSV goes to stdout
(read_ID, barcode_call, and the per-class probabilities with --verbose),
progress to stderr, in the same format as the JAX CLI, so a plain table is
byte-identical to the JAX package's for the same reads and weights.

One process on one device: the multi-host sharding and the reader worker
processes of the JAX package are not ported yet, so the shard manifest
always records process 0 of 1.
"""

from __future__ import annotations

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

    Returns (ClassifyProgram, NetworkConfig).
    """
    from deepbinner_tpu_torch.models.checkpoint import load_model
    from deepbinner_tpu_torch.ops.calling import CallingConfig
    from deepbinner_tpu_torch.ops.preprocess import PreprocessConfig
    from deepbinner_tpu_torch.runner.pipeline import ClassifyConfig, ClassifyProgram

    if int(getattr(args, "device_count", 0) or 0) > 1:
        quit_with_error("--device_count above 1 is not ported yet; the port "
                        "classifies on one device")
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
    cfg = ClassifyConfig(preprocess=pre, calling=calling,
                         dual_model=end_model is not None,
                         kernel_path="fused" if getattr(args, "pallas", False)
                         else "unit")
    program = ClassifyProgram(model, cfg, end_model=end_model, device=device)
    log(f"  device: {program.device}")
    return program, net_cfg


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

    Reads with in-process reader threads; `classify(files)` streams
    ReadResults for any subset of files, so the resumable shard loop
    reuses the program.
    """

    def __init__(self, program, args, stats) -> None:
        self.program = program
        self.args = args
        self.stats = stats

    def classify(self, files):
        from deepbinner_tpu_torch.runner.executor import classify_files

        return classify_files(
            self.program, files, batch_size=self.args.batch_size,
            num_readers=self.args.num_readers, stats=self.stats,
        )


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
    host = 0
    ordered = sorted(files)
    digest = hashlib.sha256("\n".join(ordered).encode()).hexdigest()
    os.makedirs(shard_dir, exist_ok=True)
    manifest_path = os.path.join(shard_dir, f"manifest_h{host:04d}.json")
    manifest = {"input_sha256": digest, "shard_files": shard_files,
                "n_files": len(ordered), "run_fingerprint": fingerprint,
                "process_count": 1}
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


def classify_fast5_files(args) -> None:
    from deepbinner_tpu_torch.runner.executor import ExecutorStats

    files = _resolve_inputs(args.input)
    section(f"Classifying {len(files)} fast5 file(s)")

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
    if shard_dir:
        rows, resumed_reads = _classify_resumable(
            runner, files, shard_dir,
            int(getattr(args, "shard_files", 0) or 256), progress,
            _run_fingerprint(args, program),
        )
    else:
        for result in runner.classify(files):
            rows.append((result.read_id, table.class_index_to_call(result.call)))
            if args.verbose:
                verbose_rows.append(result_to_row(result, True, dual))
            progress.update()
    elapsed = progress.finish()
    if stats.failed_files:
        sample = ", ".join(os.path.basename(p) for p in stats.failed_paths[:3])
        errors = [e for e in stats.failed_errors if e]
        log(f"  skipped {stats.failed_files} unreadable file(s) "
            f"(e.g. {sample}"
            + (f"; first error: {errors[0]}" if errors else "") + ")")
        # Every input failing is a format/environment problem: an empty
        # table would silently discard the dataset.
        if stats.reads == 0 and resumed_reads == 0 and files:
            quit_with_error(
                f"all {stats.failed_files} input file(s) were unreadable; "
                f"refusing to emit an empty classification table"
            )
    log(f"  throughput: {stats.reads / max(elapsed, 1e-9):.1f} reads/s "
        f"({stats.reads} classified"
        + (f" + {resumed_reads} resumed" if resumed_reads else "") + ")")

    if args.verbose:
        print(table.header_line(True, dual))
        for row in sorted(set(verbose_rows)):
            print(row)
    else:
        print(table.header_line(False, dual))
        for read_id, call in table.merge_shard_tables([rows]):
            print(table.format_row(read_id, call))
    sys.stdout.flush()
