"""CLI dispatch for the port: the JAX package's argparse, routed to the port.

Counterpart of ``deepbinner_tpu/cli/main.py``.  ``get_arguments`` is a copy
of the JAX CLI's, so the same command lines parse the same way, with these
differences in `classify` and `realtime`:

- ``--device {cuda,cpu}`` (default ``cuda``) picks the device, where the
  JAX CLI goes by ``JAX_PLATFORMS``; without a card, ``cuda`` is an error;
- ``--reader_processes -1`` (the default) means reader worker processes on
  ``--device cuda`` and in-process reader threads on ``--device cpu``;
- ``--profile_dir DIR`` writes a ``torch.profiler`` trace (Chrome JSON)
  of the `classify` run into DIR, where the JAX CLI writes a
  ``jax.profiler`` trace; `realtime` takes the flag and ignores it, as the
  JAX CLI does;
- ``--pallas`` runs the trunk after stem1 as one launch of the CUDA
  megakernel per batch, as the JAX CLI's ``--pallas`` runs the Pallas
  megakernel; without it every unit is one launch of the unit kernel;
- ``--device_count`` counts this process's cards (on ``--device cpu``,
  entries of the CPU), as the JAX CLI counts its local devices.

In `train`, ``--device {cuda,cpu}`` (default ``cuda``) picks the device as
in `classify`, and ``--dp N`` above 1 starts N ranks of one data-parallel
run on this host, one per card (``train/trainer.py``).

A multi-process or multi-host job is launched with torch's own variables
(``torchrun`` sets them): ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` take the place of the
JAX CLI's ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
``JAX_PROCESS_ID``.  `classify`, `realtime` and `train` join the process
group before any workload (:func:`deepbinner_tpu_torch.parallel.dist.maybe_initialize`)
and leave it on every way out.

Every subcommand runs.  `simulate --container fast5` and `multifast5`
write through h5py and fail with its import error where it is missing;
`pod5` needs only pyarrow and the system zstd library.  `prep` reads fast5
only, as the JAX package's does.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from deepbinner_tpu_torch import __version__


def get_arguments(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="deepbinner-tpu-torch",
        description="Demultiplexing of nanopore reads from raw signal (PyTorch/CUDA port)",
    )
    parser.add_argument(
        "--version", action="version", version=f"deepbinner-tpu-torch {__version__}"
    )
    subparsers = parser.add_subparsers(dest="subparser_name", metavar="command")

    _add_classify_args(subparsers.add_parser(
        "classify", help="Classify fast5 reads into barcode bins (raw signal CNN)"))
    _add_bin_args(subparsers.add_parser(
        "bin", help="Bin basecalled reads into per-barcode FASTQ/FASTA files"))
    _add_realtime_args(subparsers.add_parser(
        "realtime", help="Watch a MinKNOW output directory and sort fast5s live"))
    _add_prep_args(subparsers.add_parser(
        "prep", help="Build labelled training samples from sequenced runs"))
    _add_balance_args(subparsers.add_parser(
        "balance", help="Balance class counts in prepared training data"))
    _add_train_args(subparsers.add_parser(
        "train", help="Train the barcode classifier network"))
    _add_simulate_args(subparsers.add_parser(
        "simulate", help="Generate a labelled synthetic squiggle dataset"))

    args = parser.parse_args(argv)
    if args.subparser_name is None:
        parser.print_help(sys.stderr)
        raise SystemExit(1)
    return args


def _add_model_args(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group("Models")
    group.add_argument("-s", "--start_model", required=True,
                       help="Model file for read starts (.dbt)")
    group.add_argument("-e", "--end_model",
                       help="Model file for read ends (EXP-NBD103 dual-model mode)")


def _add_classify_common(parser: argparse.ArgumentParser) -> None:
    # scan_size/score_diff/min_score defaults are the JAX CLI's.
    group = parser.add_argument_group("Classification")
    group.add_argument("--scan_size", type=int, default=6144,
                       help="Samples of each read end examined (default 6144)")
    group.add_argument("--score_diff", type=float, default=0.5,
                       help="Min margin between top two barcode scores (default 0.5)")
    group.add_argument("--min_score", type=float, default=0.5,
                       help="Min probability of the best barcode (default 0.5)")
    group.add_argument("--require_both", action="store_true",
                       help="Dual-model: both read ends must agree (default: either)")
    group.add_argument("--combine", default="neighbour",
                       choices=["neighbour", "best"],
                       help="Window-combine rule: neighbour-supported best "
                            "window (default) or the plain best window "
                            "(reference-parity testing)")
    group.add_argument("--batch_size", type=int, default=256,
                       help="Reads per device batch (default 256)")
    group.add_argument("--shard_dir",
                       help="Directory for atomic per-shard call tables; "
                            "re-runs skip finished shards (resume after an "
                            "interrupted run; merged output is byte-identical)")
    group.add_argument("--shard_files", type=int, default=256,
                       help="fast5 files per resumable shard (default 256)")
    group.add_argument("--verbose", action="store_true",
                       help="Include per-class probabilities in the output table")
    perf = parser.add_argument_group("Performance")
    perf.add_argument("--num_readers", type=int, default=4,
                      help="fast5/pod5 reader threads (default 4)")
    perf.add_argument("--reader_processes", type=int, default=-1,
                      help="fast5/pod5 reader worker processes (-1 = auto: "
                           "max(2, min(8, CPUs - 2)) on the card, in-process "
                           "threads on the CPU; 0 = in-process threads; >0 "
                           "scales past the single-libhdf5 lock)")
    perf.add_argument("--wire", default=None,
                      choices=["int16", "int8", "int4"],
                      help="host->device signal format. int8 (default): "
                           "the host z-scores each read end and quantises "
                           "at sigma/16, half the bytes of int16; the "
                           "per-window z-score on the device erases the "
                           "scale. int16: lossless raw DAC samples. int4: "
                           "sigma/3.5 nibbles packed 2/byte")
    perf.add_argument("--shm_slots", type=int, default=20,
                      help="shared-memory batch-transport slots between "
                           "reader workers and the classify process (0 = "
                           "pickled queue; default 20). The zero-copy path "
                           "holds a slot per in-flight batch, so fewer than "
                           "the pipeline window is clamped up; on the card "
                           "the slots are registered as pinned memory")
    perf.add_argument("--native_reader", action="store_true",
                      help="Use the C++ libhdf5 batch reader (default: auto "
                           "when it can be built)")
    perf.add_argument("--no_native_reader", action="store_true",
                      help="Force the h5py reader even if the native one "
                           "can be built")
    perf.add_argument("--pallas", action="store_true",
                      help="Run the conv trunk after stem1 as one launch of "
                           "the CUDA megakernel per batch (default: one "
                           "launch of the unit kernel per ConvBNReLU unit)")
    perf.add_argument("--device_trim", action="store_true",
                      help="Run open-pore trimming on the device instead "
                           "of on the host (same math)")
    perf.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                      help="Device to classify on (default cuda; cpu must "
                           "be asked for)")
    perf.add_argument("--device_count", type=int, default=0,
                      help="Limit devices used (0 = all local devices)")
    perf.add_argument("--profile_dir",
                      help="Write a torch.profiler trace (Chrome JSON) for "
                           "this run")
    # Reference-compat no-ops:
    perf.add_argument("--intra_op_parallelism_threads", type=int, default=12,
                      help=argparse.SUPPRESS)
    perf.add_argument("--inter_op_parallelism_threads", type=int, default=1,
                      help=argparse.SUPPRESS)
    perf.add_argument("--omp_num_threads", type=int, default=12,
                      help=argparse.SUPPRESS)


def _add_classify_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("input", help="fast5 directory (searched recursively) or one fast5")
    _add_model_args(parser)
    _add_classify_common(parser)


def _add_bin_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--classes", required=True,
                        help="Classification TSV from `classify` (or merged shards)")
    parser.add_argument("--reads", required=True,
                        help="Basecalled reads: FASTQ/FASTA, gzipped ok")
    parser.add_argument("--out_dir", required=True,
                        help="Output directory for per-barcode read files")


def _add_realtime_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--in_dir", required=True,
                        help="Directory to watch for new fast5s (MinKNOW output)")
    parser.add_argument("--out_dir", required=True,
                        help="Directory to move classified fast5s into")
    _add_model_args(parser)
    _add_classify_common(parser)
    parser.add_argument("--poll_interval", type=float, default=5.0,
                        help="Seconds between directory scans (default 5)")
    parser.add_argument("--stop_file",
                        help="Exit cleanly when this file appears (besides Ctrl-C)")
    parser.add_argument("--max_batches", type=int, default=0,
                        help="Stop after N batches (0 = run forever; for tests)")


def _add_prep_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("fast5_dir", help="Directory of raw fast5 files")
    parser.add_argument("--kit", required=True,
                        choices=["EXP-NBD103", "SQK-RBK004"])
    parser.add_argument("--end", default="start", choices=["start", "end"],
                        help="Which read end to extract signal for")
    parser.add_argument("--reads", required=True,
                        help="Basecalled reads FASTQ (for barcode location)")
    parser.add_argument("--out", required=True, help="Output training TSV")
    parser.add_argument("--signal_size", type=int, default=1600,
                        help="Stored samples per training row (> CNN input for "
                             "random-crop augmentation; default 1600)")
    parser.add_argument("--assignments",
                        help="TSV of read_id<TAB>barcode_call from an "
                             "external demultiplexer; restricts "
                             "localisation to each read's known barcode")
    parser.add_argument("--porechop",
                        help="Porechop barcode-bin output directory (-b): "
                             "BC01.fastq[.gz] … none.fastq[.gz]; parsed "
                             "into per-read barcode assignments")
    parser.add_argument("--synthetic_barcodes", action="store_true",
                        help="Localise the simulator's synthetic barcode "
                             "sequences instead of the real ONT kit "
                             "sequences (tests/simulated legacy data only)")
    parser.add_argument("--margin", type=int, default=200,
                        help="Signal margin around the barcode region (default 200)")


def _add_balance_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("training_data", nargs="+",
                        help="Training TSVs from `prep` (merged)")
    parser.add_argument("--out", required=True, help="Balanced output TSV")
    parser.add_argument("--none_fraction", type=float, default=0.1,
                        help="Fraction of class-0 samples in the output (default 0.1)")
    parser.add_argument("--seed", type=int, default=0)


def _add_train_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("training_data", help="Balanced training TSV")
    parser.add_argument("--out", required=True, help="Output model file (.dbt)")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--test_fraction", type=float, default=0.1,
                        help="Held-out validation fraction (default 0.1)")
    parser.add_argument("--aug_factor", type=int, default=2,
                        help="Augmented copies per sample per epoch (default 2)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resume", help="Checkpoint directory to resume from")
    parser.add_argument("--checkpoint_dir",
                        help="Directory for periodic training checkpoints")
    parser.add_argument("--size", default="full", choices=["full", "tiny"],
                        help="Network size preset (tiny = fast CI training)")
    parser.add_argument("--dp", type=int, default=0,
                        help="Data-parallel devices (0 = all local devices)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Device to train on (default cuda; cpu must be "
                             "asked for)")


def _add_simulate_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("out_dir", help="Output dataset directory")
    parser.add_argument("--kit", default="EXP-NBD103",
                        choices=["EXP-NBD103", "SQK-RBK004"])
    parser.add_argument("--reads_per_barcode", type=int, default=4)
    parser.add_argument("--none_reads", type=int, default=4)
    parser.add_argument("--genome_length", type=int, default=2000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--synthetic_barcodes", action="store_true",
                        help="Use seeded random barcode sequences instead "
                             "of the real ONT kit sequences")
    parser.add_argument("--container", default="fast5",
                        choices=["fast5", "multifast5", "pod5"],
                        help="signal container layout: one read per fast5 "
                             "(classic), multi-read fast5 (modern MinKNOW), "
                             "or pod5 (vbz-compressed; no move tables)")
    parser.add_argument("--reads_per_container", type=int, default=256,
                        help="reads per multifast5/pod5 container")


def main(argv: Optional[List[str]] = None) -> None:
    args = get_arguments(argv)
    name = args.subparser_name
    if name not in ("classify", "realtime", "train"):
        _run(name, args)
        return
    from deepbinner_tpu_torch.parallel import dist
    from deepbinner_tpu_torch.utils.log import quit_with_error

    # A rank of a multi-process job joins its process group before any
    # workload, as the JAX CLI initialises jax.distributed.
    try:
        dist.maybe_initialize(getattr(args, "device", "cuda"))
    except (RuntimeError, ValueError) as exc:
        quit_with_error(f"the process group did not come up: {exc}")
    ok = False
    try:
        _run(name, args)
        ok = True
    finally:
        dist.shutdown(ok)


def _run(name: str, args: argparse.Namespace) -> None:
    # Lazy imports: each workload pulls in only what it needs.
    if name == "classify":
        from deepbinner_tpu_torch.cli.classify import classify_fast5_files

        classify_fast5_files(args)
    elif name == "bin":
        from deepbinner_tpu_torch.cli.bin_reads import bin_reads

        bin_reads(args)
    elif name == "realtime":
        from deepbinner_tpu_torch.cli.realtime import realtime

        realtime(args)
    elif name == "prep":
        from deepbinner_tpu_torch.train.prep import prep

        prep(args)
    elif name == "balance":
        from deepbinner_tpu_torch.train.balance import balance

        balance(args)
    elif name == "train":
        from deepbinner_tpu_torch.train.trainer import train_from_args

        train_from_args(args)
    elif name == "simulate":
        from deepbinner_tpu_torch.utils.log import log
        from deepbinner_tpu_torch.utils.simulate import make_dataset

        truth = make_dataset(
            args.out_dir, kit=args.kit,
            reads_per_barcode=args.reads_per_barcode,
            none_reads=args.none_reads,
            genome_length=args.genome_length, seed=args.seed,
            synthetic=args.synthetic_barcodes,
            container=args.container,
            reads_per_container=args.reads_per_container,
        )
        log(f"wrote {len(truth)} simulated reads to {args.out_dir}")


if __name__ == "__main__":
    main()
