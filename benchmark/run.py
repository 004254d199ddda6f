"""Run one cell of BENCHMARK.json once, on the card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the cell's comparison numbers beside their limits as the last lines
of standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` (with the host's CPU model, its logical CPUs and those this
process may use), with ``--trace 1`` ``breakdown``, ``k1_build_s`` (the
seconds of set-up that K1's nvcc build took, 0.0 where it was built
before), ``setup_phases`` (the seconds of each phase of set-up, which sum
to ``setup_s``), and ``checks`` last.  Exits non-zero and prints no
result where there is no card, fewer cards than the cell asks for, or a
module of JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402 — after T0
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    # Every build and kernel cache at a fixed path inside the checkout (the
    # port builds K1 into build/torch_kernels/ itself); no library may pull
    # in JAX behind the port's back.
    for name, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                      ("TRITON_CACHE_DIR", "triton")):
        os.environ[name] = os.path.join(root, "build", sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    from benchmark import classify, harness

    cell = harness.load_cell(args.workload, root)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; a run needs the card", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} card(s), "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    try:
        out = classify.run(cell, args.seed, args.seconds, bool(args.trace), T0)
    finally:
        harness.stop_children()
    found = sorted(set(out["forbidden"]) | set(harness.forbidden_modules()))
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    entries = cell.per_layer if args.trace else cell.end_to_end
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": harness.read_metrics(entries, out["record"]),
              "device": out["device"]}
    if args.trace and out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["k1_build_s"] = out["k1_build_s"]
    result["setup_phases"] = out["setup_phases"]
    result["checks"] = out["checks"]
    for line in harness.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
