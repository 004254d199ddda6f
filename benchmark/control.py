"""The control of a cell's comparison, on the card: the plain reference in
the program's place, computed one precision below the configuration's.

The configurations are float32 with TF32 off, so the control is the
reference with TF32 on for cuDNN and cuBLAS.  For each seed it makes the
cell's corpus (not written to disk: the control reads the signals), works
every read out in float32 (the truth) and with TF32 (the control) and in
float32 once more (the reference against itself), and judges the two
latter as a run's rows are judged.  The control has to fail the cell's
limits; the benchmark's runs never run it.

    python3 benchmark/control.py --workload nbd103-amplicon --seeds 1 2 3
"""

import argparse
import json
import os
import sys
import time


def readings(cell, seed: int, device: str = "cuda", reads=None) -> dict:
    """The control's and the reference's own numbers for one seed."""
    import numpy as np

    from benchmark import compare, corpus, harness
    from benchmark.references import demuxnet

    config = cell.config
    traffic = dict(cell.traffic, **({"reads": reads} if reads else {}))
    truth = demuxnet.Reference(config, harness.ROOT, device)
    data = corpus.generate(traffic, config["kit"], seed, "",
                           truth.geometry.raw_size, write=False,
                           workers=min(8, os.cpu_count() or 1))
    ends = truth.window_probs(data.heads, data.tails, data.lengths)
    expected = compare.Expected(ends, config["classify"])
    out = {"seed": seed, "reads": data.reads}
    for name, tf32 in (("control_tf32", True), ("reference_again", False)):
        other = demuxnet.Reference(config, harness.ROOT, device, tf32=tf32)
        rows = [[compare.decide(p, m, config["classify"]) for p, m in zip(*end)]
                for end in other.window_probs(data.heads, data.tails,
                                              data.lengths)]
        calls = [r[1] for r in rows[0]]
        if len(rows) == 2:
            calls = [compare.reconcile(s, e, config["classify"]["require_both"])
                     for s, e in zip(calls, (r[1] for r in rows[1]))]
        start = np.stack([r[0] for r in rows[0]])
        end = (np.stack([r[0] for r in rows[1]]) if len(rows) == 2
               else np.zeros_like(start))
        out[name] = expected.judge(np.arange(data.reads), np.array(calls),
                                   start, end)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        start = time.perf_counter()
        line = readings(cell, seed)
        line.update(workload=cell.name, seconds=time.perf_counter() - start,
                    limit=cell.config["limits"]["prob_gap"])
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
