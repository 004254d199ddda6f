"""Shared pieces of the benchmark's CPU tests: a cell cut to a size the CPU
can run (the repository's tiny trained model, short reads, a few files)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = "deepbinner_tpu/models/data/TINY_dryrun.dbt"
CPU_ARGS = ("--device", "cpu", "--reader_processes", "2")


def small_cell(name: str, reads: int = 48, per_file: int = 8):
    """Cell ``name`` of BENCHMARK.json on the tiny model (input 256, scan
    768, batch 16) and ``reads`` short reads."""
    from benchmark import harness

    cell = harness.load_cell(name)
    config = copy.deepcopy(cell.config)
    config["start_model"] = TINY
    if config.get("end_model"):
        config["end_model"] = TINY
    config["network"] = {"input_length": 256, "stem_features": 8}
    config["classify"] = dict(config["classify"], scan_size=768, batch_size=16)
    traffic = dict(cell.traffic, reads=reads, reads_per_file=per_file)
    traffic["genomic_bases"] = dict(traffic["genomic_bases"], median=600,
                                    min=300, max=3000)
    cell.config, cell.traffic = config, traffic
    return cell


@pytest.fixture
def run_small():
    """Run a small cell on the CPU through ``benchmark/classify.py``; every
    child process is stopped afterwards."""
    import time

    from benchmark import classify, harness

    def run(name="nbd103-amplicon", seed=2 ** 31 + 5, seconds=1.0, trace=False):
        cell = small_cell(name)
        try:
            return classify.run(
                cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                extra_args=CPU_ARGS, corpus_workers=1)
        finally:
            harness.stop_children()

    return run
