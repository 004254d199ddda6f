"""The harness: cells, configurations, traffic and metric readers found by
name; no JAX in a run; no result without a card; the result's shape."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from conftest import CPU_ARGS, ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as handle:
        return json.load(handle)


def test_every_name_in_benchmark_json_has_its_file():
    from benchmark import harness

    bench = _bench()
    for entry in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, entry["file"]))
    for cell in bench["workloads"]:
        loaded = harness.load_cell(cell["name"])
        assert loaded.chips == 1
        assert {m["name"] for m in loaded.end_to_end} >= {"reads_per_s", "setup_s"}
        assert loaded.per_layer
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(metric["name"]).read)
        assert metric["moves"] in {m["name"] for m in bench["end_to_end"]} \
            if "moves" in metric else True


@pytest.mark.parametrize("kind,name", [("workload", "no-such-cell"),
                                       ("metric", "no_such_metric")])
def test_unknown_names_are_refused(kind, name):
    from benchmark import harness

    with pytest.raises(LookupError):
        if kind == "workload":
            harness.load_cell(name)
        else:
            harness.reader(name)


def test_unknown_configuration_and_traffic_are_refused(tmp_path):
    from benchmark import harness

    bench = _bench()
    bench["workloads"].append({"name": "x", "config": "nope", "traffic": "amplicon",
                               "chips": 1, "why": "-"})
    bench["workloads"].append({"name": "y", "config": "nbd103-dual",
                               "traffic": "nope", "chips": 1, "why": "-"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell in ("x", "y"):
        with pytest.raises(LookupError):
            harness.load_cell(cell, str(tmp_path))


def test_forbidden_modules_compare_whole_top_level_names():
    from benchmark import harness

    assert harness.forbidden_modules(["deepbinner_tpu_torch", "jaxtyping",
                                      "flaxen.x", "numpy"]) == []
    assert harness.forbidden_modules(["deepbinner_tpu.cli", "jax._src",
                                      "jaxlib", "flax.linen"]) == [
        "deepbinner_tpu", "flax", "jax", "jaxlib"]


def test_no_result_without_a_card():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "rbk004-amplicon",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not proc.stdout.strip()


def test_a_cpu_run_loads_no_jax_and_reports_no_device_metric(tmp_path):
    """A whole run of a small cell in a fresh process, at --seconds 1."""
    script = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{ROOT!r}, {os.path.join(ROOT, 'benchmark', 'tests')!r}]
        from conftest import small_cell
        from benchmark import classify, harness
        if __name__ == "__main__":
            cell = small_cell("nbd103-genomic")
            try:
                out = classify.run(
                    cell, 2 ** 31 + 77, 1.0, False, time.perf_counter(),
                    device="cpu", extra_args={list(CPU_ARGS)!r},
                    corpus_workers=1)
            finally:
                harness.stop_children()
            print(json.dumps({{"correct": out["correct"],
                              "device": out["device"],
                              "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
    """)
    path = tmp_path / "cpu_run.py"
    path.write_text(script)
    proc = subprocess.run([sys.executable, str(path)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "cpu"
    assert not {"jax", "jaxlib", "flax", "deepbinner_tpu"} & set(result["modules"])
    assert "deepbinner_tpu_torch" in result["modules"]


def test_readers_of_a_record():
    from benchmark import flops, harness
    from benchmark.trace import Trace

    network = {"input_length": 1024, "stem_features": 48, "block_features": [64, 96],
               "inception_features": [128, 128], "head_features": 128,
               "num_classes": 13}
    units = flops.units(network, 2816)
    kernels = [(1000.0 * k, 1000.0 * k + 500.0, "void conv1d_bn_relu_kernel<32, 4>")
               for k in range(15)]
    trace = Trace(kernels + [(20000.0, 20100.0, "Memcpy HtoD")],
                  [(0.0, 30000.0, "bench/call")])
    untraced = harness.Untraced(seconds=20.0, pool_wait_s=8.0,
                                recording=None, batches=[])
    record = harness.Record(seconds=10.0, setup_s=12.5, rows=50_000,
                            pool_wait_s=4.0, windows_per_read=11, ends=2,
                            network=network, trace=trace, trace_window_s=0.05,
                            k1_launches=units, step_batches=[256, 256],
                            untraced=untraced, pool_reads_per_s=61234.5)
    read = {name: harness.reader(name).read(record) for name in
            ("reads_per_s", "setup_s", "reader_wait_share", "step_mfu",
             "k1_roofline", "device_idle_share", "pool_reads_per_s")}
    assert read["reads_per_s"] == 5000.0 and read["setup_s"] == 12.5
    assert read["reader_wait_share"] == pytest.approx(40.0)
    assert read["pool_reads_per_s"] == 61234.5
    assert read["step_mfu"] == pytest.approx(
        100 * 512 * 22 * flops.forward_flops_per_window(network) / 7600e-6 / 67e12)
    assert read["k1_roofline"] == pytest.approx(
        100 * sum(u.bound_s for u in units) / (15 * 500e-6))
    assert read["device_idle_share"] == pytest.approx(100 * (1 - 7600e-6 / 0.05))
    # A launch the trace does not hold, or no trace: nothing to read.
    record.k1_launches = units[:-1]
    assert harness.reader("k1_roofline").read(record) is None
    # The whole step's share does not need K1 on the path.
    record.k1_launches = []
    assert harness.reader("step_mfu").read(record) is not None
    record.trace = None
    assert harness.reader("step_mfu").read(record) is None
    assert harness.reader("device_idle_share").read(record) is None
    assert harness.reader("k1_roofline").read(record) is None
    # No untraced stretch, no pool-only pass: nothing.
    record.untraced = record.pool_reads_per_s = None
    assert harness.reader("reader_wait_share").read(record) is None
    assert harness.reader("pool_reads_per_s").read(record) is None


def test_idle_gaps_are_named_by_the_open_annotations():
    from benchmark.trace import Trace

    trace = Trace([(0, 10, "a"), (20, 30, "b"), (25, 40, "a"), (50, 55, "c")],
                  [(12, 18, "bench/drain"), (41, 60, "bench/pool_wait"),
                   (0, 100, "bench/call")])
    assert trace.busy_us() == 35
    assert dict(trace.idle_gaps()) == pytest.approx(
        {"bench/call+bench/drain": 10e-6, "bench/call+bench/pool_wait": 10e-6})
    assert trace.top_device_ops()[0] == ["a", pytest.approx(25e-6)]
