"""What every cell shares: finding a cell's files by name, the metric
readers, the checks on the result line, and the end of a run.

``BENCHMARK.json`` at the root names each cell's configuration and traffic
mix; ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py`` (one reader per metric, end-to-end or per-layer)
are found by those names, so a later cell, mix or metric comes as new
files and new entries.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# Top-level modules no run may hold: the JAX package is the reference the
# port's tests use, never part of what is measured.
FORBIDDEN = ("jax", "jaxlib", "flax", "deepbinner_tpu")


def forbidden_modules(modules: Optional[Sequence[str]] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    each compared whole: ``deepbinner_tpu_torch`` is not ``deepbinner_tpu``."""
    names = {name.split(".")[0] for name in (sys.modules if modules is None
                                             else modules)}
    return sorted(names.intersection(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]  # BENCHMARK.json's metric entries this cell reports
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: str, what: str) -> dict:
    if not os.path.isfile(path):
        raise LookupError(f"no {what} file {os.path.relpath(path, ROOT)}")
    with open(path) as handle:
        return json.load(handle)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its
    configuration and traffic mix read from their files."""
    bench = _json(os.path.join(root, "BENCHMARK.json"), "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise LookupError(f"no workload {name!r} in BENCHMARK.json; "
                          f"known: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if entry["config"] not in configs:
        raise LookupError(f"no configuration {entry['config']!r}")
    config = _json(os.path.join(root, configs[entry["config"]]["file"]),
                   "configuration")
    traffic = _json(os.path.join(root, "benchmark", "traffic",
                                 entry["traffic"] + ".json"), "traffic")
    return Cell(name, entry["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str) -> ModuleType:
    """``metrics/<metric>.py``: ``read(record) -> float or None``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    if not os.path.isfile(path):
        raise LookupError(f"no metric file benchmark/metrics/{metric}.py")
    module_name = f"benchmark.metrics.{metric.replace('.', '_')}"
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def read_metrics(entries: List[dict], record) -> Dict[str, dict]:
    """Each metric's reader applied to ``record``; a reader that finds
    nothing to read leaves its metric out."""
    out = {}
    for entry in entries:
        value = reader(entry["name"]).read(record)
        if value is not None:
            out[entry["name"]] = {"value": value, "unit": entry["unit"]}
    return out


def host_cpus() -> Dict[str, object]:
    """The host's CPU model, its logical CPUs, and the CPUs this process
    may run on.  The model is ``/proc/cpuinfo``'s first ``model name``;
    where that is missing or ``unknown`` (as some virtualised kernels give
    it), its vendor, family, model and stepping, or ``unknown``."""
    fields: Dict[str, str] = {}
    try:
        with open("/proc/cpuinfo") as handle:
            for line in handle:
                if not line.strip():
                    break  # the first processor's block only
                key, _sep, value = line.partition(":")
                if value.strip() not in ("", "unknown"):
                    fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    model = fields.get("model name") or " ".join(
        f"{key} {fields[key]}" for key in ("vendor_id", "cpu family", "model",
                                           "stepping") if fields.get(key))
    return {"cpu_model": model or "unknown", "cpu_count": os.cpu_count(),
            "cpu_affinity": len(os.sched_getaffinity(0))}


def check_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]


def stop_children() -> None:
    """End every child process still running and multiprocessing's
    resource tracker, and wait for each."""
    import multiprocessing
    from multiprocessing import resource_tracker

    children = multiprocessing.active_children()
    for child in children:
        child.terminate()
    for child in children:
        child.join(timeout=5)
        if child.is_alive():
            child.kill()
            child.join()
    # The pool's queues and locks unregister from the tracker when they
    # are collected; stopping it first would have it unlink them as leaks.
    gc.collect()
    tracker = resource_tracker._resource_tracker  # noqa: SLF001 — no public stop
    if getattr(tracker, "_pid", None) is not None:
        tracker._stop()  # noqa: SLF001 — closes its pipe, waits for it


@dataclasses.dataclass
class Untraced:
    """The untraced stretch of a ``--trace 1`` run: from the window's start
    to just before the profiler opens, with the program's recorder on and
    no profiler.

    ``seconds`` is its length and ``pool_wait_s`` the part of it the stream
    spent blocked on the reader pool's batch iterator, both on the
    harness's clock; ``recording`` is the program's recording of it (a
    ``deepbinner_tpu_torch.runner.spans.Recording``), and ``batches`` the
    reads of each batch the program was called on in it, as the harness
    saw them.
    """

    seconds: float
    pool_wait_s: float
    recording: Optional[object]
    batches: list


@dataclasses.dataclass
class Record:
    """What a run saw, for the metric readers (``metrics/*.py``).

    ``seconds`` is the measured window and ``rows`` the call rows produced
    in it; ``pool_wait_s`` the part of the window the stream spent blocked
    on the reader pool's batch iterator.  ``trace`` (a
    :class:`benchmark.trace.Trace`) covers the traced part of a
    ``--trace 1`` run, ``trace_window_s`` long; ``k1_launches`` holds the
    :class:`benchmark.flops.Unit` of each K1 launch made in it, in order,
    and ``step_batches`` the reads of each batch the program was called on
    in it.  ``untraced`` (an :class:`Untraced`) is the stretch of a
    ``--trace 1`` run before the traced part, and ``pool_reads_per_s`` the
    reader pool's own rate, from the pool-only pass after the window.
    """

    seconds: float
    setup_s: float
    rows: int
    pool_wait_s: Optional[float]
    windows_per_read: int
    ends: int
    network: dict
    trace: Optional[object] = None
    trace_window_s: Optional[float] = None
    k1_launches: Optional[list] = None
    step_batches: Optional[list] = None
    untraced: Optional[Untraced] = None
    pool_reads_per_s: Optional[float] = None
