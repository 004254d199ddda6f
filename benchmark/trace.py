"""What the benchmark reads from a ``torch.profiler`` Chrome trace.

Device activity is every event of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; the host's are the ``bench/*``
annotations ``classify.py`` puts around its calls into the stream's layers
(``record_function``, category ``user_annotation``), and the host spans
added to them: the harness's ``bench/pool_wait`` and the program's
``stream/*``.  Times in the trace are microseconds on one clock for the
host and the device.
"""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION_PREFIX = "bench/"


@dataclasses.dataclass
class Trace:
    device: List[Tuple[float, float, str]]   # (start µs, end µs, name)
    annotations: List[Tuple[float, float, str]]

    def add_host_spans(self, spans, clock: float, anchor: str) -> None:
        """Add ``(start, end, name)`` spans on ``time.perf_counter``'s clock
        as annotations; ``clock`` is the perf_counter reading taken inside
        the annotation ``anchor``."""
        marks = [(a + b) / 2 for a, b, n in self.annotations if n == anchor]
        if not marks:
            return
        offset = marks[0] - clock * 1e6
        self.annotations += [(start * 1e6 + offset, end * 1e6 + offset, name)
                             for start, end, name in spans]

    def kernels(self, fragment: str) -> List[Tuple[float, float, str]]:
        """Device kernels whose name holds ``fragment``, in start order."""
        return sorted(e for e in self.device if fragment in e[2])

    def busy_us(self) -> float:
        """Microseconds in which some operation ran on the device."""
        return sum(end - start for start, end in self._merged())

    def _merged(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for start, end, _name in sorted(self.device):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    def top_device_ops(self, count: int = 10) -> List[list]:
        totals: Dict[str, float] = collections.Counter()
        for start, end, name in self.device:
            totals[name[:160]] += (end - start) * 1e-6
        return [[name, seconds] for name, seconds in
                sorted(totals.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count: int = 10) -> List[list]:
        """Device idle time between operations, summed by what the host
        was inside at each gap's middle (the annotations and host spans
        open there, or ``host: other``)."""
        merged = self._merged()
        gaps = [(b_start, a_end) for (_s, a_end), (b_start, _e)
                in zip(merged, merged[1:])]
        # A sweep in time: at equal times an annotation opens before a
        # gap's middle is read and closes after.
        points = [(start, 0, name) for start, _end, name in self.annotations]
        points += [(end, 2, name) for _start, end, name in self.annotations]
        points += [(0.5 * (a_end + b_start), 1, k)
                   for k, (b_start, a_end) in enumerate(gaps)]
        open_: Dict[str, int] = collections.Counter()
        totals: Dict[str, float] = collections.Counter()
        for _time, kind, what in sorted(points, key=lambda p: (p[0], p[1])):
            if kind == 0:
                open_[what] += 1
            elif kind == 2:
                open_[what] -= 1
            else:
                b_start, a_end = gaps[what]
                label = "+".join(sorted(n for n, c in open_.items() if c > 0))
                totals[label or "host: other"] += (b_start - a_end) * 1e-6
        return [[name, seconds] for name, seconds in
                sorted(totals.items(), key=lambda kv: -kv[1])[:count]]


def load(path: str) -> Trace:
    with open(path) as handle:
        events = json.load(handle).get("traceEvents", [])
    device, annotations = [], []
    for event in events:
        if event.get("ph") != "X" or "dur" not in event:
            continue
        start = float(event["ts"])
        end = start + float(event["dur"])
        if event.get("cat") in DEVICE_CATEGORIES:
            device.append((start, end, event.get("name", "")))
        elif (event.get("cat") == "user_annotation"
              and event.get("name", "").startswith(ANNOTATION_PREFIX)):
            annotations.append((start, end, event["name"]))
    return Trace(device, annotations)


