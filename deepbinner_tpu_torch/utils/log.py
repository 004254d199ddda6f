"""Stderr logging & progress output.

Reference parity: ``deepbinner/misc.py`` colour/stderr printers plus each
workload's progress counters (SURVEY.md §5 metrics row).  The rebuild adds an
optional structured JSON-lines mode (``DEEPBINNER_TPU_LOG=json``) for
machine-readable observability, and per-host prefixes for multi-host runs.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict


def _use_colour() -> bool:
    return sys.stderr.isatty() and os.environ.get("TERM", "") != "dumb"


BOLD = "\033[1m" if _use_colour() else ""
DIM = "\033[2m" if _use_colour() else ""
RED = "\033[31m" if _use_colour() else ""
GREEN = "\033[32m" if _use_colour() else ""
END = "\033[0m" if _use_colour() else ""


def _json_mode() -> bool:
    return os.environ.get("DEEPBINNER_TPU_LOG", "") == "json"


def _host_prefix() -> str:
    rank = os.environ.get("DEEPBINNER_TPU_PROCESS_INDEX")
    if rank is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        rank = os.environ.get("RANK")  # one rank of a torch.distributed job
    return f"[host {rank}] " if rank is not None else ""


def log(message: str = "", end: str = "\n", **fields: Any) -> None:
    """Human-readable stderr message (or a JSON line in json mode)."""
    if _json_mode():
        record: Dict[str, Any] = {"ts": time.time(), "msg": message}
        record.update(fields)
        print(json.dumps(record), file=sys.stderr, flush=True)
    else:
        print(_host_prefix() + message, end=end, file=sys.stderr, flush=True)


def section(title: str) -> None:
    log(f"{BOLD}{title}{END}")


def error(message: str) -> None:
    log(f"{RED}Error: {message}{END}")


def quit_with_error(message: str) -> "NoReturn":  # noqa: F821 - typing.NoReturn
    """Print an error and exit(1).  Never returns — call it bare, no `raise`."""
    error(message)
    raise SystemExit(1)


class Progress:
    """Throttled progress counter printed to stderr.

    Mirrors the reference's running per-barcode tallies during classify, with
    a reads/s rate (the BASELINE.json metric) computed on the fly.
    """

    def __init__(self, label: str, interval_s: float = 2.0) -> None:
        self.label = label
        self.interval_s = interval_s
        self.count = 0
        self.start = time.monotonic()
        self._last_print = 0.0

    def update(self, n: int = 1, force: bool = False) -> None:
        self.count += n
        now = time.monotonic()
        if force or now - self._last_print >= self.interval_s:
            self._last_print = now
            rate = self.count / max(now - self.start, 1e-9)
            log(f"{self.label}: {self.count} ({rate:.1f}/s)", end="\r",
                count=self.count, rate=rate)

    def finish(self) -> float:
        """Print final tally; return elapsed seconds."""
        elapsed = time.monotonic() - self.start
        rate = self.count / max(elapsed, 1e-9)
        log(f"{self.label}: {self.count} done in {elapsed:.1f}s ({rate:.1f}/s)",
            count=self.count, elapsed=elapsed, rate=rate)
        return elapsed
