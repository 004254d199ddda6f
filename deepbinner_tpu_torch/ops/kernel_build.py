"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each ``csrc/*.cu`` file has a plain C interface and is compiled on first
use, on the machine with the card, by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v
         -o build/torch_kernels/<name>-<hash>.so <name>.cu

The library name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale one is never loaded.  The build goes into
``build/torch_kernels/`` at the root of the checkout (``build/`` is ignored
by git).  A failed build raises; nothing falls back to another path.
``-Xptxas -v`` makes the one compile also report each kernel instance's
registers and spills (:data:`PTXAS`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
# Seconds each library took to build in this process (0.0 when it was
# already built on disk); read by chip_smoke.py's env phase.
BUILD_SECONDS: Dict[str, float] = {}
# Registers and spill bytes of each kernel instance (and the stack frame and
# spills of each device function ptxas compiled on its own), from the ptxas
# report of the build made in this process (empty when it was already on
# disk).
PTXAS: Dict[str, List[dict]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _demangle(names: List[str]) -> List[str]:
    """Readable kernel names (``c++filt`` where the machine has it)."""
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return names
    proc = subprocess.run([tool], input="\n".join(names), capture_output=True,
                          text=True)
    out = proc.stdout.splitlines()
    if proc.returncode != 0 or len(out) != len(names):
        return names
    return [re.sub(r"^void |\(anonymous namespace\)::", "", n).split("(")[0]
            for n in out]


def parse_ptxas(report: str) -> List[dict]:
    """Each entry function's registers and spill bytes from ``-Xptxas -v``,
    and each non-inlined device function's stack frame and spill bytes."""
    records: List[dict] = []
    by_name: Dict[str, dict] = {}
    current = entry = None
    for line in report.splitlines():
        found = (re.search(r"Compiling entry function '([^']+)'", line)
                 or re.search(r"Function properties for (\S+)", line))
        if found:
            name = found.group(1)
            if name not in by_name:
                by_name[name] = {"kernel": name}
                records.append(by_name[name])
            current = by_name[name]
            if "Compiling entry function" in line:
                entry = current
            continue
        if current is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame", line)
        if frame and current is not entry:
            current["stack_frame"] = int(frame.group(1))
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           line)
        if spills:
            current["spill_stores"] = int(spills.group(1))
            current["spill_loads"] = int(spills.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and entry is not None:
            entry["registers"] = int(regs.group(1))
    for record, name in zip(records,
                            _demangle([r["kernel"] for r in records])):
        record["kernel"] = name
    return records


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` is built to (content-addressed)."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as handle:
        digest = hashlib.sha256(handle.read() + repr(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns its path."""
    path = library_path(name)
    if os.path.exists(path):
        BUILD_SECONDS.setdefault(name, 0.0)
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: no process loads a half-written library
    BUILD_SECONDS[name] = time.perf_counter() - start
    PTXAS[name] = parse_ptxas(proc.stdout + proc.stderr)
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(build(name))
        return lib
