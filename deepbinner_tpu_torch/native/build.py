"""Build and load the port's native readers (g++ → shared library → ctypes).

Each ``src/<name>.cc`` has a plain C interface and is compiled on first use
by

    g++ -O2 -shared -fPIC -std=c++17 -Wall -Wextra -Werror
        -o build/native/<name>-<hash>.so src/<name>.cc [-l:<HDF5 runtime>]
        -Wl,--no-undefined

into ``build/native/`` at the root of the checkout (``build/`` is ignored by
git).  The library name carries a hash of the source, the flags and the
link arguments, so an edited source is rebuilt and a stale one is never
loaded; the build writes a temporary file and renames it, so processes that
build at the same time never load a half-written library.

``fast5_reader`` links the HDF5 runtime library by the soname that
``ctypes.util.find_library`` finds (``hdf5_serial``, else ``hdf5``); its
source declares the HDF5 ABI itself, so no development headers are needed,
and ``--no-undefined`` makes an ABI mismatch fail the link.  ``vbz_decode``
needs nothing but the compiler.  :func:`missing` says why a library cannot
be built here; a build that fails where nothing is missing raises with the
compiler's output.  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(SRC))), "build", "native")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
             "-Werror")
LIBRARIES = ("fast5_reader", "vbz_decode")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


@functools.lru_cache(maxsize=None)
def hdf5_runtime() -> Optional[str]:
    """The HDF5 runtime library's soname, or None where there is none."""
    return ctypes.util.find_library("hdf5_serial") or ctypes.util.find_library("hdf5")


def missing(name: str) -> Optional[str]:
    """Why ``src/<name>.cc`` cannot be built here, or None when it can."""
    if shutil.which("g++") is None:
        return "no g++ on the path"
    if name == "fast5_reader" and hdf5_runtime() is None:
        return ("no HDF5 runtime library (ctypes.util.find_library finds "
                "neither hdf5_serial nor hdf5)")
    return None


def _link_args(name: str) -> List[str]:
    if name == "fast5_reader":
        return [f"-l:{hdf5_runtime()}"]
    return []


def library_path(name: str) -> str:
    """Where ``src/<name>.cc`` is built to (content-addressed)."""
    with open(os.path.join(SRC, f"{name}.cc"), "rb") as handle:
        digest = hashlib.sha256(
            handle.read() + repr((CXX_FLAGS, _link_args(name))).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``src/<name>.cc`` unless its library exists; returns its path."""
    reason = missing(name)
    if reason is not None:
        raise RuntimeError(f"{name} cannot be built here: {reason}")
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, os.path.join(SRC, f"{name}.cc"),
           *_link_args(name), "-Wl,--no-undefined"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cc (exit {proc.returncode}):"
                           f"\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: no process loads a half-written library
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``src/<name>.cc``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(build(name))
        return lib


def loaded() -> List[str]:
    """The libraries this process has built or loaded so far."""
    with _LOCK:
        return sorted(_LOADED)


if __name__ == "__main__":
    for library in LIBRARIES:
        print(f"{library}: {missing(library) or load(library)._name}")
