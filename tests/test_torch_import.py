"""The port imports with jax, flax, h5py and keras blocked and loads
nothing of the JAX package, ``__graft_entry__`` included."""

import json
import pkgutil
import subprocess
import sys

import deepbinner_tpu_torch

_PROBE = r"""
import importlib, json, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "h5py",
                                  "keras", "tensorflow", "__graft_entry__"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, _Block())
import deepbinner_tpu_torch
names = [m.name for m in pkgutil.walk_packages(deepbinner_tpu_torch.__path__,
                                               "deepbinner_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import torch
from deepbinner_tpu_torch.native import build
try:
    deepbinner_tpu_torch.resolve_device(None)
    raised = False
except RuntimeError:
    raised = True
print(json.dumps({
    "imported": names,
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                             "h5py", "keras", "tensorflow",
                                             "deepbinner_tpu",
                                             "__graft_entry__")),
    "cuda": torch.cuda.is_available(),
    "resolve_raised": raised,
    "native_loaded": build.loaded(),
    "pod5_libraries": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("zstandard", "flatbuffers")),
}))
"""


def _probe():
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_without_jax():
    result = _probe()
    expected = {m.name for m in pkgutil.walk_packages(
        deepbinner_tpu_torch.__path__, "deepbinner_tpu_torch.")}
    assert set(result["imported"]) == expected
    assert "deepbinner_tpu_torch.ops.conv_kernel" in expected
    assert "deepbinner_tpu_torch.cli.classify" in expected
    assert result["foreign"] == []
    assert "deepbinner_tpu_torch.runner.mp_reader" in expected
    assert "deepbinner_tpu_torch.native.build" in expected
    for name in ("cli.bin_reads", "cli.realtime", "utils.seqio", "native.zstd",
                 "parallel.mesh", "parallel.dist", "models.keras_import",
                 "entry"):
        assert f"deepbinner_tpu_torch.{name}" in expected
    assert result["pod5_libraries"] == []  # neither zstandard nor flatbuffers
    assert result["native_loaded"] == []  # importing builds nothing
    # The card is the default: without one, resolving the default raises.
    assert result["resolve_raised"] == (not result["cuda"])


def test_resolve_device_cpu_is_explicit():
    import torch

    assert deepbinner_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    assert deepbinner_tpu_torch.resolve_device(torch.device("cpu")).type == "cpu"
