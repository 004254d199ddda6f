"""Fault F3: the port's CLI takes ``--profile_dir`` as the JAX CLI does.

The two parsers' subcommand options must agree but for the port's own
``--device``; ``classify --profile_dir DIR`` writes a ``torch.profiler``
trace there and prints the same plain table as the JAX CLI without the
flag; ``realtime`` takes the flag and ignores it.
"""

import argparse
import json
import os

import jax
import pytest

from deepbinner_tpu.cli import main as jax_cli
from deepbinner_tpu.models.checkpoint import save_model
from deepbinner_tpu.models.network import NetworkConfig, init_params
from deepbinner_tpu.utils import simulate
from deepbinner_tpu_torch.cli import main as port_cli

TINY_NET = NetworkConfig(
    input_length=256, stem_features=8, block_features=(8,),
    inception_features=(16,), head_features=16,
)
GEOMETRY = ("--scan_size", "768", "--batch_size", "8")


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__("parser built")
        self.parser = parser


def _parser(get_arguments, monkeypatch) -> argparse.ArgumentParser:
    """The parser ``get_arguments`` builds, caught before it parses."""

    def catch(self, args=None, namespace=None):
        raise _Parsed(self)

    with monkeypatch.context() as patch:
        patch.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as caught:
            get_arguments(["classify"])
    return caught.value.parser


def _options(parser) -> dict:
    """(subcommand, option) → (dest, default, type, choices, nargs)."""
    subparsers = next(a for a in parser._actions
                      if isinstance(a, argparse._SubParsersAction))
    options = {}
    for name, sub in subparsers.choices.items():
        for action in sub._actions:
            if isinstance(action, argparse._HelpAction):
                continue
            key = action.option_strings[-1] if action.option_strings else action.dest
            options[(name, key)] = (action.dest, action.default, action.type,
                                    action.choices, action.nargs)
    return options


def test_parsers_differ_only_by_device(monkeypatch):
    want = _options(_parser(jax_cli.get_arguments, monkeypatch))
    got = _options(_parser(port_cli.get_arguments, monkeypatch))
    only_port = {k for k in got if k not in want}
    only_jax = {k for k in want if k not in got}
    assert {option for _sub, option in only_port} == {"--device"}
    assert only_jax == set()
    assert {k: got[k] for k in want if got[k] != want[k]} == {}
    assert ("classify", "--profile_dir") in got
    assert ("realtime", "--profile_dir") in got


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("profile")
    _, variables = init_params(jax.random.PRNGKey(0), TINY_NET)
    model = root / "starts.dbt"
    save_model(model, TINY_NET, variables, {"kit": "EXP-NBD103"})
    truth = simulate.make_dataset(root / "ds", kit="EXP-NBD103",
                                  reads_per_barcode=1, none_reads=2,
                                  genome_length=600, seed=11,
                                  write_fastq=False)
    return str(root / "ds" / "fast5s"), str(model), truth


def test_classify_writes_a_trace_and_the_same_table(dataset, tmp_path, capsys):
    directory, model, truth = dataset
    argv = ["classify", directory, "-s", model, *GEOMETRY]
    jax_cli.main(argv)
    want = capsys.readouterr().out
    trace_dir = tmp_path / "trace"
    port_cli.main(argv + ["--device", "cpu", "--profile_dir", str(trace_dir)])
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == len(truth) + 1
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(traces) == 1, os.listdir(trace_dir)
    with open(trace_dir / traces[0]) as handle:
        trace = json.load(handle)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert any(e.get("ph") == "X" for e in events), events[:5]


def test_realtime_takes_profile_dir(tmp_path):
    args = port_cli.get_arguments([
        "realtime", "--in_dir", str(tmp_path), "--out_dir", str(tmp_path),
        "-s", "m.dbt", "--profile_dir", str(tmp_path / "p"), "--device", "cpu"])
    assert args.profile_dir == str(tmp_path / "p")
