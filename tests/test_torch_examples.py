"""The examples of cosmo_tpu_torch (``cosmo_tpu_torch/examples/``), the
port's copy of the acceptance harness of tests/test_examples.py: one case
an example, its ``main("cpu")`` run in this process in float64, its own
assertions deciding (tolerances as in ``examples/``). ``python -m
cosmo_tpu_torch.examples.<name>`` runs one on the card."""
import gc
import importlib
import pathlib

import pytest
import torch

from cosmo_tpu_torch.examples import EXAMPLES

torch.set_num_threads(1)


def test_examples_are_those_of_the_reference():
    """One port for each script of examples/ and nothing else."""
    root = pathlib.Path(__file__).parent.parent / "examples"
    names = sorted(p.stem for p in root.glob("*.py") if p.name != "_common.py")
    assert names == sorted(EXAMPLES)


@pytest.fixture
def frozen_heap():
    """The objects this worker already holds, frozen out of the garbage
    collector while an example runs: portfolio_backtest asserts on
    host-clock solve times a few milliseconds apart."""
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_cpu(name, frozen_heap):
    importlib.import_module(f"cosmo_tpu_torch.examples.{name}").main("cpu")


def test_backtest_margins_reports_each_run(capsys):
    """``python -m cosmo_tpu_torch.backtest_margins`` runs the backtest's
    re-solve loop the asked number of times and ends with one JSON line of
    every run's margin; its exit code says whether every run held."""
    import json

    from cosmo_tpu_torch import backtest_margins

    rc = backtest_margins.main(["--runs", "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["of"] == 2 and len(out["runs"]) == 2
    for run in out["runs"]:
        assert run["margin_ms"] == run["first_ms"] - run["best_resolve_ms"]
        assert run["held"] == (run["best_resolve_ms"] < run["first_ms"])
    assert out["held"] == sum(r["held"] for r in out["runs"])
    assert rc == (0 if out["held"] == 2 else 1)
