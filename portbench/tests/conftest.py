"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
repository's root. They run on the CPU with the port's plain versions at
small sizes; the test marked `gpu` runs only where CUDA is available."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: runs the port's kernels on the card")
    return "cuda"


SMALL = {"height": 48, "width": 80}      # frame size of the CPU runs
BATCH = 4                                # frames a call in the CPU runs


@pytest.fixture
def small_cell():
    """A cell of BENCHMARK.json or `left_out.json` cut to a CPU test's size: the same
    configuration but SMALL frames, the same mix but BATCH frames a call."""
    from portbench.tests import cells

    def make(name, **mix):
        cell = cells.registry().cell(name)
        cell.config = dict(cell.config, **SMALL)
        per_call = min(cell.traffic["frames_per_call"], BATCH)
        cell.traffic = dict(cell.traffic, frames_per_call=per_call,
                            chunk=per_call, **mix)
        return cell
    return make


def _run_small(cell, trace=False, seed=2**31 + 7, seconds=0.3, **kw):
    import time

    from portbench import harness
    from portbench.tests import cells
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                            device="cpu", registry=kw.pop("registry", None)
                            or cells.registry(), **kw)


@pytest.fixture
def run_small():
    """One run of a cell on the CPU: the harness's look for a card is
    skipped and the port runs its plain versions."""
    return _run_small
