"""The intra-op threads of the port's CPU tests.

torch's intra-op pool defaults to one thread a core, and each parallel
region waits for all of its threads. Under `pytest -n 6` six such pools
share the host's cores: six concurrent runs of
`test_torch_port_funasr.py::test_engine_defaults_fit_the_default_request`
(14.8 s alone on 8 cores) had not finished after 510 s with the default
pools, and took 24.7-26.3 s with one thread each (25-27 s with two). One
thread a worker for a whole run leaves the cores idle once the other
workers are done: the last file then runs on one thread.

So every `tests/test_torch_port_*.py` module imports two autouse
fixtures. In a pytest-xdist worker, `worker_mark` keeps a file named for
the worker in a directory of the run (`PYTEST_XDIST_TESTRUNUID`) while one
of its modules runs, and `host_threads` gives torch, before each test, the
host's cores divided by the workers whose files are there (at least one
thread), restoring the count after the module. A run in one process
keeps torch's own count.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import pytest
import torch


def threads_for(cpus: int, workers: int) -> int:
    """Intra-op threads of one of `workers` busy processes on `cpus` cores."""
    return max(1, cpus // max(1, workers))


def _mark() -> Path | None:
    """This xdist worker's file in its run's directory, or None outside xdist."""
    run, worker = os.environ.get("PYTEST_XDIST_TESTRUNUID"), os.environ.get("PYTEST_XDIST_WORKER")
    if not (run and worker):
        return None
    run_dir = Path(tempfile.gettempdir()) / f"tpu_audio_torch_threads_{run}"
    run_dir.mkdir(exist_ok=True)
    return run_dir / worker


@pytest.fixture(autouse=True, scope="module")
def worker_mark():
    mark, before = _mark(), torch.get_num_threads()
    if mark is not None:
        try:
            mark.touch()
        except FileNotFoundError:  # the last worker out removed the directory meanwhile
            mark.parent.mkdir(exist_ok=True)
            mark.touch()
    yield mark
    if mark is not None:
        mark.unlink(missing_ok=True)
        try:
            mark.parent.rmdir()  # the last worker out
        except OSError:
            pass
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def host_threads(worker_mark):
    if worker_mark is not None:
        busy = sum(1 for _ in worker_mark.parent.iterdir())
        torch.set_num_threads(threads_for(os.cpu_count() or 1, busy))


def test_threads_rule():
    assert threads_for(8, 6) == 1 and threads_for(8, 4) == 2 and threads_for(8, 1) == 8
    assert threads_for(2, 6) == 1 and threads_for(64, 0) == 64


def test_the_fixtures_divide_the_cores_among_busy_workers(worker_mark):
    if worker_mark is None:
        assert torch.get_num_threads() >= 1
        return
    assert worker_mark.exists()
    cpus, workers = os.cpu_count() or 1, int(os.environ["PYTEST_XDIST_WORKER_COUNT"])
    # the other workers start and finish modules meanwhile: between all busy and this alone
    assert threads_for(cpus, workers) <= torch.get_num_threads() <= cpus
