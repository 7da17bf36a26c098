"""Compute a costly test reference once per pytest run, however many
xdist workers ask for it.

``--dist load`` spreads one module's tests over the workers, and a
module-scoped fixture is then built on every worker that drew one of its
tests. ``shared`` keys a reference by name: the first caller takes an
exclusive ``fcntl.flock`` on a file in the directory that every worker of
the run shares (the parent of a worker's base temp dir; the base temp dir
itself outside xdist), computes the reference and pickles it there; every
other caller blocks on the lock, then loads that copy. The directory
belongs to this run, so nothing survives it.

A reference holds only numpy arrays, Python scalars and containers of
them, which pickle round-trips bit for bit.

The costliest reference, the float64 JAX train step of
test_torch_port_train_step.py (~22 s), is also started ahead of its tests:
``prefetch_costly_references`` (a session fixture each port test module
takes) starts, once per run, a child Python process that computes it
through ``load_or_compute`` while the workers run other tests. A worker
that reaches a test of it then loads the saved copy, or waits on the lock
for the rest of the child's work; if the child fails, the worker computes
the reference itself. The worker that started the child waits for it at
the end of its session.
"""
from __future__ import annotations

import fcntl
import os
import pickle
import subprocess
import sys
from typing import Any, Callable, Optional

import pytest

# the saved file: {"value": the reference, "computed_by": worker id}
_SUFFIX = ".torch_port_ref.pkl"


def shared_dir(tmp_path_factory) -> str:
    base = tmp_path_factory.getbasetemp()
    return str(base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base)


def shared(tmp_path_factory, name: str, compute: Callable[[], Any]) -> Any:
    """``compute()`` on the first call of this run under ``name``, its saved
    copy on every later one, in this worker or another."""
    return load_or_compute(shared_dir(tmp_path_factory), name, compute)[0]


def load_or_compute(directory: str, name: str, compute: Callable[[], Any]):
    """(reference, worker that computed it), under an exclusive lock on
    ``directory/name.lock``."""
    path = os.path.join(directory, name + _SUFFIX)
    with open(os.path.join(directory, name + ".lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                with open(path, "rb") as f:
                    saved = pickle.load(f)
            else:
                saved = {"value": compute(),
                         "computed_by": os.environ.get("PYTEST_XDIST_WORKER", "main")}
                tmp = f"{path}.{os.getpid()}.tmp"
                with open(tmp, "wb") as f:
                    pickle.dump(saved, f, protocol=pickle.HIGHEST_PROTOCOL)
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return saved["value"], saved["computed_by"]


# (test module, its function that computes its references into a directory
# through load_or_compute): started ahead when the run holds a test of it
PREFETCH = (("test_torch_port_train_step", "prefetch_references"),)
_TESTS = os.path.dirname(os.path.abspath(__file__))
_CHILD = """
import sys
sys.path[:0] = [{tests!r}, {root!r}]
import conftest  # the suite's JAX settings, before anything runs JAX
import importlib
import torch
torch.set_num_threads(1)
getattr(importlib.import_module({module!r}), {function!r})({directory!r})
"""


def prefetch(directory: str, module: str, function: str) -> Optional[subprocess.Popen]:
    """Start ``module.function(directory)`` in a child process, unless a
    caller of this run already has (then None). Its output goes to
    ``directory/<module>.prefetch.log``."""
    claim = os.path.join(directory, f"{module}.prefetch")
    try:
        os.close(os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        return None
    code = _CHILD.format(tests=_TESTS, root=os.path.dirname(_TESTS), module=module,
                         function=function, directory=directory)
    with open(claim + ".log", "w") as log:
        return subprocess.Popen([sys.executable, "-c", code], stdout=log,
                                stderr=subprocess.STDOUT, cwd=_TESTS)


@pytest.fixture(scope="session", autouse=True)
def prefetch_costly_references(request, tmp_path_factory):
    """Start each costly reference of ``PREFETCH`` whose module has a test
    in this run; wait for the children this worker started."""
    nodeids = [item.nodeid for item in request.session.items]
    children = [prefetch(shared_dir(tmp_path_factory), module, function)
                for module, function in PREFETCH
                if any(f"{module}.py::" in n for n in nodeids)]
    yield
    for child in children:
        if child is not None:
            child.wait()
