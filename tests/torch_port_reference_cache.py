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
"""
from __future__ import annotations

import fcntl
import os
import pickle
from typing import Any, Callable

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
