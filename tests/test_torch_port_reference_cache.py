"""tests/torch_port_reference_cache.py: a costly reference is computed once
per run, whatever the number of xdist workers, and its saved copy loads
bit for bit."""
import os
import subprocess
import sys
import types

import numpy as np

from torch_port_reference_cache import load_or_compute, prefetch, shared_dir

TESTS = os.path.dirname(os.path.abspath(__file__))

# one "worker": load or compute the reference under the lock; the compute
# appends a line to a counter file and sleeps, so that the others queue
_WORKER = """
import os, sys, time
import numpy as np
from torch_port_reference_cache import load_or_compute
directory, counter = sys.argv[1], sys.argv[2]

def compute():
    with open(counter, "a") as f:
        f.write(os.environ["PYTEST_XDIST_WORKER"] + "\\n")
    time.sleep(0.5)
    return {"x": np.arange(6.0).reshape(2, 3), "n": 7}

value, by = load_or_compute(directory, "race", compute)
assert value["n"] == 7 and (value["x"] == np.arange(6.0).reshape(2, 3)).all()
print(by)
"""


def test_racing_workers_compute_once_and_load_the_saved_copy(tmp_path):
    counter = tmp_path / "computes.txt"
    env = dict(os.environ, PYTHONPATH=TESTS)
    procs = []
    for w in range(4):
        env["PYTEST_XDIST_WORKER"] = f"gw{w}"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path), str(counter)],
            env=dict(env), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    computed = counter.read_text().split()
    assert len(computed) == 1, computed
    # every worker reports the one that computed it: three loaded its copy
    assert {out.strip() for out, _ in outs} == set(computed)


def test_saved_copy_loads_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    ref = {
        "params": {"a": {"kernel": rng.normal(size=(3, 3, 4, 5)).astype(np.float32)}},
        "f64": np.array([np.nan, -0.0, np.inf, 1e-310, np.pi]),
        "pixels": rng.integers(0, 256, (2, 4), dtype=np.uint8),
        "trajectory": [({"p": np.float32(1.5)}, {"loss": 0.1 + 0.2})],
        "feats": [np.ones((2, 2), np.float32)],
    }
    made = []
    first, by = load_or_compute(str(tmp_path), "tree", lambda: made.append(1) or ref)
    again, by_again = load_or_compute(str(tmp_path), "tree", lambda: made.append(1) or {})
    assert made == [1] and by == by_again
    for got in (first, again):
        assert got.keys() == ref.keys()
        np.testing.assert_array_equal(got["params"]["a"]["kernel"], ref["params"]["a"]["kernel"])
        assert got["f64"].tobytes() == ref["f64"].tobytes()  # NaN and -0.0 too
        assert got["pixels"].dtype == np.uint8
        assert got["pixels"].tobytes() == ref["pixels"].tobytes()
        assert got["trajectory"][0][1]["loss"] == 0.1 + 0.2
        assert isinstance(got["trajectory"][0], tuple)
        assert got["feats"][0].dtype == np.float32


def test_the_shared_directory_is_the_runs_under_xdist(tmp_path, monkeypatch):
    base = tmp_path / "popen-gw3"
    factory = types.SimpleNamespace(getbasetemp=lambda: base)
    monkeypatch.setenv("PYTEST_XDIST_WORKER", "gw3")
    assert shared_dir(factory) == str(tmp_path)
    monkeypatch.delenv("PYTEST_XDIST_WORKER")
    assert shared_dir(factory) == str(base)


# a module whose references ``prefetch`` computes in its child
_PREFETCHED = """
import os, time
import numpy as np
from torch_port_reference_cache import load_or_compute

def references(directory):
    load_or_compute(directory, "ahead", lambda: {"x": np.arange(4.0), "pid": os.getpid()})
"""


def test_prefetch_starts_one_child_per_run_and_its_copy_loads(tmp_path, monkeypatch):
    (tmp_path / "prefetched_mod.py").write_text(_PREFETCHED)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    child = prefetch(str(tmp_path), "prefetched_mod", "references")
    assert child is not None
    # another caller of the same run finds the claim and starts nothing
    assert prefetch(str(tmp_path), "prefetched_mod", "references") is None
    assert child.wait(timeout=120) == 0, (tmp_path / "prefetched_mod.prefetch.log").read_text()
    value, _ = load_or_compute(str(tmp_path), "ahead", lambda: {"pid": os.getpid()})
    assert value["pid"] == child.pid  # computed by the child, loaded here
    np.testing.assert_array_equal(value["x"], np.arange(4.0))
