"""A result computed once for a whole test run and shared by its xdist
workers. Imports no JAX."""

import fcntl
import os
import pickle


def once_per_run(tmp_path_factory, name: str, compute):
    """`compute()`'s result, computed once for the whole test run: the first
    test worker to get here computes it, the others (under xdist) wait on
    the lock and read it from the run's shared temporary directory."""
    base = tmp_path_factory.getbasetemp()
    # under xdist each worker's base is a directory of the run's own
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = shared / f"{name}.pkl"
    with open(shared / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            out = compute()
            with open(path.with_suffix(".part"), "wb") as f:
                pickle.dump(out, f)
            os.replace(path.with_suffix(".part"), path)
    with open(path, "rb") as f:
        return pickle.load(f)
