"""Once a run: a costly reference (a JAX compile, an interpret-mode kernel
run) computed by one pytest process and loaded by the others.

Under xdist (`--dist load`) one module's tests go to several workers, and
each worker sets up the module's fixtures itself.  `once_per_run` makes
the first worker to ask for a key compute its value and store it,
pickled, in the session's shared temp root (`getbasetemp().parent` under
xdist, the standard idiom); a `filelock.FileLock` a key holds the others
until it is there, and they load it.  Without xdist the store is the
session's own temp dir, so nothing outlives a run.

The helper stores what a compute returns and nothing else: hand it the
JAX side only (as numpy arrays), and keep every comparison in the test.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import time

from filelock import FileLock, Timeout


# Seconds a worker waits for the others' computes: a cold interpret-mode
# kernel takes up to ~100 s on a loaded CPU.
TIMEOUT = 600.0


def once_per_run(tmp_path_factory, name: str, computes: dict) -> dict:
    """{key: compute} -> {key: compute()}, each compute run once per
    pytest session across all xdist workers.  A key is the inputs'
    description (its repr names the stored file), so two modules that
    build one reference with one key share it.  A worker first takes the
    keys that no other worker is computing, then waits for the rest: the
    workers that set up one module's fixture at once split its keys.  A
    worker still waiting TIMEOUT s after the call fails
    (`filelock.Timeout`) instead of holding the run's clock."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    end = time.monotonic() + TIMEOUT
    out = {}

    def take(key, blocking):
        digest = hashlib.sha256(repr((name, key)).encode()).hexdigest()[:20]
        path = root / f"once-{name}-{digest}.pkl"
        lock = FileLock(f"{path}.lock")
        try:
            lock.acquire(blocking=blocking,
                         timeout=max(end - time.monotonic(), 0.0))
        except Timeout:
            if blocking:
                raise
            return
        try:
            if path.is_file():
                with open(path, "rb") as f:
                    out[key] = pickle.load(f)
                return
            out[key] = computes[key]()
            part = path.with_suffix(".part")
            with open(part, "wb") as f:
                pickle.dump(out[key], f, protocol=pickle.HIGHEST_PROTOCOL)
            part.rename(path)
        finally:
            lock.release()

    for key in computes:
        take(key, blocking=False)
    for key in computes:
        if key not in out:
            take(key, blocking=True)
    return {key: out[key] for key in computes}
