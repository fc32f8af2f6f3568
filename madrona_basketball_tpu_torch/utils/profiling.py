"""Device profiling helpers (port of `madrona_basketball_tpu.utils.
profiling`, profiling.py:1-30).

The reference's only tracing is wall-clock phase timers
(scripts/ppo_stats.py:53-150; utils/timers.py ports them).  These wrap
`torch.profiler`: `trace` records the host and, on a CUDA card, the
device around a section and writes a Chrome trace (chrome://tracing,
Perfetto); `annotate` names a region inside it.

The JAX module's `honor_platform_env` and `enable_compile_cache` set JAX's
platform and XLA's persistent compilation cache; neither has a
counterpart here.  The port's compile cache is `_build.py`'s build
directory, whose libraries are named by a hash of their sources and
flags, so a repeat run reuses every kernel it built before.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str = "profile"):
    """Capture a trace: `with trace("logdir") as path: run_workload()`.
    Writes `log_dir/trace.json` (a Chrome trace) when the block exits;
    `path` is that file's name.  The CUDA activity is recorded when a
    card is present."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def annotate(name: str):
    """A named region inside a trace (a row on the timeline)."""
    return torch.profiler.record_function(name)
