"""Kernel F's share of its roofline: its bound (counts/multistep_F.py, one
launch of `ticks_per_launch` ticks) over its profiled device time a
launch."""

from benchmark import trace
from benchmark.counts import multistep_F, peaks


def read(ctx):
    tr, run = ctx["trace"], ctx["run"]
    if tr is None:
        return None
    s, n = trace.kernel_seconds(tr, multistep_F.KERNELS)
    if n == 0:
        return None
    every = run.traffic["obs_every_tick"]
    bound = peaks.bound_s(multistep_F.nbytes(run.num_envs),
                          multistep_F.ops(run.num_envs, run.K, every))
    return 100.0 * bound / (s / n)
