"""Kernel B's share of its roofline: its bound (counts/rollout_B.py, both
policies' work with the frozen opponent) over its profiled device time a
launch (one launch an iteration)."""

from benchmark import trace
from benchmark.counts import peaks, rollout_B


def read(ctx):
    tr, hp = ctx["trace"], ctx["run"].hp
    if tr is None:
        return None
    s, n = trace.kernel_seconds(tr, rollout_B.KERNELS)
    if n == 0:
        return None
    bound = peaks.bound_s(
        rollout_B.nbytes(hp.num_envs, hp.num_rollout_steps, hp.use_frozen),
        rollout_B.ops(hp.num_envs, hp.num_rollout_steps, hp.use_frozen))
    return 100.0 * bound / (s / n)
