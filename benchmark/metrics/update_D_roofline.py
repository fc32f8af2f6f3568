"""Kernel D's share of its roofline: its bound (counts/update_D.py) over
its profiled device time an iteration (every launch of its gradient and
reduce kernels in the profiled span, over the span's iterations)."""

from benchmark import trace
from benchmark.counts import peaks, update_D
from benchmark.reference.update import pick_update_block


def read(ctx):
    tr, run = ctx["trace"], ctx["run"]
    if tr is None:
        return None
    hp = run.hp
    per_call = hp.update_epochs * hp.num_minibatches  # each kernel's launches
    secs = 0.0
    for key in update_D.KERNELS:
        s, n = trace.kernel_seconds(tr, [key])
        if n == 0:
            return None
        secs += s / n * per_call      # the mean launch, for every launch
    wb = hp.update_block or pick_update_block(hp.num_envs,
                                              hp.minibatch_size)
    bound = peaks.bound_s(
        update_D.nbytes(hp.num_envs, hp.num_rollout_steps, hp.update_epochs,
                        wb),
        update_D.ops(hp.num_envs, hp.num_rollout_steps, hp.update_epochs,
                     hp.num_minibatches))
    return 100.0 * bound / secs
