"""Kernel D (the update phase, csrc/fused_update.cu): operations and bytes
of one call, which runs every epoch x minibatch of an iteration.

Operations: the port's plain version (`ops/fused_update.py::
minibatch_grad_prefetch_plain` and `ppo/train.py::clip_adam_step`)
counted once at commit 48a753d with a TorchDispatchMode over its float
arithmetic (elementwise results one op an element, reductions one an
input element, products two a multiply-add): 25 253 a sample of an epoch,
the same at 256 and 512 worlds x 8 ticks, and 93 897 for one clip and
Adam step of the 5 216 parameters.  Bytes: each input read once and each
output written once (the trajectory's obs, action and logp rows and the
raw side rows of every sample, the weights, the normalizer, the moments
read and written).
"""

OPS_PER_SAMPLE_EPOCH = 25_253
OPS_PER_ADAM_STEP = 93_897
N_PARAMS = 5_216
OBS_USED = 103
ROWS_PER_SAMPLE = OBS_USED + 6 + 1 + 3   # obs | actions | logp; side rows
KERNELS = ("update_grad_kernel", "update_reduce_kernel")


def ops(num_envs: int, num_rollout_steps: int, update_epochs: int,
        num_minibatches: int) -> int:
    samples = num_envs * num_rollout_steps
    return (OPS_PER_SAMPLE_EPOCH * update_epochs * samples +
            OPS_PER_ADAM_STEP * update_epochs * num_minibatches)


def nbytes(num_envs: int, num_rollout_steps: int, update_epochs: int,
           block: int) -> int:
    samples = num_envs * num_rollout_steps
    idx = update_epochs * samples // block
    small_in = 2 * OBS_USED * 4 + N_PARAMS * 4
    return (idx * 4 + samples * ROWS_PER_SAMPLE * 4 + small_in + 8 * 4 +
            2 * 3 * N_PARAMS * 4)
