"""Kernel B (the rollout, csrc/fused_rollout.cu): operations and bytes of
one T-tick launch, with or without the frozen opponent's policy.

Operations: the port's plain version (`ops/fused_rollout.py::
rollout_plain`, Philox noise) counted once at commit 48a753d as
update_D.py says, at 64 and 128 worlds for one tick: a + b W with
14 669.3125 a world-tick (27 390.3125 with the frozen opponent) and 206
a tick.  Bytes: the state and obs rows read and written once, the packed
policy (both, with the opponent) read once, the trajectory written once
and the per-(tick, 32-world) obs-moment partials written once.
"""

OPS_PER_WORLD_TICK = 14_669.3125
OPS_PER_WORLD_TICK_FROZEN = 27_390.3125
OPS_PER_TICK = 206
STATE_ROWS = 72 + 59
OBS_ROWS = 256
POLICY_FLOATS = 6_272
TRAJ_ROWS = 128
ROLL_OBS = 103
KERNELS = ("fused_rollout_kernel",)


def ops(num_envs: int, num_rollout_steps: int, use_frozen: bool) -> float:
    per = OPS_PER_WORLD_TICK_FROZEN if use_frozen else OPS_PER_WORLD_TICK
    return num_rollout_steps * (per * num_envs + OPS_PER_TICK)


def nbytes(num_envs: int, num_rollout_steps: int, use_frozen: bool) -> int:
    W, T = num_envs, num_rollout_steps
    policies = 2 if use_frozen else 1
    return (W * (STATE_ROWS + OBS_ROWS) * 4 * 2 +
            policies * POLICY_FLOATS * 4 + T * TRAJ_ROWS * W * 4 +
            T * (W // 32) * ROLL_OBS * 2 * 4)
