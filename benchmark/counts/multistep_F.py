"""Kernel F (K sim ticks in one launch, csrc/fused_multistep.cu, the
stepping engine's `FusedEngine.step_many`): operations and bytes of one
launch, for the stepping cell `tag_ppo.step`.

Operations: the port's plain tick (`ops/fused_step.py::step_rows_plain`)
counted once at commit 48a753d as update_D.py says, at 64 and 128 worlds:
1 517 a world-tick with the obs written (1 261 without them), no
per-launch constant.  Bytes: the state rows read and written once and
the last tick's obs written once (the every-tick instance's K obs
writes may stay in L2).
"""

OPS_PER_WORLD_TICK = 1_517
OPS_PER_WORLD_TICK_NO_OBS = 1_261
STATE_ROWS = 72 + 59
OBS_ROWS = 256
KERNELS = ("fused_multistep",)


def ops(num_envs: int, ticks: int, obs_every_tick: bool = True) -> int:
    if obs_every_tick:
        return OPS_PER_WORLD_TICK * num_envs * ticks
    return (OPS_PER_WORLD_TICK_NO_OBS * (ticks - 1) +
            OPS_PER_WORLD_TICK) * num_envs


def nbytes(num_envs: int) -> int:
    return num_envs * STATE_ROWS * 4 * 2 + num_envs * OBS_ROWS * 4
