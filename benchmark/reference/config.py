"""A frozen copy of the port's
`madrona_basketball_tpu_torch/config.py`, for the benchmark's
reference; it stays as it is when the port's copy changes.  Its own
docstring follows.

Static simulation configuration (port of `madrona_basketball_tpu.config`).

`SimConfig` is frozen and hashable.  The three game modes are
`SimConfig()` (1v1 tag, the default and the training task),
`SimConfig(tag_mode=False)` (1v1 full rules) and
`SimConfig(one_on_one=False, tag_mode=False)` (full game).  The CUDA
kernels take these fields as launch arguments, so one binary serves every
mode.
"""

from __future__ import annotations

import dataclasses

from . import constants as C


@dataclasses.dataclass(frozen=True)
class SimConfig:
    num_agents: int = C.NUM_AGENTS
    num_balls: int = C.NUM_BASKETBALLS
    num_hoops: int = C.NUM_HOOPS

    # Initial GameState.isOneOnOne (src/constants.hpp:27).
    one_on_one: bool = True
    # The "FOR TAG" overrides: pass/grab masked off and the collision
    # tag-reward + reset block (src/game.cpp:525-528, 622-631).
    tag_mode: bool = True

    time_per_period: float = C.TIME_PER_PERIOD
    shot_clock_duration: float = C.SHOT_CLOCK_DURATION
    sim_dt: float = C.TIMESTEPS_TO_SECONDS_FACTOR

    grid_width: float = C.GRID_WIDTH_M
    grid_height: float = C.GRID_HEIGHT_M
    start_x: float = C.START_X
    start_y: float = C.START_Y

    max_episode_length: int = 39600

    def __post_init__(self):
        if self.num_agents != 2 or self.num_balls != 1 or self.num_hoops != 2:
            raise ValueError(
                "The rule set is specified for 2 agents / 1 ball / 2 hoops "
                "(reference src/constants.hpp:5-7)")


GAME_MODES = {
    "tag": SimConfig(),
    "1v1": SimConfig(tag_mode=False),
    "full": SimConfig(one_on_one=False, tag_mode=False),
}
