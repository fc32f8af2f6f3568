"""A frozen copy of the port's
`madrona_basketball_tpu_torch/constants.py`, for the benchmark's
reference; it stays as it is when the port's copy changes.  Its own
docstring follows.

Simulation constants of the PyTorch port.

A copy of `madrona_basketball_tpu.constants` (importing that module would
run the JAX package's `__init__`, which imports JAX); tests/test_torch_layout
asserts every name here equals the JAX value.

Single source of truth replacing the reference's duplicated-and-diverged
C++/Python constant files (reference: src/constants.hpp vs src/constants.py).
Where the two diverged, the C++ values win because they drive sim behavior
(src/constants.hpp:13 TIME_PER_PERIOD=10 vs src/constants.py:12 300;
AGENT_SIZE_M 0.2 vs 0.25; PIXELS_PER_METER 110 vs 54).  Viewer-only values
live in `madrona_basketball_tpu.viewer.constants`.

All derived float constants are computed in float32 to match the C++
`constexpr float` arithmetic (src/constants.hpp:66-98).
"""

import math

import numpy as np

_f32 = np.float32

# ======================= Entity counts (src/constants.hpp:5-8) =======================
NUM_AGENTS = 2
NUM_BASKETBALLS = 1
NUM_HOOPS = 2
ENTITY_ID_PLACEHOLDER = 2**31 - 1  # INT32_MAX, used as invalid/null entity ID

# Stable entity IDs.  The reference allocates Madrona entity IDs in
# generateWorld creation order: hoop0, hoop1, ball, agent0, agent1
# (src/gen.cpp:101,131,167,187).  We fix them as compile-time constants.
HOOP_IDS = (0, 1)
BALL_ID = 2
AGENT_IDS = (3, 4)

# ======================= Simulation parameters (src/constants.hpp:11-13) =======================
SIMULATION_HZ = 62.0
TIMESTEPS_TO_SECONDS_FACTOR = float(_f32(1.0) / _f32(62.0))
TIME_PER_PERIOD = 10.0  # seconds (src/constants.hpp:13)

# ======================= Rendering & scaling (src/constants.hpp:17-19) =======================
PIXELS_PER_METER = 110.0
TEAM0_COLOR = (0.0, 100.0, 255.0)
TEAM1_COLOR = (128.0, 0.0, 128.0)
# resetWorld uses a *different* team-1 color than generateWorld — reproduced
# faithfully (src/gen.cpp:258 vs src/constants.hpp:19).
RESET_TEAM_COLORS = ((0.0, 100.0, 255.0), (255.0, 0.0, 100.0))

# ======================= Gameplay (src/constants.hpp:24-27) =======================
HOOP_SCORE_ZONE_SIZE = 0.1
IN_COURT_OFFSET = 0.1
SHOT_CLOCK_DURATION = 24.0
ONE_ON_ONE = 1

# ======================= Ball physical properties (src/constants.hpp:32-34) =======================
BALL_DIAMETER_M = 0.242
BALL_RADIUS_M = BALL_DIAMETER_M / 2.0
BALL_CIRCUMFERENCE_M = 0.749

# ======================= Agent properties (src/constants.hpp:39-50) =======================
AGENT_SIZE_M = 0.2
AGENT_SHOULDER_WIDTH = 0.4290
AGENT_DEPTH = 0.1
AGENT_ORIENTATION_ARROW_LENGTH_M = 0.5
NUM_OBSERVATIONS_PER_AGENT = 10
GUARDING_DISTANCE = 0.2
START_POS_STDDEV = 5.0
DEFAULT_SPEED = 3.0
DEFENDER_SLOWDOWN = 0.2
DEFENDER_REACTION = 10.0
DEFENDER_SPAWN_RADIUS = 8.0

# Movement (src/constants.hpp:53-55)
ANGLE_BETWEEN_DIRECTIONS = math.pi / 4.0
AGENT_BASE_FORWARD = (0.0, 1.0, 0.0)
BALL_AGENT_SLOWDOWN = 0.9

# Shooting (src/constants.hpp:59-61)
DIST_DEVIATION_PER_METER = 0.008
DEF_DEVIATION_PER_METER = 0.002
VEL_DEVIATION_FACTOR = 0.001

# ======================= Court dimensions, NBA standard (src/constants.hpp:67-98) =======================
COURT_LENGTH_M = 28.65
COURT_WIDTH_M = 15.24

WORLD_MARGIN_FACTOR = 1.1
WORLD_WIDTH_M = float(_f32(COURT_LENGTH_M) * _f32(WORLD_MARGIN_FACTOR))
WORLD_HEIGHT_M = float(_f32(COURT_WIDTH_M) * _f32(WORLD_MARGIN_FACTOR))

COURT_MIN_X = float((_f32(WORLD_WIDTH_M) - _f32(COURT_LENGTH_M)) / _f32(2.0))
COURT_MAX_X = float(_f32(COURT_MIN_X) + _f32(COURT_LENGTH_M))
COURT_MIN_Y = float((_f32(WORLD_HEIGHT_M) - _f32(COURT_WIDTH_M)) / _f32(2.0))
COURT_MAX_Y = float(_f32(COURT_MIN_Y) + _f32(COURT_WIDTH_M))

KEY_WIDTH_M = 4.88
KEY_HEIGHT_M = 5.79
HOOP_FROM_BASELINE_M = 1.575
FREE_THROW_CIRCLE_RADIUS_M = 1.8
CENTER_CIRCLE_RADIUS_M = 1.8
TOP_OF_KEY_RADIUS_M = 1.22
HALFCOURT_CIRCLE_RADIUS_M = 1.33

ARC_RADIUS_M = 7.24
CORNER_3_FROM_SIDELINE_M = 0.91
CORNER_3_LENGTH_FROM_BASELINE_M = 4.27

BACKBOARD_WIDTH_M = 1.829
RIM_DIAMETER_M = 0.4572
BACKBOARD_OFFSET_FROM_HOOP_M = HOOP_FROM_BASELINE_M - 1.22

# ======================= Grid (reference bindings defaults) =======================
# The reference env wrapper builds the world grid as ceil(world meters) cells
# at 1 cell/m and uses the *cell* extent (32 x 17), not the world extent,
# for continuous position clamping (scripts/env.py:22-29, src/bindings.cpp:28-51,
# src/game.cpp:469-470).
GRID_DISCRETE_X = math.ceil(WORLD_WIDTH_M)   # 32
GRID_DISCRETE_Y = math.ceil(WORLD_HEIGHT_M)  # 17
CELLS_PER_METER = 1
GRID_WIDTH_M = float(GRID_DISCRETE_X) / CELLS_PER_METER   # 32.0
GRID_HEIGHT_M = float(GRID_DISCRETE_Y) / CELLS_PER_METER  # 17.0
START_X = WORLD_WIDTH_M / 2.0  # 15.7575 (scripts/env.py:28)
START_Y = WORLD_HEIGHT_M / 2.0  # 8.382  (scripts/env.py:29)

# ======================= RL interface =======================
# Move/don't move [0,1], move angle [0,7], rotate [0,2], grab, pass, shoot
# (scripts/env.py:96-102)
ACTION_BUCKETS = (2, 8, 3, 2, 2, 2)
NUM_ACTIONS = len(ACTION_BUCKETS)
OBS_SIZE = 128  # float slots (src/game.cpp:1175-1461)
OBS_USED = 103  # slots actually written; the tail is structural zero
# padding (src/game.cpp:1456-1460).  Count: 5 game + 2 scores + 10 ball
# + 6 hoops + 38 self + 38 opponent + 2 holder + 2 inbounder one-hots
# (src/game.cpp:1255-1452; SURVEY §2.2's "101" undercounts the 38-float
# agent blocks as 37).  Inputs >= OBS_USED contribute nothing to the
# policy (0 * w), so the update phase trains on packed 103-feature rows;
# asserted against the obs builder at trace time
# (ops/fused_step.step_fields).
