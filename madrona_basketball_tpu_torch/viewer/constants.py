"""Viewer-only constants + event extraction rules (port of
`madrona_basketball_tpu.viewer.constants`, constants.py:1-86).

The reference keeps a second, diverged copy of the sim constants for the
viewer (src/constants.py vs src/constants.hpp — TIME_PER_PERIOD 300 vs 10,
PIXELS_PER_METER 54 vs 110, AGENT_SIZE_M 0.25 vs 0.2).  Sim-truth lives in
`madrona_basketball_tpu_torch.constants`; only presentation-layer values and the
trajectory-log event rules live here.
"""

from .. import constants as C

PIXELS_PER_METER = 54.0
WINDOW_WIDTH = int(PIXELS_PER_METER * 32.3)
WINDOW_HEIGHT = int(PIXELS_PER_METER * 18.2)
BACKGROUND_COLOR = (50, 50, 50)
COURT_COLOR = (180, 120, 60)
LINE_COLOR = (240, 240, 240)
TEXT_COLOR = (255, 255, 255)
TEAM0_COLOR = (0, 100, 255)
TEAM1_COLOR = (128, 0, 128)
BALL_COLOR = (255, 140, 0)
AGENT_DRAW_SIZE_M = 0.25  # the viewer draws agents slightly larger
FPS = 60

# Event detection over logged trajectories (the npz schema of
# scripts/ppo.py:94-105).  Mirrors src/constants.py:27-59: an event fires at
# a step when its action was pressed and its condition over the logged
# tensors holds; the outcome picks the glyph.
EVENT_DEFINITIONS = {
    "shoot": {
        "action_idx": 5,
        "conditions": lambda log, t, w, agent=0: (
            t >= 1
            and int(log["ball_physics"][t, w, 0][0]) == 1
            and int(log["ball_physics"][t - 1, w, 0][0]) == 0),
        "outcome_func": lambda log, t, w: (
            int(log["ball_physics"][t, w, 0][6]) == 1),
        "visuals": {
            True: {"shape": "circle", "color": (0, 255, 0), "size": 7},
            False: {"shape": "x", "color": (255, 0, 0), "size": 5},
        },
    },
    "pass": {
        "action_idx": 4,
        "conditions": lambda log, t, w, agent=0: (
            t >= 1
            and int(log["agent_possession"][t - 1, w, agent, 0]) == 1
            and t + 1 < len(log["ball_vel"])
            and (abs(float(log["ball_vel"][t + 1, w, 0][0])) > 1e-3
                 or abs(float(log["ball_vel"][t + 1, w, 0][1])) > 1e-3)
            and int(log["ball_physics"][t + 1, w, 0][0]) == 0),
        "outcome_func": lambda log, t, w: True,
        "visuals": {
            True: {"shape": "circle", "color": (0, 255, 0), "size": 7},
        },
    },
    "grab": {
        "action_idx": 3,
        "conditions": lambda log, t, w, agent=0: (
            t >= 1
            and int(log["agent_possession"][t, w, agent, 0])
            != int(log["agent_possession"][t - 1, w, agent, 0])),
        "outcome_func": lambda log, t, w: True,
        "visuals": {
            True: {"shape": "circle", "color": (0, 255, 0), "size": 7},
        },
    },
}

# GameState tensor slots (clean float export, export.py game_state_tensor).
GS_INBOUNDING = 0
GS_LIVE_BALL = 1
GS_PERIOD = 2
GS_TEAM_IN_POSSESSION = 3
GS_TEAM0_SCORE = 5
GS_TEAM1_SCORE = 7
GS_GAME_CLOCK = 8
GS_SHOT_CLOCK = 9
GS_SCORED_BASKETS = 10
GS_OOB_COUNT = 11
GS_INBOUND_CLOCK = 12

COURT_MIN_X = C.COURT_MIN_X
COURT_MAX_X = C.COURT_MAX_X
COURT_MIN_Y = C.COURT_MIN_Y
COURT_MAX_Y = C.COURT_MAX_Y
