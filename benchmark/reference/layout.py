"""A frozen copy of the port's
`madrona_basketball_tpu_torch/ops/layout.py`, for the benchmark's
reference; it stays as it is when the port's copy changes.  Its own
docstring follows.

Flat SoA field-row layout (port of `madrona_basketball_tpu.ops.layout`).

The whole simulation state is two matrices, SF (N_F32_ROWS, W) float32
and SI (N_I32_ROWS, W) int32: column = world, row = one scalar field.
The CUDA device body (csrc/sim_world.cuh) lists the same fields in the
same order in its X-macros; tests/test_torch_layout.py holds the two
lists together.
"""

from __future__ import annotations

from . import constants as C

AGENT_F32 = (
    "pos_x", "pos_y", "pos_z",
    "vel_x", "vel_y", "vel_z",
    "quat_w", "quat_x", "quat_y", "quat_z",
    "reward", "done", "cooldown",
    "stat_points", "stat_fouls",
    "max_speed", "quickness", "shooting", "ft_pct", "reaction",
    "target_x", "target_y", "target_z",
    "shot_pct",
    "color_r", "color_g", "color_b",
)
AGENT_I32 = (
    "a_move", "a_angle", "a_rotate", "a_grab", "a_pass", "a_shoot",
    "m_move", "m_grab", "m_pass", "m_shoot",
    "reset", "cur_step",
    "has_ball", "held_ball", "points_worth",
    "im_inb", "allowed_move",
    "team", "defend_hoop",
)
BALL_F32 = ("bpos_x", "bpos_y", "bpos_z", "bvel_x", "bvel_y", "bvel_z",
            "bdone")
BALL_I32 = ("bgrabbed", "bholder", "binflight", "blt_agent", "blt_team",
            "bsb_agent", "bsb_team", "bspv", "bsgi", "breset", "bcur_step")
GAME_F32 = ("period", "tip", "t0score", "t1score", "gclock", "sclock",
            "sbaskets", "oob", "iclock")
GAME_I32 = ("ginb", "glive", "t0hoop", "t1hoop", "is1v1", "reset_now")
HOOP_F32 = ("hdone0", "hdone1")
HOOP_I32 = ("hcur0", "hcur1", "hreset0", "hreset1")

A = C.NUM_AGENTS

F_IDX: dict[str, int] = {}
I_IDX: dict[str, int] = {}
for _i in range(A):
    for _n in AGENT_F32:
        F_IDX[f"a{_i}.{_n}"] = len(F_IDX)
    for _n in AGENT_I32:
        I_IDX[f"a{_i}.{_n}"] = len(I_IDX)
for _n in BALL_F32:
    F_IDX[_n] = len(F_IDX)
for _n in BALL_I32:
    I_IDX[_n] = len(I_IDX)
for _n in GAME_F32:
    F_IDX[_n] = len(F_IDX)
for _n in GAME_I32:
    I_IDX[_n] = len(I_IDX)
for _n in HOOP_F32:
    F_IDX[_n] = len(F_IDX)
for _n in HOOP_I32:
    I_IDX[_n] = len(I_IDX)

N_F32_ROWS = len(F_IDX)      # 72
N_I32_ROWS = len(I_IDX)      # 59
N_OBS_ROWS = A * C.OBS_SIZE  # 256
N_NOISE_ROWS = A * 3 + 3     # 9: shot_u per agent + reset_u

ACTION_NAMES = ("a_move", "a_angle", "a_rotate", "a_grab", "a_pass",
                "a_shoot")
ACTION_ROWS = [[I_IDX[f"a{i}.{n}"] for n in ACTION_NAMES] for i in range(A)]
RESET_ROWS = [I_IDX[f"a{i}.reset"] for i in range(A)]


def _xyz(prefix):
    return (f"{prefix}_x", f"{prefix}_y", f"{prefix}_z")


QUAT = ("quat_w", "quat_x", "quat_y", "quat_z")
MASK_NAMES = ("m_move", "m_grab", "m_pass", "m_shoot")
COLOR = ("color_r", "color_g", "color_b")
# (field of state.Agents, row names per agent or one name, table)
_AGENT_FIELDS = (
    ("pos", _xyz("pos"), "f"), ("vel", _xyz("vel"), "f"),
    ("orient", QUAT, "f"), ("action", ACTION_NAMES, "i"),
    ("action_mask", MASK_NAMES, "i"), ("reset", "reset", "i"),
    ("reward", "reward", "f"), ("done", "done", "f"),
    ("cur_step", "cur_step", "i"), ("has_ball", "has_ball", "i"),
    ("held_ball_id", "held_ball", "i"),
    ("points_worth", "points_worth", "i"),
    ("im_inbounding", "im_inb", "i"),
    ("allowed_to_move", "allowed_move", "i"), ("team", "team", "i"),
    ("team_color", COLOR, "f"), ("defending_hoop", "defend_hoop", "i"),
    ("grab_cooldown", "cooldown", "f"), ("stat_points", "stat_points", "f"),
    ("stat_fouls", "stat_fouls", "f"), ("max_speed", "max_speed", "f"),
    ("quickness", "quickness", "f"), ("shooting", "shooting", "f"),
    ("ft_pct", "ft_pct", "f"), ("reaction_speed", "reaction", "f"),
    ("target_pos", _xyz("target"), "f"), ("shot_pct", "shot_pct", "f"))
_BALL_FIELDS = (
    ("pos", ("bpos_x", "bpos_y", "bpos_z"), "f"),
    ("vel", ("bvel_x", "bvel_y", "bvel_z"), "f"), ("done", "bdone", "f"),
    ("grabbed", "bgrabbed", "i"), ("holder", "bholder", "i"),
    ("in_flight", "binflight", "i"), ("last_touched_agent", "blt_agent", "i"),
    ("last_touched_team", "blt_team", "i"),
    ("shot_by_agent", "bsb_agent", "i"), ("shot_by_team", "bsb_team", "i"),
    ("shot_point_value", "bspv", "i"), ("shot_going_in", "bsgi", "i"),
    ("reset", "breset", "i"), ("cur_step", "bcur_step", "i"))
_GAME_FIELDS = (
    ("period", "period", "f"), ("team_in_possession", "tip", "f"),
    ("team0_score", "t0score", "f"), ("team1_score", "t1score", "f"),
    ("game_clock", "gclock", "f"), ("shot_clock", "sclock", "f"),
    ("scored_baskets", "sbaskets", "f"), ("oob_count", "oob", "f"),
    ("inbound_clock", "iclock", "f"),
    ("inbounding_in_progress", "ginb", "i"), ("live_ball", "glive", "i"),
    ("team0_hoop", "t0hoop", "i"), ("team1_hoop", "t1hoop", "i"),
    ("is_one_on_one", "is1v1", "i"))
_HOOP_FIELDS = (("done", ("hdone0", "hdone1"), "f"),
                ("cur_step", ("hcur0", "hcur1"), "i"),
                ("reset", ("hreset0", "hreset1"), "i"))


