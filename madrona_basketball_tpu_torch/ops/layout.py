"""Flat SoA field-row layout (port of `madrona_basketball_tpu.ops.layout`).

The whole simulation state is two matrices, SF (N_F32_ROWS, W) float32
and SI (N_I32_ROWS, W) int32: column = world, row = one scalar field.
The CUDA device body (csrc/sim_world.cuh) lists the same fields in the
same order in its X-macros; tests/test_torch_layout.py holds the two
lists together.
"""

from __future__ import annotations

from .. import constants as C

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


def unpack(cfg, sf, si, obs=None):
    """(SF, SI[, OBS]) -> the structured `state.State` view, (W, ...)
    tensors: the fields of the JAX layout.unpack (ops/layout.py:195-307)
    that the export reads.  Hoop positions come from the config (constant
    after init)."""
    import torch

    from ..state import Agents, Ball, GameState, Hoops, State

    W = sf.shape[1]

    def gf(k):
        return sf[F_IDX[k]]

    def gi(k):
        return si[I_IDX[k]]

    def per_agent(name, table=gf):
        return torch.stack([table(f"a{i}.{name}") for i in range(A)], dim=1)

    def per_agent_vec(names, table=gf):
        return torch.stack([torch.stack([table(f"a{i}.{n}") for n in names],
                                        dim=-1) for i in range(A)], dim=1)

    def xyz(prefix):
        return (f"{prefix}_x", f"{prefix}_y", f"{prefix}_z")

    agents = Agents(
        pos=per_agent_vec(xyz("pos")),
        orient=per_agent_vec(("quat_w", "quat_x", "quat_y", "quat_z")),
        action=per_agent_vec(ACTION_NAMES, gi),
        action_mask=per_agent_vec(("m_move", "m_grab", "m_pass", "m_shoot"),
                                  gi),
        reset=per_agent("reset", gi),
        reward=per_agent("reward"),
        done=per_agent("done"),
        has_ball=per_agent("has_ball", gi),
        held_ball_id=per_agent("held_ball", gi),
        points_worth=per_agent("points_worth", gi),
        team=per_agent("team", gi),
        team_color=per_agent_vec(("color_r", "color_g", "color_b")),
        defending_hoop=per_agent("defend_hoop", gi),
        stat_points=per_agent("stat_points"),
        stat_fouls=per_agent("stat_fouls"),
        obs=None if obs is None else
        obs.reshape(A, C.OBS_SIZE, W).permute(2, 0, 1),
    )
    ball = Ball(
        pos=torch.stack([gf(n) for n in ("bpos_x", "bpos_y", "bpos_z")], -1),
        vel=torch.stack([gf(n) for n in ("bvel_x", "bvel_y", "bvel_z")], -1),
        grabbed=gi("bgrabbed"), holder=gi("bholder"),
        in_flight=gi("binflight"), last_touched_agent=gi("blt_agent"),
        last_touched_team=gi("blt_team"), shot_by_agent=gi("bsb_agent"),
        shot_by_team=gi("bsb_team"), shot_point_value=gi("bspv"),
        shot_going_in=gi("bsgi"))
    game = GameState(
        inbounding_in_progress=gi("ginb"), live_ball=gi("glive"),
        period=gf("period"), team_in_possession=gf("tip"),
        team0_hoop=gi("t0hoop"), team0_score=gf("t0score"),
        team1_hoop=gi("t1hoop"), team1_score=gf("t1score"),
        game_clock=gf("gclock"), shot_clock=gf("sclock"),
        scored_baskets=gf("sbaskets"), oob_count=gf("oob"),
        inbound_clock=gf("iclock"), is_one_on_one=gi("is1v1"))
    # hoop geometry is fixed by the config (src/gen.cpp:96-156)
    court_start_x = (cfg.grid_width - C.COURT_LENGTH_M) / 2.0
    cy = cfg.grid_height / 2.0
    hoop_pos = torch.tensor(
        [[court_start_x + C.HOOP_FROM_BASELINE_M, cy, 0.0],
         [court_start_x + C.COURT_LENGTH_M - C.HOOP_FROM_BASELINE_M, cy,
          0.0]], dtype=torch.float32, device=sf.device).expand(W, 2, 3)
    return State(agents=agents, ball=ball, hoops=Hoops(pos=hoop_pos),
                 game=game)
