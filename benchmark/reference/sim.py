"""The plain sim tick of the reference: one step of the 19 systems over
the SoA field rows.

A frozen copy of the port's plain version
(`madrona_basketball_tpu_torch/ops/fused_step.py`, `step_fields` through
`step_rows_plain`), which transcribes the JAX package's `step_fields`
line for line.  It stays here unchanged when the port's copy changes, so
that the benchmark's yardstick does not move with the program it judges.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import constants as C
from .config import SimConfig
from . import tmath
from .layout import (AGENT_F32, AGENT_I32, BALL_F32, BALL_I32, F_IDX,
                     GAME_F32, GAME_I32, HOOP_F32, HOOP_I32, I_IDX,
                     N_F32_ROWS, N_I32_ROWS, N_NOISE_ROWS)

F32 = torch.float32
I32 = torch.int32
A = C.NUM_AGENTS
PLACEHOLDER = C.ENTITY_ID_PLACEHOLDER
DT = C.TIMESTEPS_TO_SECONDS_FACTOR
COS_PI_8 = math.cos(math.pi / 8.0)
TURN_W = math.cos(math.pi / 180.0 * 3.0)   # cos(6deg / 2)
TURN_Z = math.sin(math.pi / 180.0 * 3.0)   # sin(6deg / 2)

_S2 = 1.0 / math.sqrt(2.0)
MOVE_DIRS = ((0.0, -1.0), (_S2, -_S2), (1.0, 0.0), (_S2, _S2),
             (0.0, 1.0), (-_S2, _S2), (-1.0, 0.0), (-_S2, -_S2))

w = torch.where
FLT_MAX = float(np.finfo(np.float32).max)  # 3.4028235e38 rounded to f32


def _hoop_geometry(cfg: SimConfig):
    court_start_x = (cfg.grid_width - C.COURT_LENGTH_M) / 2.0
    cy = cfg.grid_height / 2.0
    return ((court_start_x + C.HOOP_FROM_BASELINE_M, cy),
            (court_start_x + C.COURT_LENGTH_M - C.HOOP_FROM_BASELINE_M, cy))


def _rsqrt_safe(x):
    return torch.rsqrt(torch.clamp(x, min=1e-30))


def _fma(a, b, c):
    """a * b + c rounded once to float32, a fused multiply-add: the float32
    product is exact in float64, so only the float64 sum rounds before the
    final rounding (the two disagree on ~2^-28 of inputs)."""
    return (a.double() * b.double() + c.double()).to(F32)


def shot_aim(ag, i, ax, ay, shot_noise):
    """System 6's aim for agent i at hoop (ax, ay): the shot direction
    (fvx, fvy), the distance along it to the hoop's nearest point t_along
    and the squared miss distance closest_sq = dist2 - t_along^2 (going in
    when t_along >= 0 and closest_sq <= ZONE_R^2).  shot_noise holds the
    agent's three shot-noise rows (distance, defender, velocity).

    The sums of products are fused multiply-adds where the JAX package's
    `fused_step_xla` contracts them on the CPU (XLA:CPU fuses one product
    of `p*q + r*s` into an FMA; found by probing each sum on threshold
    worlds, tests/test_torch_shot_xla.py).  XLA recomputes fvx inside the
    fusion of t_along and contracts the other product there, so t_along
    reads its own copy of fvx."""
    a = ag[i]
    ix = ax - a["pos_x"]
    iy = ay - a["pos_y"]
    dist2 = _fma(ix, ix, iy * iy)
    dist = torch.sqrt(dist2)
    inv = _rsqrt_safe(dist2)
    sin_i = w(dist > 0.0, ix * inv, 0.0)
    cos_i = w(dist > 0.0, iy * inv, 1.0)

    dev = shot_noise[0] * (C.DIST_DEVIATION_PER_METER * dist)
    d_def = torch.full_like(dist, math.inf)
    for j in range(A):
        is_def = ag[j]["team"] != a["team"]
        ddx = a["pos_x"] - ag[j]["pos_x"]
        ddy = a["pos_y"] - ag[j]["pos_y"]
        ddz = a["pos_z"] - ag[j]["pos_z"]
        dd = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
        d_def = w(is_def, torch.minimum(d_def, dd), d_def)
    dev = dev + w(d_def < 2.0,
                  shot_noise[1] *
                  (C.DEF_DEVIATION_PER_METER / (d_def + 0.1)), 0.0)
    vlen = torch.sqrt(a["vel_x"] ** 2 + a["vel_y"] ** 2 + a["vel_z"] ** 2)
    dev = dev + w(a["a_move"] > 0,
                  shot_noise[2] * (C.VEL_DEVIATION_FACTOR * vlen), 0.0)
    # (sin(i+dev), cos(i+dev)) by angle addition (src/game.cpp:302,345)
    sd, cd = torch.sin(dev), torch.cos(dev)
    fvx = _fma(sin_i, cd, cos_i * sd)
    fvy = _fma(cos_i, cd, -(sin_i * sd))
    t_along = _fma(ix, _fma(cos_i, sd, sin_i * cd), iy * fvy)
    return fvx, fvy, t_along, _fma(-t_along, t_along, dist2)


def _fwd_from_quat(qw, qx, qy, qz):
    """Rotate (0,1,0) by q - the only rotation the game applies."""
    fx = 2.0 * (qx * qy - qw * qz)
    fy = 1.0 - 2.0 * (qx * qx + qz * qz)
    fz = 2.0 * (qy * qz + qw * qx)
    return fx, fy, fz


def _rot_fwd_to(tx, ty):
    """Quat aligning (0,1,0) with the unit in-plane vector (tx, ty, 0)
    (src/helper.cpp:14-42 specialised; half-angle form, no acos)."""
    d = torch.clamp(ty, -1.0, 1.0)
    qw = torch.sqrt(torch.clamp((1.0 + d) * 0.5, min=0.0))
    qz = -torch.sign(tx) * torch.sqrt(torch.clamp((1.0 - d) * 0.5, min=0.0))
    qw = w(d > 0.999999, 1.0, w(d < -0.999999, 0.0, qw))
    qz = w(d > 0.999999, 0.0, w(d < -0.999999, 1.0, qz))
    return qw, qz


def _shot_point_value(px, py, hoop_xy, left_hoop: bool):
    """2 vs 3 points (src/helper.cpp:50-81); hoop position is static."""
    hx, hy = hoop_xy
    dx = px - hx
    dy = py - hy
    dist = torch.sqrt(dx * dx + dy * dy)
    in_corner = ((py < C.COURT_MIN_Y + C.CORNER_3_FROM_SIDELINE_M) |
                 (py > C.COURT_MIN_Y + C.COURT_WIDTH_M -
                  C.CORNER_3_FROM_SIDELINE_M))
    if left_hoop:
        corner3 = in_corner & (px <= C.COURT_MIN_X +
                               C.CORNER_3_LENGTH_FROM_BASELINE_M)
    else:
        corner3 = in_corner & (px >= C.COURT_MIN_X + C.COURT_LENGTH_M -
                               C.CORNER_3_LENGTH_FROM_BASELINE_M)
    return w(corner3 | (dist >= C.ARC_RADIUS_M), 3, 2).to(I32)


def _to_center(cfg, px, py):
    """Unit vector toward the grid start point (src/helper.cpp:44-48)."""
    dx = cfg.start_x - px
    dy = cfg.start_y - py
    inv = _rsqrt_safe(dx * dx + dy * dy)
    return dx * inv, dy * inv


def _assign_inbounder(ag, ball, game, active, new_team, spot_x, spot_y,
                      spot_z, qw, qz, is_oob: bool):
    """src/game.cpp:14-53 over field rows."""
    assigned = torch.zeros_like(active)
    for i in range(A):
        take = active & (ag[i]["team"] == new_team) & (~assigned)
        ag[i]["im_inb"] = w(take, 1, ag[i]["im_inb"])
        ag[i]["pos_x"] = w(take, spot_x, ag[i]["pos_x"])
        ag[i]["pos_y"] = w(take, spot_y, ag[i]["pos_y"])
        ag[i]["pos_z"] = w(take, spot_z, ag[i]["pos_z"])
        ag[i]["has_ball"] = w(take, 1, ag[i]["has_ball"])
        ag[i]["held_ball"] = w(take, C.BALL_ID, ag[i]["held_ball"])
        ag[i]["quat_w"] = w(take, qw, ag[i]["quat_w"])
        ag[i]["quat_x"] = w(take, 0.0, ag[i]["quat_x"])
        ag[i]["quat_y"] = w(take, 0.0, ag[i]["quat_y"])
        ag[i]["quat_z"] = w(take, qz, ag[i]["quat_z"])
        ball["bgrabbed"] = w(take, 1, ball["bgrabbed"])
        ball["bholder"] = w(take, C.AGENT_IDS[i], ball["bholder"])
        assigned = assigned | take
    found = active & assigned
    game["tip"] = w(found, new_team.to(F32), game["tip"])
    game["ginb"] = w(found, 1, game["ginb"])
    game["iclock"] = w(found, 5.0, game["iclock"])
    if is_oob:
        game["oob"] = game["oob"] + w(found, 1.0, 0.0)


def _setup_agent_positions(cfg, ag, game, noise):
    """src/helper.cpp:108-160 over field rows; returns the ball spawn."""
    one = game["is1v1"] == 1
    x_dev = noise["reset_x"] * C.START_POS_STDDEV
    y_dev = noise["reset_y"] * C.START_POS_STDDEV
    p0x = torch.clamp(cfg.start_x + x_dev, 0.0, cfg.grid_width)
    p0y = torch.clamp(cfg.start_y + y_dev, 0.0, cfg.grid_height)
    angle = noise["reset_angle"] * (2.0 * math.pi)
    p1x = torch.clamp(p0x + C.DEFENDER_SPAWN_RADIUS * torch.cos(angle),
                      0.0, cfg.grid_width)
    p1y = torch.clamp(p0y + C.DEFENDER_SPAWN_RADIUS * torch.sin(angle),
                      0.0, cfg.grid_height)
    for i in range(A):
        gx = cfg.start_x - 1.0 + 2.0 * (i % 2)
        gy = cfg.start_y - 2.0 + i // 2
        ag[i]["pos_x"] = w(one, p0x if i == 0 else p1x, gx)
        ag[i]["pos_y"] = w(one, p0y if i == 0 else p1y, gy)
        ag[i]["pos_z"] = torch.zeros_like(p0x)
        ag[i]["has_ball"] = torch.full_like(ag[i]["has_ball"],
                                            1 if i == 0 else 0)
        ag[i]["held_ball"] = torch.full_like(
            ag[i]["held_ball"], C.BALL_ID if i == 0 else PLACEHOLDER)
        ag[i]["points_worth"] = torch.full_like(ag[i]["points_worth"], 2)
        ag[i]["max_speed"] = torch.full_like(
            ag[i]["max_speed"], C.DEFAULT_SPEED - i * C.DEFENDER_SLOWDOWN)
        ag[i]["quickness"] = torch.ones_like(ag[i]["quickness"])
        ag[i]["shooting"] = torch.zeros_like(ag[i]["shooting"])
        ag[i]["ft_pct"] = torch.zeros_like(ag[i]["ft_pct"])
        ag[i]["reaction"] = torch.full_like(ag[i]["reaction"],
                                            i * C.DEFENDER_REACTION)
        ag[i]["target_x"] = ag[i]["pos_x"]
        ag[i]["target_y"] = ag[i]["pos_y"]
        ag[i]["target_z"] = ag[i]["pos_z"]
        ag[i]["shot_pct"] = torch.zeros_like(ag[i]["shot_pct"])
    spawn_x = w(one, ag[0]["pos_x"], cfg.start_x)
    spawn_y = w(one, ag[0]["pos_y"], cfg.start_y)
    return spawn_x, spawn_y


def _reset_world_fields(cfg, ag, ball, game, hoops, noise):
    """src/gen.cpp:216-316 over field rows; returns the candidate
    post-reset dicts (the caller selects per world on reset_now)."""
    ag = [dict(a) for a in ag]
    ball = dict(ball)
    game = dict(game)
    hoops = dict(hoops)

    rollover = (game["gclock"] <= 0.0) & (game["is1v1"] == 0)
    cont = (game["period"] < 4.0) | (game["t0score"] == game["t1score"])
    rc = rollover & cont

    def pick(roll_val, fresh_val):
        return w(rollover, roll_val, fresh_val)

    game["period"] = pick(w(rc, game["period"] + 1.0, game["period"]), 1.0)
    game["gclock"] = pick(w(rc, cfg.time_per_period, game["gclock"]),
                          cfg.time_per_period)
    game["sclock"] = pick(w(rc, cfg.shot_clock_duration, game["sclock"]),
                          cfg.shot_clock_duration)
    game["glive"] = pick(w(rc, 1, 0), 1).to(I32)
    game["ginb"] = pick(w(rc, 0, game["ginb"]), 0).to(I32)
    for n in ("tip", "t0score", "t1score", "sbaskets", "oob", "iclock"):
        game[n] = pick(game[n], 0.0)

    for i in range(A):
        a = ag[i]
        for n in ("a_move", "a_angle", "a_rotate", "a_grab", "a_pass",
                  "a_shoot", "m_move", "m_grab", "m_pass", "m_shoot",
                  "reset", "cur_step", "im_inb"):
            a[n] = torch.zeros_like(a[n])
        a["allowed_move"] = torch.ones_like(a["allowed_move"])
        a["done"] = torch.ones_like(a["done"])
        sign = -1.0 if i % 2 == 0 else 1.0
        a["quat_w"] = torch.full_like(a["quat_w"], math.cos(math.pi / 4))
        a["quat_x"] = torch.zeros_like(a["quat_x"])
        a["quat_y"] = torch.zeros_like(a["quat_y"])
        a["quat_z"] = torch.full_like(a["quat_z"],
                                      sign * math.sin(math.pi / 4))
        for n in ("cooldown", "stat_points", "stat_fouls", "vel_x", "vel_y",
                  "vel_z"):
            a[n] = torch.zeros_like(a[n])
        a["team"] = torch.full_like(a["team"], i % 2)
        col = C.RESET_TEAM_COLORS[i % 2]
        a["color_r"] = torch.full_like(a["color_r"], col[0])
        a["color_g"] = torch.full_like(a["color_g"], col[1])
        a["color_b"] = torch.full_like(a["color_b"], col[2])
        a["defend_hoop"] = (game["t0hoop"] if i % 2 == 0
                            else game["t1hoop"]).clone()

    spawn_x, spawn_y = _setup_agent_positions(cfg, ag, game, noise)

    ball["bpos_x"] = spawn_x
    ball["bpos_y"] = spawn_y
    ball["bpos_z"] = torch.zeros_like(spawn_x)
    ball["breset"] = torch.zeros_like(ball["breset"])
    ball["bdone"] = torch.ones_like(ball["bdone"])
    ball["bcur_step"] = torch.zeros_like(ball["bcur_step"])
    ball["binflight"] = torch.zeros_like(ball["binflight"])
    for n in ("blt_agent", "blt_team", "bsb_agent", "bsb_team"):
        ball[n] = torch.full_like(ball[n], PLACEHOLDER)
    ball["bspv"] = torch.full_like(ball["bspv"], 2)
    ball["bsgi"] = torch.zeros_like(ball["bsgi"])
    for n in ("bvel_x", "bvel_y", "bvel_z"):
        ball[n] = torch.zeros_like(ball[n])
    one = game["is1v1"] == 1
    ball["bgrabbed"] = w(one, 1, 0).to(I32)
    ball["bholder"] = w(one, C.AGENT_IDS[0], PLACEHOLDER).to(I32)

    for n in ("hdone0", "hdone1"):
        hoops[n] = torch.ones_like(hoops[n])
    for n in ("hcur0", "hcur1", "hreset0", "hreset1"):
        hoops[n] = torch.zeros_like(hoops[n])
    return ag, ball, game, hoops


def step_fields(cfg: SimConfig, ag, ball, game, hoops, noise,
                compute_obs: bool = True):
    """One full tick over field dicts; returns (ag, ball, game, hoops,
    obs_rows).  Transcribes madrona_basketball_tpu/ops/fused_step.py:272
    system by system.  compute_obs=False skips system 18 and returns no
    obs rows: no other system reads them, so the state is the same."""
    (h0x, h0y), (h1x, h1y) = _hoop_geometry(cfg)
    hoops_geom = ((h0x, h0y), (h1x, h1y))
    ZONE_R = C.HOOP_SCORE_ZONE_SIZE

    def att_hoop_xy(i):
        is0 = ag[i]["defend_hoop"] == C.HOOP_IDS[0]
        return w(is0, h1x, h0x), w(is0, h1y, h0y)

    def def_hoop_xy(i):
        is0 = ag[i]["defend_hoop"] == C.HOOP_IDS[0]
        return w(is0, h0x, h1x), w(is0, h0y, h1y)

    # ---------------- 1. tick (src/game.cpp:969-988) ----------------
    for a in ag:
        was = a["reset"] == 1
        a["reward"] = torch.zeros_like(a["reward"])
        a["done"] = w(was, 1.0, 0.0).to(F32)
        a["cur_step"] = w(was, 0, a["cur_step"] + 1)
        a["cooldown"] = torch.clamp(a["cooldown"] - 1.0, min=0.0)

    # ---------------- 2. actionMask (src/game.cpp:489-533) ----------------
    for a in ag:
        can_move = torch.ones_like(a["m_move"])
        can_grab = torch.ones_like(a["m_grab"])
        can_pass = w(a["has_ball"] == 1, 1, 0)
        can_shoot = w(a["has_ball"] == 1, 1, 0)
        inb = game["ginb"] == 1
        can_shoot = w(inb, 0, can_shoot)
        can_grab = w(inb, 0, can_grab)
        pinned = inb & (a["im_inb"] == 1) & (game["glive"] == 0)
        can_move = w(pinned, 0, can_move)
        can_grab = w(a["cooldown"] > 0.0, 0, can_grab)
        if cfg.tag_mode:
            can_pass = torch.zeros_like(can_pass)
            can_grab = torch.zeros_like(can_grab)
        a["m_move"], a["m_grab"] = can_move, can_grab
        a["m_pass"], a["m_shoot"] = can_pass, can_shoot

    # ---------------- 3. moveAgent (src/game.cpp:410-486) ----------------
    for a in ag:
        do_rot = a["a_rotate"] != 0
        tz = w(a["a_rotate"] == 1, TURN_Z, -TURN_Z)
        qw, qx, qy, qz = a["quat_w"], a["quat_x"], a["quat_y"], a["quat_z"]
        nqw = TURN_W * qw - tz * qz
        nqx = TURN_W * qx - tz * qy
        nqy = TURN_W * qy + tz * qx
        nqz = TURN_W * qz + tz * qw
        a["quat_w"] = w(do_rot, nqw, qw)
        a["quat_x"] = w(do_rot, nqx, qx)
        a["quat_y"] = w(do_rot, nqy, qy)
        a["quat_z"] = w(do_rot, nqz, qz)

        active = a["m_move"] != 0
        move_angle = a["a_angle"].to(F32) * C.ANGLE_BETWEEN_DIRECTIONS
        scale = a["quickness"] * a["a_move"].to(F32)
        dvx = torch.sin(move_angle) * scale
        dvy = -torch.cos(move_angle) * scale

        fx, fy, fz = _fwd_from_quat(a["quat_w"], a["quat_x"], a["quat_y"],
                                    a["quat_z"])
        vx, vy, vz = a["vel_x"], a["vel_y"], a["vel_z"]
        vlen2 = vx * vx + vy * vy + vz * vz
        inv = _rsqrt_safe(vlen2)
        dot = w(vlen2 > 1e-6, (vx * fx + vy * fy + vz * fz) * inv, 0.0)
        backwards = dot < -0.1
        sideways = (~backwards) & (dot <= 0.8)
        max_speed = a["max_speed"] * w(backwards, 0.1,
                                       w(sideways, 0.7, 1.0))
        dscale = w(backwards | sideways, 0.1, 1.0)
        vx = vx + dvx * dscale
        vy = vy + dvy * dscale
        max_speed = max_speed * w(a["has_ball"] == 1,
                                  C.BALL_AGENT_SLOWDOWN, 1.0)
        speed2 = vx * vx + vy * vy + vz * vz
        speed = torch.sqrt(speed2)
        shrink = w(speed > max_speed, max_speed * _rsqrt_safe(speed2), 1.0)
        vx, vy, vz = vx * shrink, vy * shrink, vz * shrink
        nx = torch.clamp(a["pos_x"] + vx * DT, 0.0, cfg.grid_width)
        ny = torch.clamp(a["pos_y"] + vy * DT, 0.0, cfg.grid_height)
        a["pos_x"] = w(active, nx, a["pos_x"])
        a["pos_y"] = w(active, ny, a["pos_y"])
        a["vel_x"] = w(active, vx * 0.95, a["vel_x"])
        a["vel_y"] = w(active, vy * 0.95, a["vel_y"])
        a["vel_z"] = w(active, vz * 0.95, a["vel_z"])

    # ---------------- 4. grab (src/game.cpp:164-239) ----------------
    for i in range(A):
        a = ag[i]
        aid = C.AGENT_IDS[i]
        act = (a["m_grab"] != 0) & (a["a_grab"] != 0)
        a["cooldown"] = w(act, 10.0, a["cooldown"])
        a["a_grab"] = w(act, 0, a["a_grab"])
        ball_act = act & (ball["binflight"] != 1)
        holding = (a["has_ball"] == 1) & (ball["bgrabbed"] == 1) & \
            (ball["bholder"] == aid)
        drop = ball_act & holding
        a["has_ball"] = w(drop, 0, a["has_ball"])
        a["held_ball"] = w(drop, PLACEHOLDER, a["held_ball"])
        ball["bgrabbed"] = w(drop, 0, ball["bgrabbed"])
        ball["bholder"] = w(drop, PLACEHOLDER, ball["bholder"])

        dx = ball["bpos_x"] - a["pos_x"]
        dy = ball["bpos_y"] - a["pos_y"]
        dz = ball["bpos_z"] - a["pos_z"]
        near = torch.sqrt(dx * dx + dy * dy + dz * dz) <= 0.3
        reach = ball_act & (~holding) & near
        turnover = reach & (game["is1v1"] == 1) & \
            (a["team"].to(F32) != game["tip"])
        game["reset_now"] = w(turnover, 1, game["reset_now"])
        take = reach & (~turnover)
        for j in range(A):
            victim = take & (ag[j]["held_ball"] == C.BALL_ID)
            ag[j]["has_ball"] = w(victim, 0, ag[j]["has_ball"])
            ag[j]["held_ball"] = w(victim, PLACEHOLDER, ag[j]["held_ball"])
            ag[j]["cooldown"] = w(victim, C.SIMULATION_HZ,
                                  ag[j]["cooldown"])
        a["has_ball"] = w(take, 1, a["has_ball"])
        a["held_ball"] = w(take, C.BALL_ID, a["held_ball"])
        ball["bholder"] = w(take, aid, ball["bholder"])
        ball["bgrabbed"] = w(take, 1, ball["bgrabbed"])
        ball["binflight"] = w(take, 0, ball["binflight"])
        for n in ("bvel_x", "bvel_y", "bvel_z"):
            ball[n] = w(take, 0.0, ball[n])
        ball["bsb_agent"] = w(take, PLACEHOLDER, ball["bsb_agent"])
        ball["bsb_team"] = w(take, PLACEHOLDER, ball["bsb_team"])
        ball["bspv"] = w(take, 2, ball["bspv"])
        game["tip"] = w(take, a["team"].to(F32), game["tip"])
        game["glive"] = w(take, 1, game["glive"])

    # ---------------- 5. pass (src/game.cpp:243-270) ----------------
    for i in range(A):
        a = ag[i]
        act = (a["m_pass"] != 0) & (a["a_pass"] != 0)
        hold = act & (ball["bholder"] == C.AGENT_IDS[i])
        a["has_ball"] = w(hold, 0, a["has_ball"])
        a["held_ball"] = w(hold, PLACEHOLDER, a["held_ball"])
        a["im_inb"] = w(hold, 0, a["im_inb"])
        fx, fy, fz = _fwd_from_quat(a["quat_w"], a["quat_x"], a["quat_y"],
                                    a["quat_z"])
        ball["bgrabbed"] = w(hold, 0, ball["bgrabbed"])
        ball["bholder"] = w(hold, PLACEHOLDER, ball["bholder"])
        ball["bvel_x"] = w(hold, fx * 0.1, ball["bvel_x"])
        ball["bvel_y"] = w(hold, fy * 0.1, ball["bvel_y"])
        ball["bvel_z"] = w(hold, fz * 0.1, ball["bvel_z"])
        game["ginb"] = w(hold, 0, game["ginb"])

    # ---------------- 6. shoot (src/game.cpp:273-407) ----------------
    for i in range(A):
        a = ag[i]
        aid = C.AGENT_IDS[i]
        act = (a["m_shoot"] != 0) & (a["a_shoot"] != 0)
        ax, ay = att_hoop_xy(i)
        fvx, fvy, t_along, closest_sq = shot_aim(ag, i, ax, ay,
                                                 noise["shot"][i])
        going_in = (~(t_along < 0.0)) & (closest_sq <= ZONE_R * ZONE_R)

        sqw, sqz = _rot_fwd_to(fvx, fvy)
        a["quat_w"] = w(act, sqw, a["quat_w"])
        a["quat_x"] = w(act, 0.0, a["quat_x"])
        a["quat_y"] = w(act, 0.0, a["quat_y"])
        a["quat_z"] = w(act, sqz, a["quat_z"])

        hold = act & (ball["bholder"] == aid)
        is0 = ag[i]["defend_hoop"] == C.HOOP_IDS[0]
        spv = w(is0,
                _shot_point_value(a["pos_x"], a["pos_y"], hoops_geom[1],
                                  left_hoop=False),
                _shot_point_value(a["pos_x"], a["pos_y"], hoops_geom[0],
                                  left_hoop=True))
        made = hold & going_in
        game["sbaskets"] = game["sbaskets"] + w(made, 1.0, 0.0)
        a["reward"] = a["reward"] + w(hold & (~going_in), -1.0, 0.0)
        a["has_ball"] = w(hold, 0, a["has_ball"])
        a["held_ball"] = w(hold, PLACEHOLDER, a["held_ball"])
        a["im_inb"] = w(hold, 0, a["im_inb"])
        ball["bsgi"] = w(made, 1, ball["bsgi"])
        ball["bgrabbed"] = w(hold, 0, ball["bgrabbed"])
        ball["bholder"] = w(hold, PLACEHOLDER, ball["bholder"])
        ball["bvel_x"] = w(hold, fvx * 0.1, ball["bvel_x"])
        ball["bvel_y"] = w(hold, fvy * 0.1, ball["bvel_y"])
        ball["bvel_z"] = w(hold, 0.0, ball["bvel_z"])
        ball["binflight"] = w(hold, 1, ball["binflight"])
        ball["bsb_agent"] = w(hold, aid, ball["bsb_agent"])
        ball["bsb_team"] = w(hold, a["team"], ball["bsb_team"])
        ball["bspv"] = w(hold, spv, ball["bspv"])
        ball["blt_agent"] = w(hold, aid, ball["blt_agent"])
        ball["blt_team"] = w(hold, a["team"], ball["blt_team"])

    # ---------------- 7. moveBall (src/game.cpp:82-125) ----------------
    for i in range(A):
        holding = (ag[i]["has_ball"] == 1) & (ball["bgrabbed"] == 1) & \
            (ball["bholder"] == C.AGENT_IDS[i])
        ball["bpos_x"] = w(holding, ag[i]["pos_x"], ball["bpos_x"])
        ball["bpos_y"] = w(holding, ag[i]["pos_y"], ball["bpos_y"])
        ball["bpos_z"] = w(holding, ag[i]["pos_z"], ball["bpos_z"])
    bvlen = torch.sqrt(ball["bvel_x"] ** 2 + ball["bvel_y"] ** 2 +
                       ball["bvel_z"] ** 2)
    free = (bvlen != 0.0) & (ball["bgrabbed"] != 1)
    ball["bpos_x"] = w(free, torch.clamp(ball["bpos_x"] + ball["bvel_x"],
                                         0.0, cfg.grid_width),
                       ball["bpos_x"])
    ball["bpos_y"] = w(free, torch.clamp(ball["bpos_y"] + ball["bvel_y"],
                                         0.0, cfg.grid_height),
                       ball["bpos_y"])
    ball["bpos_z"] = w(free, ball["bpos_z"] + ball["bvel_z"],
                       ball["bpos_z"])

    # -------- 8. updateCurrentShotPercentage (src/game.cpp:758-809) -------
    for i in range(A):
        a = ag[i]
        ax, ay = att_hoop_xy(i)
        dx = ax - a["pos_x"]
        dy = ay - a["pos_y"]
        dist_hoop = torch.sqrt(dx * dx + dy * dy)
        d_def = torch.full_like(dist_hoop, math.inf)
        for j in range(A):
            is_def = ag[j]["team"] != a["team"]
            ddx = a["pos_x"] - ag[j]["pos_x"]
            ddy = a["pos_y"] - ag[j]["pos_y"]
            dd = torch.sqrt(ddx * ddx + ddy * ddy)
            d_def = w(is_def, torch.minimum(d_def, dd), d_def)
        dist_sd = C.DIST_DEVIATION_PER_METER * dist_hoop
        def_sd = C.DEF_DEVIATION_PER_METER / d_def + 1e-4
        vel_sd = C.VEL_DEVIATION_FACTOR * torch.sqrt(
            a["vel_x"] ** 2 + a["vel_y"] ** 2 + a["vel_z"] ** 2)
        final_sd = torch.sqrt(dist_sd * dist_sd / 3.0 +
                              def_sd * def_sd / 3.0 +
                              vel_sd * vel_sd / 3.0)
        max_make = tmath.atan(ZONE_R / dist_hoop)
        pct = tmath.erf(max_make / final_sd / math.sqrt(2.0))
        a["shot_pct"] = w(a["has_ball"] == 0, 0.0, pct)

    # ---------------- 9. score (src/game.cpp:873-953) ----------------
    for hi, (hx, hy) in enumerate(hoops_geom):
        hid = C.HOOP_IDS[hi]
        dx = ball["bpos_x"] - hx
        dy = ball["bpos_y"] - hy
        scored = (torch.sqrt(dx * dx + dy * dy) <= ZONE_R) & \
            (ball["binflight"] == 1)
        points = ball["bspv"]
        inb_team = torch.zeros_like(ball["bspv"])
        for j in range(A):
            defends = ag[j]["defend_hoop"] == hid
            inb_team = w(defends, ag[j]["team"], inb_team)
            shooter = scored & (C.AGENT_IDS[j] == ball["bsb_agent"])
            delta = w(defends, -points, points).to(F32)
            ag[j]["stat_points"] = ag[j]["stat_points"] + \
                w(shooter, delta, 0.0)
        is_t0 = game["t0hoop"] == hid
        game["t1score"] = game["t1score"] + \
            w(scored & is_t0, points.to(F32), 0.0)
        game["t0score"] = game["t0score"] + \
            w(scored & (~is_t0), points.to(F32), 0.0)
        game["sbaskets"] = game["sbaskets"] + w(scored, 1.0, 0.0)
        spot_x = w(is_t0, C.COURT_MIN_X, C.COURT_MAX_X).to(F32)
        spot_y = torch.full_like(spot_x, hy + C.PIXELS_PER_METER / 60.0)
        ball["binflight"] = w(scored, 0, ball["binflight"])
        for n in ("bvel_x", "bvel_y", "bvel_z"):
            ball[n] = w(scored, 0.0, ball[n])
        ball["bsb_agent"] = w(scored, PLACEHOLDER, ball["bsb_agent"])
        ball["bsb_team"] = w(scored, PLACEHOLDER, ball["bsb_team"])
        ball["bspv"] = w(scored, 2, ball["bspv"])
        ball["bsgi"] = w(scored, 0, ball["bsgi"])
        full = scored & (game["is1v1"] == 0)
        ball["bpos_x"] = w(full, spot_x, ball["bpos_x"])
        ball["bpos_y"] = w(full, spot_y, ball["bpos_y"])
        ball["bpos_z"] = w(full, 0.0, ball["bpos_z"])
        cx, cy2 = _to_center(cfg, spot_x, spot_y)
        qw, qz = _rot_fwd_to(cx, cy2)
        _assign_inbounder(ag, ball, game, full, inb_team, spot_x, spot_y,
                          torch.zeros_like(spot_x), qw, qz, is_oob=False)
        one = scored & (game["is1v1"] != 0)
        game["reset_now"] = w(one, 1, game["reset_now"])

    # ---------------- 10. outOfBounds (src/game.cpp:1055-1113) ------------
    oob = ((ball["bpos_x"] < C.COURT_MIN_X) |
           (ball["bpos_x"] > C.COURT_MAX_X) |
           (ball["bpos_y"] < C.COURT_MIN_Y) |
           (ball["bpos_y"] > C.COURT_MAX_Y))
    trigger = oob & (game["ginb"] == 0)
    one = trigger & (game["is1v1"] == 1)
    off1 = ag[1]["team"].to(F32) == game["tip"]
    pen = w(one, -100.0, 0.0)
    ag[0]["reward"] = ag[0]["reward"] + w(off1, 0.0, pen)
    ag[1]["reward"] = ag[1]["reward"] + w(off1, pen, 0.0)
    game["reset_now"] = w(one, 1, game["reset_now"])

    full = trigger & (game["is1v1"] != 1)
    ball["binflight"] = w(full, 0, ball["binflight"])
    for n in ("bvel_x", "bvel_y", "bvel_z"):
        ball[n] = w(full, 0.0, ball[n])
    game["glive"] = w(full, 0, game["glive"])
    new_team = (1 - ball["blt_team"]).to(I32)
    for i in range(A):
        a = ag[i]
        carrier = full & (a["has_ball"] == 1) & (a["held_ball"] == C.BALL_ID)
        cx, cy2 = _to_center(cfg, a["pos_x"], a["pos_y"])
        a["pos_x"] = w(carrier, a["pos_x"] + cx, a["pos_x"])
        a["pos_y"] = w(carrier, a["pos_y"] + cy2, a["pos_y"])
        a["has_ball"] = w(carrier, 0, a["has_ball"])
        a["held_ball"] = w(carrier, PLACEHOLDER, a["held_ball"])
    cx, cy2 = _to_center(cfg, ball["bpos_x"], ball["bpos_y"])
    qw, qz = _rot_fwd_to(cx, cy2)
    _assign_inbounder(ag, ball, game, full, new_team, ball["bpos_x"],
                      ball["bpos_y"], ball["bpos_z"], qw, qz, is_oob=True)

    # ---------------- 11. updateLastTouch (src/game.cpp:1034-1051) --------
    for i in range(A):
        dx = ball["bpos_x"] - ag[i]["pos_x"]
        dy = ball["bpos_y"] - ag[i]["pos_y"]
        dz = ball["bpos_z"] - ag[i]["pos_z"]
        touch = torch.sqrt(dx * dx + dy * dy + dz * dz) <= C.AGENT_SIZE_M
        ball["blt_agent"] = w(touch, C.AGENT_IDS[i], ball["blt_agent"])
        ball["blt_team"] = w(touch, ag[i]["team"], ball["blt_team"])

    # ---------------- 12. clock (src/game.cpp:992-1030) ----------------
    run = (game["glive"] > 0) & (game["gclock"] > 0.0)
    game["gclock"] = w(run, game["gclock"] - DT, game["gclock"])
    game["sclock"] = w(run, game["sclock"] - DT, game["sclock"])
    game["iclock"] = w(game["ginb"] > 0, game["iclock"] - DT,
                       game["iclock"])
    expire = (game["gclock"] <= 0.0) & (game["glive"] > 0)
    off1 = ag[1]["team"].to(F32) == game["tip"]
    bonus = w(expire, 10.0, 0.0)
    ag[0]["reward"] = ag[0]["reward"] + w(off1, 0.0, bonus)
    ag[1]["reward"] = ag[1]["reward"] + w(off1, bonus, 0.0)
    game["reset_now"] = w(expire, 1, game["reset_now"])
    game["sclock"] = w(game["sclock"] < 0.0, 0.0, game["sclock"])

    # -------- 13. inboundViolation (src/game.cpp:1116-1157) --------
    trig = (game["ginb"] > 0) & (game["iclock"] <= 0.0)
    new_team = (1 - game["tip"].to(I32)).to(I32)
    game["glive"] = w(trig, 0, game["glive"])
    ball_to_turnover = torch.full_like(ball["bholder"], PLACEHOLDER)
    for i in range(A):
        a = ag[i]
        was = trig & (a["im_inb"] > 0)
        ball_to_turnover = w(was, a["held_ball"], ball_to_turnover)
        cx, cy2 = _to_center(cfg, a["pos_x"], a["pos_y"])
        a["im_inb"] = w(was, 0, a["im_inb"])
        a["has_ball"] = w(was, 0, a["has_ball"])
        a["held_ball"] = w(was, PLACEHOLDER, a["held_ball"])
        a["pos_x"] = w(was, a["pos_x"] + cx, a["pos_x"])
        a["pos_y"] = w(was, a["pos_y"] + cy2, a["pos_y"])
    do_t = trig & (ball_to_turnover == C.BALL_ID)
    ball["bgrabbed"] = w(do_t, 0, ball["bgrabbed"])
    ball["bholder"] = w(do_t, PLACEHOLDER, ball["bholder"])
    cx, cy2 = _to_center(cfg, ball["bpos_x"], ball["bpos_y"])
    qw, qz = _rot_fwd_to(cx, cy2)
    _assign_inbounder(ag, ball, game, do_t, new_team, ball["bpos_x"],
                      ball["bpos_y"], ball["bpos_z"], qw, qz, is_oob=True)

    # ---------------- 14. reset (src/game.cpp:957-967) ----------------
    do = game["reset_now"] == 1
    r_ag, r_ball, r_game, r_hoops = _reset_world_fields(
        cfg, ag, ball, game, hoops, noise)
    for i in range(A):
        for k in ag[i]:
            ag[i][k] = w(do, r_ag[i][k], ag[i][k])
    for k in ball:
        ball[k] = w(do, r_ball[k], ball[k])
    for k in game:
        game[k] = w(do, r_game[k], game[k])
    for k in hoops:
        hoops[k] = w(do, r_hoops[k], hoops[k])
    game["reset_now"] = w(do, 0, game["reset_now"])

    # -------- 15. updatePointsWorth (src/game.cpp:129-161) --------
    for i in range(A):
        is0 = ag[i]["defend_hoop"] == C.HOOP_IDS[0]
        ag[i]["points_worth"] = w(
            is0,
            _shot_point_value(ag[i]["pos_x"], ag[i]["pos_y"],
                              hoops_geom[1], left_hoop=False),
            _shot_point_value(ag[i]["pos_x"], ag[i]["pos_y"],
                              hoops_geom[0], left_hoop=True))

    # -------- 16. agentCollision (src/game.cpp:537-648) --------
    def rect_axes(a):
        fx, fy, _ = _fwd_from_quat(a["quat_w"], a["quat_x"], a["quat_y"],
                                   a["quat_z"])
        return fx, fy, fy, -fx

    fxa, fya, rxa, rya = rect_axes(ag[0])
    fxb, fyb, rxb, ryb = rect_axes(ag[1])
    HW = C.AGENT_SHOULDER_WIDTH / 2.0
    HD = C.AGENT_DEPTH / 2.0

    def corners(cx, cy, fx, fy, rx, ry):
        # (-d+w, -d-w, +d-w, +d+w), matching src/game.cpp:564-569
        return ((cx - fx * HD + rx * HW, cy - fy * HD + ry * HW),
                (cx - fx * HD - rx * HW, cy - fy * HD - ry * HW),
                (cx + fx * HD - rx * HW, cy + fy * HD - ry * HW),
                (cx + fx * HD + rx * HW, cy + fy * HD + ry * HW))

    va = corners(ag[0]["pos_x"], ag[0]["pos_y"], fxa, fya, rxa, rya)
    vb = corners(ag[1]["pos_x"], ag[1]["pos_y"], fxb, fyb, rxb, ryb)

    def norm_axis(x, y):
        inv = _rsqrt_safe(x * x + y * y)
        return x * inv, y * inv

    axes = [norm_axis(rxa, rya), norm_axis(fxa, fya),
            norm_axis(rxb, ryb), norm_axis(fxb, fyb)]
    colliding = torch.ones_like(fxa, dtype=torch.bool)
    min_ov = torch.full_like(fxa, FLT_MAX)
    mtv_x = torch.zeros_like(fxa)
    mtv_y = torch.zeros_like(fxa)
    for axx, axy in axes:
        pa = [cx * axx + cy * axy for cx, cy in va]
        pb = [cx * axx + cy * axy for cx, cy in vb]
        pa_min = torch.minimum(torch.minimum(pa[0], pa[1]),
                               torch.minimum(pa[2], pa[3]))
        pa_max = torch.maximum(torch.maximum(pa[0], pa[1]),
                               torch.maximum(pa[2], pa[3]))
        pb_min = torch.minimum(torch.minimum(pb[0], pb[1]),
                               torch.minimum(pb[2], pb[3]))
        pb_max = torch.maximum(torch.maximum(pb[0], pb[1]),
                               torch.maximum(pb[2], pb[3]))
        colliding = colliding & (pa_max > pb_min) & (pb_max > pa_min)
        overlap = torch.minimum(pa_max, pb_max) - torch.maximum(pa_min,
                                                                pb_min)
        smaller = overlap < min_ov
        min_ov = w(smaller, overlap, min_ov)
        mtv_x = w(smaller, axx, mtv_x)
        mtv_y = w(smaller, axy, mtv_y)
    if cfg.tag_mode:
        hit = colliding & (game["tip"] == ag[0]["team"].to(F32))
        ag[0]["reward"] = ag[0]["reward"] + w(hit, -10.0, 0.0)
        ag[1]["reward"] = ag[1]["reward"] + w(hit, 10.0, 0.0)
        game["reset_now"] = w(hit, 1, game["reset_now"])
    c2cx = ag[1]["pos_x"] - ag[0]["pos_x"]
    c2cy = ag[1]["pos_y"] - ag[0]["pos_y"]
    flip = (c2cx * mtv_x + c2cy * mtv_y) < 0.0
    mtv_x = w(flip, -mtv_x, mtv_x)
    mtv_y = w(flip, -mtv_y, mtv_y)
    corr_x = mtv_x * min_ov * 0.5
    corr_y = mtv_y * min_ov * 0.5
    ag[0]["pos_x"] = w(colliding, ag[0]["pos_x"] - corr_x, ag[0]["pos_x"])
    ag[0]["pos_y"] = w(colliding, ag[0]["pos_y"] - corr_y, ag[0]["pos_y"])
    ag[1]["pos_x"] = w(colliding, ag[1]["pos_x"] + corr_x, ag[1]["pos_x"])
    ag[1]["pos_y"] = w(colliding, ag[1]["pos_y"] + corr_y, ag[1]["pos_y"])

    # -------- 17. hardCodeDefense (src/game.cpp:651-755) --------
    for i in range(A):
        a = ag[i]
        on_off = game["tip"] == a["team"].to(F32)
        found = torch.zeros_like(on_off)
        off_x = torch.zeros_like(a["pos_x"])
        off_y = torch.zeros_like(a["pos_y"])
        for j in range(A):
            hit = (ag[j]["has_ball"] == 1) & (~found)
            off_x = w(hit, ag[j]["pos_x"], off_x)
            off_y = w(hit, ag[j]["pos_y"], off_y)
            found = found | hit
        is0 = a["defend_hoop"] == C.HOOP_IDS[0]
        mhx = w(is0, h0x, h1x)
        mhy = w(is0, h0y, h1y)
        hdx = mhx - off_x
        hdy = mhy - off_y
        hlen2 = hdx * hdx + hdy * hdy
        inv = _rsqrt_safe(hlen2)
        gx = w(hlen2 > 1e-6, off_x + C.GUARDING_DISTANCE * hdx * inv, off_x)
        gy = w(hlen2 > 1e-6, off_y + C.GUARDING_DISTANCE * hdy * inv, off_y)
        chase = (~on_off) & found
        interp = a["reaction"] * DT
        tx = w(chase, a["target_x"] + (gx - a["target_x"]) * interp,
               a["target_x"])
        ty = w(chase, a["target_y"] + (gy - a["target_y"]) * interp,
               a["target_y"])
        mvx = tx - a["pos_x"]
        mvy = ty - a["pos_y"]
        mvz = a["target_z"] - a["pos_z"]
        small = (mvx * mvx + mvy * mvy + mvz * mvz) < 0.01
        act_move = chase & (~small)
        dinv = _rsqrt_safe(mvx * mvx + mvy * mvy + mvz * mvz)
        dx_n = mvx * dinv
        dy_n = mvy * dinv
        best = torch.zeros_like(a["a_angle"])
        max_dot = torch.full_like(dx_n, -2.0)
        for k, (ddx, ddy) in enumerate(MOVE_DIRS):
            cur = dx_n * ddx + dy_n * ddy
            better = cur > max_dot
            max_dot = w(better, cur, max_dot)
            best = w(better, k, best)
        ovx, ovy, _ = _fwd_from_quat(a["quat_w"], a["quat_x"], a["quat_y"],
                                     a["quat_z"])
        # acos(dot) > pi/8  <=>  dot < cos(pi/8)
        big_angle = (ovx * dx_n + ovy * dy_n) < COS_PI_8
        cross = ovx * mvy - ovy * mvx
        rot = w(cross < 0.0, -1, w(cross > 0.0, 1, 0)).to(I32)
        rot = w(big_angle, rot, 0)
        move = w(on_off, 0, w(~found, 0, w(small, 0, 1))).to(I32)
        a["a_move"] = move
        a["a_angle"] = w(act_move, best, a["a_angle"])
        a["a_rotate"] = w(act_move, rot, a["a_rotate"])
        a["a_grab"] = w(on_off, a["a_grab"], 1)
        a["target_x"] = tx
        a["target_y"] = ty

    # -------- 18. fillObservations (src/game.cpp:1175-1461) --------
    if not compute_obs:
        _reward_fields(ag, ball, game)
        return ag, ball, game, hoops, []

    inbounder = torch.full_like(ball["bholder"], -1)
    for j in range(A):
        inbounder = w(ag[j]["im_inb"] > 0, C.AGENT_IDS[j], inbounder)

    def agent_block(tgt, hoop_x, hoop_y, self_block, rel_to=None):
        """The 38-float per-agent block; returns a list of (W,) rows."""
        rows = [tgt["pos_x"], tgt["pos_y"], tgt["pos_z"]]
        if self_block:
            z = torch.zeros_like(tgt["pos_x"])
            rows += [z, z, z, z]
        else:
            rx = tgt["pos_x"] - rel_to["pos_x"]
            ry = tgt["pos_y"] - rel_to["pos_y"]
            rz = tgt["pos_z"] - rel_to["pos_z"]
            r2 = rx * rx + ry * ry + rz * rz
            inv = _rsqrt_safe(r2)
            ok = r2 > 1e-6
            rows += [w(ok, rx * inv, 0.0), w(ok, ry * inv, 0.0),
                     w(ok, rz * inv, 0.0), torch.sqrt(r2)]
        rows += [tgt["quat_w"], tgt["quat_x"], tgt["quat_y"], tgt["quat_z"]]
        ox, oy, oz = _fwd_from_quat(tgt["quat_w"], tgt["quat_x"],
                                    tgt["quat_y"], tgt["quat_z"])
        rows += [ox, oy, oz]
        vx, vy, vz = tgt["vel_x"], tgt["vel_y"], tgt["vel_z"]
        v2 = vx * vx + vy * vy + vz * vz
        inv = _rsqrt_safe(v2)
        okv = v2 > 1e-6
        vnx, vny, vnz = (w(okv, vx * inv, 0.0), w(okv, vy * inv, 0.0),
                         w(okv, vz * inv, 0.0))
        rows += [vnx, vny, vnz, torch.sqrt(v2)]
        dot = w(okv, vnx * ox + vny * oy + vnz * oz, 0.0)
        rows += [dot, w(dot <= 0.8, 0.1, 1.0)]
        hdx = hoop_x - tgt["pos_x"]
        hdy = hoop_y - tgt["pos_y"]
        hdz = -tgt["pos_z"]
        h2 = hdx * hdx + hdy * hdy + hdz * hdz
        hd = torch.sqrt(h2)
        inv = _rsqrt_safe(h2)
        okh = hd > 1e-6
        rows += [w(okh, hdx * inv, 0.0), w(okh, hdy * inv, 0.0),
                 w(okh, hdz * inv, 0.0), hd]
        bdx = ball["bpos_x"] - tgt["pos_x"]
        bdy = ball["bpos_y"] - tgt["pos_y"]
        bdz = ball["bpos_z"] - tgt["pos_z"]
        b2 = bdx * bdx + bdy * bdy + bdz * bdz
        bd = torch.sqrt(b2)
        inv = _rsqrt_safe(b2)
        okb = bd > 1e-6
        rows += [w(okb, bdx * inv, 0.0), w(okb, bdy * inv, 0.0),
                 w(okb, bdz * inv, 0.0), bd]
        rows += [tgt["im_inb"].to(F32), tgt["cooldown"],
                 tgt["max_speed"], tgt["quickness"], tgt["shooting"],
                 tgt["ft_pct"], tgt["reaction"], tgt["shot_pct"],
                 tgt["points_worth"].to(F32), tgt["has_ball"].to(F32)]
        return rows

    obs_rows = []
    zero = torch.zeros_like(ball["bpos_x"])
    for i in range(A):
        a = ag[i]
        ax, ay = att_hoop_xy(i)
        dx_, dy_ = def_hoop_xy(i)
        own0 = a["team"] == 0
        rows = [game["gclock"], game["sclock"], game["period"],
                game["ginb"].to(F32), game["iclock"],
                w(own0, game["t0score"], game["t1score"]),
                w(own0, game["t1score"], game["t0score"]),
                ball["bpos_x"], ball["bpos_y"], ball["bpos_z"],
                ball["bvel_x"], ball["bvel_y"], ball["bvel_z"],
                ball["bgrabbed"].to(F32), ball["binflight"].to(F32),
                ball["bspv"].to(F32), ball["blt_team"].to(F32),
                ax.to(F32), ay.to(F32), zero, dx_.to(F32), dy_.to(F32),
                zero]
        rows += agent_block(a, ax, ay, self_block=True)
        for j in range(A):
            if j != i:
                rows += agent_block(ag[j], dx_, dy_, self_block=False,
                                    rel_to=a)
        for j in range(A):
            rows.append((ball["bholder"] == C.AGENT_IDS[j]).to(F32))
        for j in range(A):
            rows.append((inbounder == C.AGENT_IDS[j]).to(F32))
        assert len(rows) == C.OBS_USED
        rows += [zero] * (C.OBS_SIZE - C.OBS_USED)
        obs_rows.extend(rows)

    # ---------------- 19. reward (src/game.cpp:811-870) ----------------
    _reward_fields(ag, ball, game)
    return ag, ball, game, hoops, obs_rows


def _reward_fields(ag, ball, game):
    """System 19 (src/game.cpp:811-870) over field rows; mutates ag."""
    for i in range(A):
        a = ag[i]
        o = ag[1 - i]
        ddx = o["pos_x"] - a["pos_x"]
        ddy = o["pos_y"] - a["pos_y"]
        ddz = o["pos_z"] - a["pos_z"]
        dist_other = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
        on_off = a["team"].to(F32) == game["tip"]
        off_act = on_off & (game["gclock"] > 5.0)
        mine = ball["bsb_agent"] == C.AGENT_IDS[i]
        made = mine & (ball["bsgi"] == 1)
        missing = mine & (ball["bsgi"] == 0) & (ball["binflight"] == 1)
        r = a["reward"]
        r = r + w(off_act & made, ball["bspv"].to(F32), 0.0)
        r = r - w(off_act & missing, 1.0, 0.0)
        r = r + w(off_act, a["shot_pct"], 0.0)
        r = r + w(~on_off, -1.0 + torch.exp(-0.4 * dist_other), 0.0)
        a["reward"] = r


# =====================================================================
# Rows <-> field dicts
# =====================================================================

def load_dicts(sf, si):
    """Rows of SF/SI -> field dicts of (W,) views."""
    ag = []
    for i in range(A):
        d = {n: sf[F_IDX[f"a{i}.{n}"]] for n in AGENT_F32}
        d.update({n: si[I_IDX[f"a{i}.{n}"]] for n in AGENT_I32})
        ag.append(d)
    ball = {n: sf[F_IDX[n]] for n in BALL_F32}
    ball.update({n: si[I_IDX[n]] for n in BALL_I32})
    game = {n: sf[F_IDX[n]] for n in GAME_F32}
    game.update({n: si[I_IDX[n]] for n in GAME_I32})
    hoops = {n: sf[F_IDX[n]] for n in HOOP_F32}
    hoops.update({n: si[I_IDX[n]] for n in HOOP_I32})
    return ag, ball, game, hoops


def noise_dict(noise):
    return {
        "shot": [[noise[3 * i + k] for k in range(3)] for i in range(A)],
        "reset_x": noise[3 * A + 0],
        "reset_y": noise[3 * A + 1],
        "reset_angle": noise[3 * A + 2],
    }


def store_rows(ag, ball, game, hoops):
    W = ball["bpos_x"].shape[0]
    dev = ball["bpos_x"].device
    sf = torch.empty((N_F32_ROWS, W), dtype=F32, device=dev)
    si = torch.empty((N_I32_ROWS, W), dtype=I32, device=dev)
    for i in range(A):
        for n in AGENT_F32:
            sf[F_IDX[f"a{i}.{n}"]] = ag[i][n]
        for n in AGENT_I32:
            si[I_IDX[f"a{i}.{n}"]] = ag[i][n]
    for group in (ball, game, hoops):
        for n, v in group.items():
            if n in F_IDX:
                sf[F_IDX[n]] = v
            else:
                si[I_IDX[n]] = v
    return sf, si


def step_rows_plain(cfg: SimConfig, sf: torch.Tensor, si: torch.Tensor,
                    noise: torch.Tensor, compute_obs: bool = True):
    """Plain torch tick: (sf (72,W) f32, si (59,W) i32, noise (9,W) f32)
    -> (sf', si', obs (256,W) f32).  Same contract as the JAX
    `fused_step_xla` (madrona_basketball_tpu/ops/fused_step.py:996).
    With compute_obs=False obs is None."""
    ag, ball, game, hoops = load_dicts(sf, si)
    ag = [dict(a) for a in ag]
    ag, ball, game, hoops, obs = step_fields(cfg, ag, dict(ball),
                                             dict(game), dict(hoops),
                                             noise_dict(noise), compute_obs)
    sf2, si2 = store_rows(ag, ball, game, hoops)
    return sf2, si2, torch.stack(obs) if compute_obs else None


# =====================================================================
# Parity inputs at the shot's going-in threshold
# =====================================================================

SHOT_BAND_ULPS = 4  # "near the threshold": |closest_sq - ZONE_R^2| in ulps


def check_rows(sf, si, W=None):
    W = sf.shape[1] if W is None else W
    if sf.shape != (N_F32_ROWS, W) or sf.dtype != F32:
        raise ValueError(f"sf must be ({N_F32_ROWS}, {W}) float32")
    if si.shape != (N_I32_ROWS, W) or si.dtype != I32:
        raise ValueError(f"si must be ({N_I32_ROWS}, {W}) int32")
    return W


def draw_noise_rows(num_worlds: int, gen: torch.Generator,
                    device="cuda") -> torch.Tensor:
    """(N_NOISE_ROWS, W) float32: rows 0-7 U(-1,1), row 8 U(0,1), drawn
    as the trainer's reset pulse draws them."""
    u = torch.rand((N_NOISE_ROWS, num_worlds), generator=gen,
                   dtype=torch.float32, device=device)
    return torch.cat([2.0 * u[:N_NOISE_ROWS - 1] - 1.0,
                      u[N_NOISE_ROWS - 1:]])
