"""The game step: 19 systems over the structured state (port of
`madrona_basketball_tpu.systems`, systems.py:1-990).

Each function re-expresses one reference system (src/game.cpp) as masked
tensor math over a `state.State` whose fields carry a leading world axis
W (the JAX package writes them for one world and `vmap`s).  Systems run
in the reference's linear taskgraph order (engine.py::step_core), each
returning a new State, so system k + 1 sees system k's writes.  Where the
reference's parallel-for nodes write across entities (grab steals, SAT
collision correction, inbounder assignment), agent and hoop index order
is the defined semantics; the loops over the 2 agents / 2 hoops unroll in
Python, as the JAX package unrolls them at trace time.

Every C++ early return is a per-world predicate applied with
`torch.where`; every conditional draw is an unconditional uniform of
`StepNoise` masked by its activation.  Nothing reads a value back to the
host and no shape depends on the data, so a tick can be captured in a
CUDA graph (the constants a tick needs are cached per device by
maths.const at the first call).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import constants as C
from .config import SimConfig
from .maths import (const, find_rotation_between_vectors, length, length2,
                    normalize_unsafe, quat_angle_axis, quat_mul, quat_rotate)
from .models.action import _first_argmax
from .state import State

F32 = torch.float32
I32 = torch.int32
PLACEHOLDER = C.ENTITY_ID_PLACEHOLDER
FWD = (0.0, 1.0, 0.0)  # AGENT_BASE_FORWARD (src/constants.hpp:54)
R = dataclasses.replace


@dataclasses.dataclass
class StepNoise:
    """Uniforms one tick consumes (systems.py:43-56).

    shot_u:  (W, A, 3) in [-1, 1): distance / defender / velocity shot
             deviations (src/game.cpp:309,331,339);
    reset_u: (W, 3): [0], [1] in [-1, 1) offense spawn x / y deviation,
             [2] in [0, 1) defender spawn angle (src/helper.cpp:121-132).
    """

    shot_u: torch.Tensor
    reset_u: torch.Tensor

    @classmethod
    def from_rows(cls, rows: torch.Tensor) -> "StepNoise":
        """The kernels' (9, W) noise rows (shot_u agent by agent, then
        reset_u; engine_fused.draw_noise_rows) as a StepNoise."""
        W = rows.shape[1]
        A = (rows.shape[0] - 3) // 3
        return cls(shot_u=rows[:3 * A].T.reshape(W, A, 3),
                   reset_u=rows[3 * A:].T)

    def rows(self) -> torch.Tensor:
        """Inverse of `from_rows`."""
        W = self.shot_u.shape[0]
        return torch.cat([self.shot_u.reshape(W, -1).T, self.reset_u.T])


def draw_noise(cfg: SimConfig, gen: torch.Generator, num_worlds: int,
               device="cuda") -> StepNoise:
    """One tick's noise for every world, drawn from `gen` in the layout
    of the kernels' noise rows, so the structured and the rows engines
    draw the same numbers from the same generator."""
    from .engine_fused import draw_noise_rows
    return StepNoise.from_rows(draw_noise_rows(num_worlds, gen, device))


# =====================================================================
# Small tensor helpers
# =====================================================================

def _w(pred, a, b):
    """`torch.where` with a per-world (or per-world, per-agent) predicate
    broadcast over the values' trailing axes."""
    nd = max(x.dim() for x in (a, b) if isinstance(x, torch.Tensor))
    if nd > pred.dim():
        pred = pred.reshape(pred.shape + (1,) * (nd - pred.dim()))
    return torch.where(pred, a, b)


def _set(x, i, v):
    """x.at[:, i].set(v)."""
    y = x.clone()
    y[:, i] = v
    return y


def _add(x, i, v):
    """x.at[:, i].add(v)."""
    return _set(x, i, x[:, i] + v)


def _zeros(like, *shape, dtype=F32):
    return torch.zeros((like.shape[0],) + shape, dtype=dtype,
                       device=like.device)


# =====================================================================
# Shared helpers (src/helper.cpp)
# =====================================================================

def find_vector_to_center(cfg: SimConfig, pos):
    """Unit vector from pos toward the grid start point
    (src/helper.cpp:44-48)."""
    return normalize_unsafe(const([cfg.start_x, cfg.start_y, 0.0],
                                  pos.device) - pos)


def get_shot_point_value(pos, hoop_zone_center):
    """2 vs 3 points incl. the corner-3 geometry (src/helper.cpp:50-81)."""
    distance = length(pos - hoop_zone_center)
    in_corner_lane = (
        (pos[:, 1] < C.COURT_MIN_Y + C.CORNER_3_FROM_SIDELINE_M)
        | (pos[:, 1] > C.COURT_MIN_Y + C.COURT_WIDTH_M -
           C.CORNER_3_FROM_SIDELINE_M))
    left_hoop = hoop_zone_center[:, 0] < C.WORLD_WIDTH_M / 2.0
    corner3 = in_corner_lane & torch.where(
        left_hoop,
        pos[:, 0] <= C.COURT_MIN_X + C.CORNER_3_LENGTH_FROM_BASELINE_M,
        pos[:, 0] >= C.COURT_MIN_X + C.COURT_LENGTH_M -
        C.CORNER_3_LENGTH_FROM_BASELINE_M)
    arc3 = distance >= C.ARC_RADIUS_M
    return torch.where(corner3 | arc3, 3, 2).to(I32)


def assign_inbounder(cfg: SimConfig, s: State, active, new_team_idx,
                     ball_spot, new_orientation, is_oob: bool) -> State:
    """Give the ball to the first player of `new_team_idx` for an inbound
    (src/game.cpp:14-53); `active` (W,) masks the whole operation."""
    a, b, g = s.agents, s.ball, s.game
    assigned = torch.zeros_like(active)
    for i in range(cfg.num_agents):
        take = active & (a.team[:, i] == new_team_idx) & (~assigned)
        a = R(a,
              im_inbounding=_set(a.im_inbounding, i, torch.where(
                  take, 1, a.im_inbounding[:, i])),
              pos=_set(a.pos, i, _w(take, ball_spot, a.pos[:, i])),
              has_ball=_set(a.has_ball, i, torch.where(take, 1,
                                                       a.has_ball[:, i])),
              held_ball_id=_set(a.held_ball_id, i, torch.where(
                  take, C.BALL_ID, a.held_ball_id[:, i])),
              orient=_set(a.orient, i, _w(take, new_orientation,
                                          a.orient[:, i])))
        b = R(b, grabbed=torch.where(take, 1, b.grabbed),
              holder=torch.where(take, C.AGENT_IDS[i], b.holder))
        assigned = assigned | take
    found = active & assigned
    g = R(g,
          team_in_possession=torch.where(found, new_team_idx.to(F32),
                                         g.team_in_possession),
          inbounding_in_progress=torch.where(found, 1,
                                             g.inbounding_in_progress),
          inbound_clock=torch.where(found, 5.0, g.inbound_clock),
          oob_count=g.oob_count + torch.where(found & is_oob, 1.0, 0.0))
    return R(s, agents=a, ball=b, game=g)


# =====================================================================
# 1. tick (src/game.cpp:969-988)
# =====================================================================

def tick_system(cfg: SimConfig, s: State) -> State:
    a = s.agents
    was_reset = a.reset == 1
    return R(s, agents=R(
        a, reward=torch.zeros_like(a.reward), done=was_reset.to(F32),
        cur_step=torch.where(was_reset, 0, a.cur_step + 1),
        grab_cooldown=torch.clamp(a.grab_cooldown - 1.0, min=0.0)))


# =====================================================================
# 2. actionMaskSystem (src/game.cpp:489-533)
# =====================================================================

def action_mask_system(cfg: SimConfig, s: State) -> State:
    a, g = s.agents, s.game
    can_move = torch.ones_like(a.team)
    can_grab = torch.ones_like(a.team)
    can_pass = (a.has_ball == 1).to(I32)
    can_shoot = (a.has_ball == 1).to(I32)

    inb = (g.inbounding_in_progress == 1)[:, None]
    can_shoot = torch.where(inb, 0, can_shoot)
    can_grab = torch.where(inb, 0, can_grab)
    pinned = inb & (a.im_inbounding == 1) & (g.live_ball == 0)[:, None]
    can_move = torch.where(pinned, 0, can_move)
    can_grab = torch.where(a.grab_cooldown > 0.0, 0, can_grab)
    if cfg.tag_mode:
        # ======================== FOR TAG (src/game.cpp:525-528) =========
        can_pass = torch.zeros_like(can_pass)
        can_grab = torch.zeros_like(can_grab)
    mask = torch.stack([can_move, can_grab, can_pass, can_shoot], dim=-1)
    return R(s, agents=R(a, action_mask=mask.to(I32)))


# =====================================================================
# 3. moveAgentSystem (src/game.cpp:410-486)
# =====================================================================

def move_agent_system(cfg: SimConfig, s: State) -> State:
    a = s.agents
    dt = cfg.sim_dt
    new_orients, new_pos, new_vel = [], [], []
    for i in range(cfg.num_agents):
        act = a.action[:, i]
        orient = a.orient[:, i]

        # rotation applies even when movement is masked off
        do_rot = act[:, 2] != 0
        turn_angle = torch.where(act[:, 2] == 1, math.pi / 180.0 * 6.0,
                                 -math.pi / 180.0 * 6.0).to(F32)
        turn = quat_angle_axis(turn_angle, (0.0, 0.0, 1.0))
        orient = _w(do_rot, quat_mul(turn, orient), orient)

        active = a.action_mask[:, i, 0] != 0
        move_angle = act[:, 1].to(F32) * C.ANGLE_BETWEEN_DIRECTIONS
        delta_vel = torch.stack([torch.sin(move_angle), -torch.cos(move_angle),
                                 torch.zeros_like(move_angle)], dim=-1)
        delta_vel = delta_vel * a.quickness[:, i, None] * \
            act[:, 0].to(F32)[:, None]

        vel = a.vel[:, i]
        max_speed = a.max_speed[:, i]
        orient_vec = quat_rotate(orient, FWD)
        vlen2 = length2(vel)
        safe_inv = torch.rsqrt(torch.clamp(vlen2, min=1e-30))
        dot = torch.where(vlen2 > 1e-6,
                          (vel * safe_inv[:, None] * orient_vec).sum(-1), 0.0)

        backwards = dot < -0.1
        sideways = (~backwards) & (dot <= 0.8)
        max_speed = max_speed * torch.where(
            backwards, 0.1, torch.where(sideways, 0.7, 1.0))
        delta_vel = delta_vel * torch.where(backwards | sideways, 0.1,
                                            1.0)[:, None]
        vel = vel + delta_vel
        # (the reference zeroes delta_vel.x for the inbounder after the
        #  add: dead code, a no-op here too; src/game.cpp:454)
        max_speed = max_speed * torch.where(a.has_ball[:, i] == 1,
                                            C.BALL_AGENT_SLOWDOWN, 1.0)
        speed = length(vel)
        vel = _w(speed > max_speed,
                 vel * (max_speed / torch.clamp(speed, min=1e-30))[:, None],
                 vel)
        new_x = torch.clamp(a.pos[:, i, 0] + vel[:, 0] * dt, 0.0,
                            cfg.grid_width)
        new_y = torch.clamp(a.pos[:, i, 1] + vel[:, 1] * dt, 0.0,
                            cfg.grid_height)
        # wall-cell test compiled out: every cell is empty
        # (src/bindings.cpp:7-12)
        pos = _w(active, torch.stack([new_x, new_y, a.pos[:, i, 2]], -1),
                 a.pos[:, i])
        vel = _w(active, vel * 0.95, a.vel[:, i])
        new_orients.append(orient)
        new_pos.append(pos)
        new_vel.append(vel)
    return R(s, agents=R(a, orient=torch.stack(new_orients, 1),
                         pos=torch.stack(new_pos, 1),
                         vel=torch.stack(new_vel, 1)))


# =====================================================================
# 4. grabSystem (src/game.cpp:164-239)
# =====================================================================

def grab_system(cfg: SimConfig, s: State) -> State:
    for i in range(cfg.num_agents):
        s = _grab_one(cfg, s, i)
    return s


def _grab_one(cfg: SimConfig, s: State, i: int) -> State:
    a, b, g = s.agents, s.ball, s.game
    aid = C.AGENT_IDS[i]

    act = (a.action_mask[:, i, 1] != 0) & (a.action[:, i, 3] != 0)
    action = a.action.clone()
    action[:, i, 3] = torch.where(act, 0, a.action[:, i, 3])
    a = R(a, grab_cooldown=_set(a.grab_cooldown, i, torch.where(
        act, 10.0, a.grab_cooldown[:, i])), action=action)

    ball_act = act & (b.in_flight != 1)
    holding = (a.has_ball[:, i] == 1) & (b.grabbed == 1) & (b.holder == aid)
    # toggle-drop if already holding (src/game.cpp:190-196)
    drop = ball_act & holding
    a = R(a, has_ball=_set(a.has_ball, i, torch.where(drop, 0,
                                                      a.has_ball[:, i])),
          held_ball_id=_set(a.held_ball_id, i, torch.where(
              drop, PLACEHOLDER, a.held_ball_id[:, i])))
    b = R(b, grabbed=torch.where(drop, 0, b.grabbed),
          holder=torch.where(drop, PLACEHOLDER, b.holder))

    near = length(b.pos - a.pos[:, i]) <= 0.3
    reach = ball_act & (~holding) & near
    # 1v1: a defender touching the ball is a turnover -> episode reset
    # (src/game.cpp:204-207)
    turnover = reach & (g.is_one_on_one == 1) & (
        a.team[:, i].to(F32) != g.team_in_possession)
    reset_now = torch.where(turnover, 1, s.reset_now)

    take = reach & (~turnover)
    # steal: strip any current holder, 1-second cooldown for the victim
    # (src/game.cpp:210-221)
    for j in range(cfg.num_agents):
        victim = take & (a.held_ball_id[:, j] == C.BALL_ID)
        a = R(a, has_ball=_set(a.has_ball, j, torch.where(
                  victim, 0, a.has_ball[:, j])),
              held_ball_id=_set(a.held_ball_id, j, torch.where(
                  victim, PLACEHOLDER, a.held_ball_id[:, j])),
              grab_cooldown=_set(a.grab_cooldown, j, torch.where(
                  victim, C.SIMULATION_HZ, a.grab_cooldown[:, j])))
    a = R(a, has_ball=_set(a.has_ball, i, torch.where(take, 1,
                                                      a.has_ball[:, i])),
          held_ball_id=_set(a.held_ball_id, i, torch.where(
              take, C.BALL_ID, a.held_ball_id[:, i])))
    b = R(b, holder=torch.where(take, aid, b.holder),
          grabbed=torch.where(take, 1, b.grabbed),
          in_flight=torch.where(take, 0, b.in_flight),
          vel=_w(take, 0.0, b.vel),
          shot_by_agent=torch.where(take, PLACEHOLDER, b.shot_by_agent),
          shot_by_team=torch.where(take, PLACEHOLDER, b.shot_by_team),
          shot_point_value=torch.where(take, 2, b.shot_point_value))
    g = R(g, team_in_possession=torch.where(take, a.team[:, i].to(F32),
                                            g.team_in_possession),
          live_ball=torch.where(take, 1, g.live_ball))
    return R(s, agents=a, ball=b, game=g, reset_now=reset_now)


# =====================================================================
# 5. passSystem (src/game.cpp:243-270)
# =====================================================================

def pass_system(cfg: SimConfig, s: State) -> State:
    for i in range(cfg.num_agents):
        a, b, g = s.agents, s.ball, s.game
        act = (a.action_mask[:, i, 2] != 0) & (a.action[:, i, 4] != 0)
        hold = act & (b.holder == C.AGENT_IDS[i])
        a = R(a, has_ball=_set(a.has_ball, i, torch.where(
                  hold, 0, a.has_ball[:, i])),
              held_ball_id=_set(a.held_ball_id, i, torch.where(
                  hold, PLACEHOLDER, a.held_ball_id[:, i])),
              im_inbounding=_set(a.im_inbounding, i, torch.where(
                  hold, 0, a.im_inbounding[:, i])))
        pass_vel = quat_rotate(a.orient[:, i], (0.0, 0.1, 0.0))
        b = R(b, grabbed=torch.where(hold, 0, b.grabbed),
              holder=torch.where(hold, PLACEHOLDER, b.holder),
              vel=_w(hold, pass_vel, b.vel))
        g = R(g, inbounding_in_progress=torch.where(
            hold, 0, g.inbounding_in_progress))
        s = R(s, agents=a, ball=b, game=g)
    return s


# =====================================================================
# 6. shootSystem (src/game.cpp:273-407)
# =====================================================================

def shoot_system(cfg: SimConfig, s: State, noise: StepNoise) -> State:
    for i in range(cfg.num_agents):
        s = _shoot_one(cfg, s, i, noise.shot_u[:, i])
    return s


def _shoot_one(cfg: SimConfig, s: State, i: int, u) -> State:
    a, b, g, h = s.agents, s.ball, s.game, s.hoops
    aid = C.AGENT_IDS[i]
    act = (a.action_mask[:, i, 3] != 0) & (a.action[:, i, 5] != 0)

    # attacking hoop = the one we are not defending (last match wins,
    # src/game.cpp:290-296)
    zone_center = _zeros(a.pos, 3)
    zone_radius = _zeros(a.pos)
    for hi in range(cfg.num_hoops):
        match = C.HOOP_IDS[hi] != a.defending_hoop[:, i]
        zone_center = _w(match, h.zone_center[:, hi], zone_center)
        zone_radius = torch.where(match, h.zone_radius[:, hi], zone_radius)

    ideal = zone_center - a.pos[:, i]
    intended = torch.atan2(ideal[:, 0], ideal[:, 1])
    dist = length(ideal)
    dev_dist = u[:, 0] * (C.DIST_DEVIATION_PER_METER * dist)

    d_def = torch.full_like(dist, math.inf)
    for j in range(cfg.num_agents):
        is_def = a.team[:, j] != a.team[:, i]
        d_def = torch.where(is_def, torch.minimum(
            d_def, length(a.pos[:, i] - a.pos[:, j])), d_def)
    dev_def = torch.where(
        d_def < 2.0, u[:, 1] * (C.DEF_DEVIATION_PER_METER / (d_def + 0.1)),
        0.0)
    dev_vel = torch.where(
        a.action[:, i, 0] > 0,
        u[:, 2] * (C.VEL_DEVIATION_FACTOR * length(a.vel[:, i])), 0.0)

    shot_dir = intended + dev_dist + dev_def + dev_vel
    final_vec = torch.stack([torch.sin(shot_dir), torch.cos(shot_dir),
                             torch.zeros_like(shot_dir)], dim=-1)

    # make decided analytically at release (src/game.cpp:348-355)
    t_along = (ideal * final_vec).sum(-1)
    closest_sq = length2(ideal) - t_along * t_along
    going_in = (~(t_along < 0.0)) & (closest_sq <= zone_radius * zone_radius)

    # the shooter snaps to face the shot (src/game.cpp:362-364), gated on
    # the action alone, even if the agent is not the holder
    snap = find_rotation_between_vectors(FWD, final_vec)
    a = R(a, orient=_set(a.orient, i, _w(act, snap, a.orient[:, i])))

    hold = act & (b.holder == aid)
    spv = get_shot_point_value(a.pos[:, i], zone_center)
    made = hold & going_in
    g = R(g, scored_baskets=g.scored_baskets + torch.where(made, 1.0, 0.0))
    a = R(a, reward=_add(a.reward, i, torch.where(hold & (~going_in), -1.0,
                                                  0.0)),
          has_ball=_set(a.has_ball, i, torch.where(hold, 0,
                                                   a.has_ball[:, i])),
          held_ball_id=_set(a.held_ball_id, i, torch.where(
              hold, PLACEHOLDER, a.held_ball_id[:, i])),
          im_inbounding=_set(a.im_inbounding, i, torch.where(
              hold, 0, a.im_inbounding[:, i])))
    b = R(b, shot_going_in=torch.where(made, 1, b.shot_going_in),
          grabbed=torch.where(hold, 0, b.grabbed),
          holder=torch.where(hold, PLACEHOLDER, b.holder),
          vel=_w(hold, final_vec * 0.1, b.vel),
          in_flight=torch.where(hold, 1, b.in_flight),
          shot_by_agent=torch.where(hold, aid, b.shot_by_agent),
          shot_by_team=torch.where(hold, a.team[:, i], b.shot_by_team),
          shot_point_value=torch.where(hold, spv, b.shot_point_value),
          last_touched_agent=torch.where(hold, aid, b.last_touched_agent),
          last_touched_team=torch.where(hold, a.team[:, i],
                                        b.last_touched_team))
    return R(s, agents=a, ball=b, game=g)


# =====================================================================
# 7. moveBallSystem (src/game.cpp:82-125)
# =====================================================================

def move_ball_system(cfg: SimConfig, s: State) -> State:
    a, b = s.agents, s.ball
    pos = b.pos
    for i in range(cfg.num_agents):
        holding = (a.has_ball[:, i] == 1) & (b.grabbed == 1) & (
            b.holder == C.AGENT_IDS[i])
        pos = _w(holding, a.pos[:, i], pos)
    free = (length(b.vel) != 0.0) & (b.grabbed != 1)
    new_pos = torch.stack([
        torch.clamp(pos[:, 0] + b.vel[:, 0], 0.0, cfg.grid_width),
        torch.clamp(pos[:, 1] + b.vel[:, 1], 0.0, cfg.grid_height),
        pos[:, 2] + b.vel[:, 2],  # z is unclamped (src/game.cpp:110)
    ], dim=-1)
    return R(s, ball=R(b, pos=_w(free, new_pos, pos)))


# =====================================================================
# 8. updateCurrentShotPercentage (src/game.cpp:758-809)
# =====================================================================

def _nearest_defender(cfg: SimConfig, a, i: int):
    d_def = torch.full_like(a.pos[:, i, 0], math.inf)
    for j in range(cfg.num_agents):
        is_def = a.team[:, j] != a.team[:, i]
        d_def = torch.where(is_def, torch.minimum(
            d_def, length(a.pos[:, i] - a.pos[:, j])), d_def)
    return d_def


def update_shot_pct_system(cfg: SimConfig, s: State) -> State:
    a, h = s.agents, s.hoops
    new_pct = []
    for i in range(cfg.num_agents):
        att_pos = _w(C.HOOP_IDS[0] != a.defending_hoop[:, i], h.pos[:, 0],
                     h.pos[:, 1])
        dist_hoop = length(att_pos - a.pos[:, i])
        d_def = _nearest_defender(cfg, a, i)
        dist_sd = C.DIST_DEVIATION_PER_METER * dist_hoop
        # the reference divides, then adds 1e-4 (src/game.cpp:799), unlike
        # shootSystem's / (d + 0.1)
        def_sd = C.DEF_DEVIATION_PER_METER / d_def + 1e-4
        vel_sd = C.VEL_DEVIATION_FACTOR * length(a.vel[:, i])
        final_sd = torch.sqrt(dist_sd * dist_sd / 3.0 +
                              def_sd * def_sd / 3.0 +
                              vel_sd * vel_sd / 3.0)
        max_make_angle = torch.atan(C.HOOP_SCORE_ZONE_SIZE / dist_hoop)
        z = max_make_angle / final_sd
        pct = torch.erf(z / float(np.sqrt(np.float32(2.0))))
        new_pct.append(torch.where(a.has_ball[:, i] == 0, 0.0, pct))
    return R(s, agents=R(a, shot_pct=torch.stack(new_pct, 1)))


# =====================================================================
# 9. scoreSystem (src/game.cpp:873-953)
# =====================================================================

def score_system(cfg: SimConfig, s: State) -> State:
    for hi in range(cfg.num_hoops):
        s = _score_one_hoop(cfg, s, hi)
    return s


def _score_one_hoop(cfg: SimConfig, s: State, hi: int) -> State:
    a, b, g, h = s.agents, s.ball, s.game, s.hoops
    hid = C.HOOP_IDS[hi]

    dist_xy = torch.sqrt((b.pos[:, 0] - h.pos[:, hi, 0]) ** 2 +
                         (b.pos[:, 1] - h.pos[:, hi, 1]) ** 2)
    scored = (dist_xy <= h.zone_radius[:, hi]) & (b.in_flight == 1)
    points = b.shot_point_value

    inb_team = torch.zeros_like(points)
    for j in range(cfg.num_agents):
        defends = a.defending_hoop[:, j] == hid
        inb_team = torch.where(defends, a.team[:, j], inb_team)
        shooter = scored & (C.AGENT_IDS[j] == b.shot_by_agent)
        delta = torch.where(defends, -points, points).to(F32)
        a = R(a, stat_points=_add(a.stat_points, j,
                                  torch.where(shooter, delta, 0.0)))

    is_team0_hoop = hid == g.team0_hoop
    g = R(g,
          team1_score=g.team1_score + torch.where(
              scored & is_team0_hoop, points.to(F32), 0.0),
          team0_score=g.team0_score + torch.where(
              scored & (~is_team0_hoop), points.to(F32), 0.0),
          scored_baskets=g.scored_baskets + torch.where(scored, 1.0, 0.0))
    inbound_spot = torch.stack([
        torch.where(is_team0_hoop, C.COURT_MIN_X, C.COURT_MAX_X).to(F32),
        h.pos[:, hi, 1] + C.PIXELS_PER_METER / 60.0,
        torch.zeros_like(dist_xy)], dim=-1)

    b = R(b, in_flight=torch.where(scored, 0, b.in_flight),
          vel=_w(scored, 0.0, b.vel),
          shot_by_agent=torch.where(scored, PLACEHOLDER, b.shot_by_agent),
          shot_by_team=torch.where(scored, PLACEHOLDER, b.shot_by_team),
          shot_point_value=torch.where(scored, 2, b.shot_point_value),
          shot_going_in=torch.where(scored, 0, b.shot_going_in))

    # full game: the ball to the baseline and an inbounder; 1v1: a world
    # reset instead (src/game.cpp:940-950)
    full = scored & (g.is_one_on_one == 0)
    b = R(b, pos=_w(full, inbound_spot, b.pos))
    s = R(s, agents=a, ball=b, game=g)
    inb_orient = find_rotation_between_vectors(
        FWD, find_vector_to_center(cfg, inbound_spot))
    s = assign_inbounder(cfg, s, full, inb_team, inbound_spot, inb_orient,
                         is_oob=False)
    one = scored & (g.is_one_on_one != 0)
    return R(s, reset_now=torch.where(one, 1, s.reset_now))


# =====================================================================
# 10. outOfBoundsSystem (src/game.cpp:1055-1113)
# =====================================================================

def _offense_bonus(a, g, value):
    """`value` (W,) added to the in-possession agent's reward (the
    off-agent scan defaults to agent 0)."""
    off_idx_is_1 = a.team[:, 1].to(F32) == g.team_in_possession
    r = a.reward.clone()
    r[:, 0] = a.reward[:, 0] + torch.where(off_idx_is_1, 0.0, value)
    r[:, 1] = a.reward[:, 1] + torch.where(off_idx_is_1, value, 0.0)
    return r


def out_of_bounds_system(cfg: SimConfig, s: State) -> State:
    a, b, g = s.agents, s.ball, s.game
    oob = ((b.pos[:, 0] < C.COURT_MIN_X) | (b.pos[:, 0] > C.COURT_MAX_X) |
           (b.pos[:, 1] < C.COURT_MIN_Y) | (b.pos[:, 1] > C.COURT_MAX_Y))
    trigger = oob & (g.inbounding_in_progress == 0)

    # 1v1 / TAG: -100 to the offense, reset (src/game.cpp:1069-1082)
    one = trigger & (g.is_one_on_one == 1)
    a = R(a, reward=_offense_bonus(a, g, torch.where(one, -100.0, 0.0)))
    reset_now = torch.where(one, 1, s.reset_now)

    # full game: dead ball, possession flips, inbound
    # (src/game.cpp:1084-1111)
    full = trigger & (g.is_one_on_one != 1)
    b = R(b, in_flight=torch.where(full, 0, b.in_flight),
          vel=_w(full, 0.0, b.vel))
    g = R(g, live_ball=torch.where(full, 0, g.live_ball))
    new_team = (1 - b.last_touched_team).to(I32)
    for i in range(cfg.num_agents):
        carrier = full & (a.has_ball[:, i] == 1) & (
            a.held_ball_id[:, i] == C.BALL_ID)
        nudged = a.pos[:, i] + find_vector_to_center(cfg, a.pos[:, i])
        a = R(a, pos=_set(a.pos, i, _w(carrier, nudged, a.pos[:, i])),
              has_ball=_set(a.has_ball, i, torch.where(carrier, 0,
                                                       a.has_ball[:, i])),
              held_ball_id=_set(a.held_ball_id, i, torch.where(
                  carrier, PLACEHOLDER, a.held_ball_id[:, i])))
    s = R(s, agents=a, ball=b, game=g, reset_now=reset_now)
    inb_orient = find_rotation_between_vectors(
        FWD, find_vector_to_center(cfg, b.pos))
    return assign_inbounder(cfg, s, full, new_team, b.pos, inb_orient,
                            is_oob=True)


# =====================================================================
# 11. updateLastTouchSystem (src/game.cpp:1034-1051)
# =====================================================================

def update_last_touch_system(cfg: SimConfig, s: State) -> State:
    a, b = s.agents, s.ball
    for i in range(cfg.num_agents):
        touch = length(b.pos - a.pos[:, i]) <= C.AGENT_SIZE_M
        b = R(b, last_touched_agent=torch.where(touch, C.AGENT_IDS[i],
                                                b.last_touched_agent),
              last_touched_team=torch.where(touch, a.team[:, i],
                                            b.last_touched_team))
    return R(s, ball=b)


# =====================================================================
# 12. clockSystem (src/game.cpp:992-1030)
# =====================================================================

def clock_system(cfg: SimConfig, s: State) -> State:
    a, g = s.agents, s.game
    dt = cfg.sim_dt
    run = (g.live_ball > 0) & (g.game_clock > 0.0)
    game_clock = torch.where(run, g.game_clock - dt, g.game_clock)
    shot_clock = torch.where(run, g.shot_clock - dt, g.shot_clock)
    inb = g.inbounding_in_progress > 0
    inbound_clock = torch.where(inb, g.inbound_clock - dt, g.inbound_clock)

    # game-clock expiry: +10 to the in-possession agent, reset
    # (src/game.cpp:1009-1021)
    expire = (game_clock <= 0.0) & (g.live_ball > 0)
    a = R(a, reward=_offense_bonus(a, g, torch.where(expire, 10.0, 0.0)))
    reset_now = torch.where(expire, 1, s.reset_now)
    shot_clock = torch.where(shot_clock < 0.0, 0.0, shot_clock)
    g = R(g, game_clock=game_clock, shot_clock=shot_clock,
          inbound_clock=inbound_clock)
    return R(s, agents=a, game=g, reset_now=reset_now)


# =====================================================================
# 13. inboundViolationSystem (src/game.cpp:1116-1157)
# =====================================================================

def inbound_violation_system(cfg: SimConfig, s: State) -> State:
    a, b, g = s.agents, s.ball, s.game
    trig = (g.inbounding_in_progress > 0) & (g.inbound_clock <= 0.0)
    new_team = (1 - g.team_in_possession.to(I32)).to(I32)
    g = R(g, live_ball=torch.where(trig, 0, g.live_ball))

    ball_to_turnover = torch.full_like(b.holder, PLACEHOLDER)
    for i in range(cfg.num_agents):
        was_inb = trig & (a.im_inbounding[:, i] > 0)
        ball_to_turnover = torch.where(was_inb, a.held_ball_id[:, i],
                                       ball_to_turnover)
        nudged = a.pos[:, i] + find_vector_to_center(cfg, a.pos[:, i])
        a = R(a, im_inbounding=_set(a.im_inbounding, i, torch.where(
                  was_inb, 0, a.im_inbounding[:, i])),
              has_ball=_set(a.has_ball, i, torch.where(was_inb, 0,
                                                       a.has_ball[:, i])),
              held_ball_id=_set(a.held_ball_id, i, torch.where(
                  was_inb, PLACEHOLDER, a.held_ball_id[:, i])),
              pos=_set(a.pos, i, _w(was_inb, nudged, a.pos[:, i])))
    do_turnover = trig & (ball_to_turnover == C.BALL_ID)
    b = R(b, grabbed=torch.where(do_turnover, 0, b.grabbed),
          holder=torch.where(do_turnover, PLACEHOLDER, b.holder))
    s = R(s, agents=a, ball=b, game=g)
    inb_orient = find_rotation_between_vectors(
        FWD, find_vector_to_center(cfg, b.pos))
    return assign_inbounder(cfg, s, do_turnover, new_team, b.pos, inb_orient,
                            is_oob=True)


# =====================================================================
# 15. updatePointsWorthSystem (src/game.cpp:129-161)
# =====================================================================

def update_points_worth_system(cfg: SimConfig, s: State) -> State:
    a, h = s.agents, s.hoops
    new_pw = []
    for i in range(cfg.num_agents):
        target = _w(C.HOOP_IDS[0] != a.defending_hoop[:, i],
                    h.zone_center[:, 0], h.zone_center[:, 1])
        new_pw.append(get_shot_point_value(a.pos[:, i], target))
    return R(s, agents=R(a, points_worth=torch.stack(new_pw, 1)))


# =====================================================================
# 16. agentCollisionSystem (src/game.cpp:537-648)
# =====================================================================

def _rect_vertices(center, orient):
    fwd = quat_rotate(orient, FWD)
    right = torch.stack([fwd[:, 1], -fwd[:, 0], torch.zeros_like(fwd[:, 0])],
                        dim=-1)
    half_w = right * (C.AGENT_SHOULDER_WIDTH / 2.0)
    half_d = fwd * (C.AGENT_DEPTH / 2.0)
    verts = torch.stack([center - half_d + half_w, center - half_d - half_w,
                         center + half_d - half_w, center + half_d + half_w],
                        dim=1)
    return verts, fwd, right


def agent_collision_system(cfg: SimConfig, s: State) -> State:
    # entity-id-ordered pair iteration (src/game.cpp:549): for 2 agents
    # exactly one check, A = agent 0, B = agent 1
    a, g = s.agents, s.game
    verts_a, fwd_a, right_a = _rect_vertices(a.pos[:, 0], a.orient[:, 0])
    verts_b, fwd_b, right_b = _rect_vertices(a.pos[:, 1], a.orient[:, 1])
    axes = [normalize_unsafe(right_a), normalize_unsafe(fwd_a),
            normalize_unsafe(right_b), normalize_unsafe(fwd_b)]

    colliding = torch.ones_like(a.pos[:, 0, 0], dtype=torch.bool)
    min_overlap = torch.full_like(a.pos[:, 0, 0], torch.finfo(F32).max)
    mtv = torch.zeros_like(a.pos[:, 0])
    for axis in axes:
        pa = (verts_a * axis[:, None, :]).sum(-1)
        pb = (verts_b * axis[:, None, :]).sum(-1)
        pa_min, pa_max = pa.min(-1).values, pa.max(-1).values
        pb_min, pb_max = pb.min(-1).values, pb.max(-1).values
        colliding = colliding & (pa_max > pb_min) & (pb_max > pa_min)
        overlap = torch.minimum(pa_max, pb_max) - torch.maximum(pa_min,
                                                                pb_min)
        smaller = overlap < min_overlap  # strict: the first minimum wins
        min_overlap = torch.where(smaller, overlap, min_overlap)
        mtv = _w(smaller, axis, mtv)

    reset_now = s.reset_now
    if cfg.tag_mode:
        # ======================== FOR TAG (src/game.cpp:622-631) =========
        hit = colliding & (g.team_in_possession == a.team[:, 0].to(F32))
        r = a.reward.clone()
        r[:, 0] = a.reward[:, 0] + torch.where(hit, -10.0, 0.0)
        r[:, 1] = a.reward[:, 1] + torch.where(hit, 10.0, 0.0)
        a = R(a, reward=r)
        reset_now = torch.where(hit, 1, reset_now)

    c2c = a.pos[:, 1] - a.pos[:, 0]
    mtv = _w((c2c * mtv).sum(-1) < 0.0, -mtv, mtv)
    correction = mtv * min_overlap[:, None] * 0.5
    pos = a.pos.clone()
    pos[:, 0] = _w(colliding, a.pos[:, 0] - correction, a.pos[:, 0])
    pos[:, 1] = _w(colliding, a.pos[:, 1] + correction, a.pos[:, 1])
    return R(s, agents=R(a, pos=pos), reset_now=reset_now)


# =====================================================================
# 17. hardCodeDefenseSystem (src/game.cpp:651-755)
# =====================================================================

_MOVE_DIRECTIONS = np.array([
    [0.0, -1.0, 0.0],   # 0: Up
    [1.0, -1.0, 0.0],   # 1: Up-Right
    [1.0, 0.0, 0.0],    # 2: Right
    [1.0, 1.0, 0.0],    # 3: Down-Right
    [0.0, 1.0, 0.0],    # 4: Down
    [-1.0, 1.0, 0.0],   # 5: Down-Left
    [-1.0, 0.0, 0.0],   # 6: Left
    [-1.0, -1.0, 0.0],  # 7: Up-Left
], np.float32)
_MOVE_UNIT = _MOVE_DIRECTIONS / np.linalg.norm(_MOVE_DIRECTIONS, axis=1,
                                               keepdims=True)


def hard_code_defense_system(cfg: SimConfig, s: State) -> State:
    a, g, h = s.agents, s.game, s.hoops
    dt = cfg.sim_dt
    units = const(_MOVE_UNIT, a.pos.device)
    for i in range(cfg.num_agents):
        on_offense = g.team_in_possession == a.team[:, i].to(F32)

        # the first ball holder in index order (src/game.cpp:669-688)
        found = torch.zeros_like(on_offense)
        off_pos = torch.zeros_like(a.pos[:, 0])
        for j in range(cfg.num_agents):
            hit = (a.has_ball[:, j] == 1) & (~found)
            off_pos = _w(hit, a.pos[:, j], off_pos)
            found = found | hit

        my_hoop = _w(a.defending_hoop[:, i] == C.HOOP_IDS[0], h.pos[:, 0],
                     h.pos[:, 1])
        hoop_dir = my_hoop - off_pos
        l2 = length2(hoop_dir)
        guard = _w(l2 > 1e-6, off_pos + C.GUARDING_DISTANCE * (
            hoop_dir * torch.rsqrt(torch.clamp(l2, min=1e-30))[:, None]),
            off_pos)

        chase = (~on_offense) & found
        interp = a.reaction_speed[:, i] * dt
        target = _w(chase, a.target_pos[:, i] + (guard - a.target_pos[:, i])
                    * interp[:, None], a.target_pos[:, i])

        mv = target - a.pos[:, i]
        small = length2(mv) < 0.01
        act_move = chase & (~small)
        desired = mv * torch.rsqrt(torch.clamp(length2(mv),
                                               min=1e-30))[:, None]
        dots = (units[None] * desired[:, None, :]).sum(-1)
        best = _first_argmax(dots).to(I32)  # the first max, like strict >

        ovec = quat_rotate(a.orient[:, i], FWD)
        ang = torch.acos(torch.clamp((ovec * desired).sum(-1), -1.0, 1.0))
        cross = ovec[:, 0] * mv[:, 1] - ovec[:, 1] * mv[:, 0]
        rot = torch.where(cross < 0.0, -1,
                          torch.where(cross > 0.0, 1, 0)).to(I32)
        rot = torch.where(ang > math.pi / 8.0, rot, 0)

        move = torch.where(on_offense, 0, torch.where(
            ~found, 0, torch.where(small, 0, 1))).to(I32)
        action = a.action.clone()
        action[:, i, 0] = move
        action[:, i, 1] = torch.where(act_move, best, a.action[:, i, 1])
        action[:, i, 2] = torch.where(act_move, rot, a.action[:, i, 2])
        action[:, i, 3] = torch.where(on_offense, a.action[:, i, 3], 1)
        a = R(a, action=action,
              target_pos=_set(a.target_pos, i, target))
    return R(s, agents=a)


# =====================================================================
# 18. fillObservationsSystem (src/game.cpp:1175-1461)
# =====================================================================

def _safe_dir(vec):
    """normalize if length2 > 1e-6 else the zero vector (the reference's
    guard)."""
    l2 = length2(vec)
    inv = torch.rsqrt(torch.clamp(l2, min=1e-30))
    return _w(l2 > 1e-6, vec * inv[:, None], 0.0)


def _agent_obs_block(pos, orient, vel, im_inb, cooldown, max_speed,
                     quickness, shooting, ft_pct, reaction, shot_pct,
                     points_worth, has_ball, hoop_pos, ball_pos,
                     self_block, rel_pos=None):
    """The 38-float per-agent block (src/game.cpp:1290-1322 self,
    1380-1421 opponent); `self_block` writes the zeros the reference
    writes for the observer's vec-to-agent slot."""
    if self_block:
        parts = [pos, _zeros(pos, 3), _zeros(pos, 1)]
    else:
        parts = [pos, _safe_dir(rel_pos), length(rel_pos)[:, None]]
    ovec = quat_rotate(orient, FWD)
    l2v = length2(vel)
    veln = _w(l2v > 1e-6, vel * torch.rsqrt(torch.clamp(l2v, min=1e-30))
              [:, None], 0.0)
    dot = torch.where(l2v > 1e-6, (veln * ovec).sum(-1), 0.0)
    accel = torch.where(dot <= 0.8, 0.1, 1.0)
    dir_hoop = hoop_pos - pos
    dist_hoop = length(dir_hoop)
    dir_hoop_n = _w(dist_hoop > 1e-6, dir_hoop * torch.rsqrt(
        torch.clamp(length2(dir_hoop), min=1e-30))[:, None], 0.0)
    dir_ball = ball_pos - pos
    dist_ball = length(dir_ball)
    dir_ball_n = _w(dist_ball > 1e-6, dir_ball * torch.rsqrt(
        torch.clamp(length2(dir_ball), min=1e-30))[:, None], 0.0)
    parts += [
        orient, ovec, veln,
        torch.stack([length(vel), dot, accel], -1),
        dir_hoop_n, dist_hoop[:, None], dir_ball_n, dist_ball[:, None],
        torch.stack([im_inb.to(F32), cooldown, max_speed, quickness,
                     shooting, ft_pct, reaction, shot_pct,
                     points_worth.to(F32), has_ball.to(F32)], -1),
    ]
    return torch.cat(parts, dim=-1)  # 38 floats


def fill_observations_system(cfg: SimConfig, s: State) -> State:
    a, b, g, h = s.agents, s.ball, s.game, s.hoops

    # inbounder id: the last agent with imInbounding set, -1 if none
    # (src/game.cpp:1235-1249)
    inbounder_id = torch.full_like(b.holder, -1)
    for j in range(cfg.num_agents):
        inbounder_id = torch.where(a.im_inbounding[:, j] > 0,
                                   C.AGENT_IDS[j], inbounder_id)

    def block(j, hoop, self_block, rel_pos=None):
        return _agent_obs_block(
            a.pos[:, j], a.orient[:, j], a.vel[:, j], a.im_inbounding[:, j],
            a.grab_cooldown[:, j], a.max_speed[:, j], a.quickness[:, j],
            a.shooting[:, j], a.ft_pct[:, j], a.reaction_speed[:, j],
            a.shot_pct[:, j], a.points_worth[:, j], a.has_ball[:, j], hoop,
            b.pos, self_block=self_block, rel_pos=rel_pos)

    all_obs = []
    for i in range(cfg.num_agents):
        att_hoop = _w(C.HOOP_IDS[0] != a.defending_hoop[:, i], h.pos[:, 0],
                      h.pos[:, 1])
        def_hoop = _w(C.HOOP_IDS[0] == a.defending_hoop[:, i], h.pos[:, 0],
                      h.pos[:, 1])
        own_first = a.team[:, i] == 0
        scores = _w(own_first,
                    torch.stack([g.team0_score, g.team1_score], -1),
                    torch.stack([g.team1_score, g.team0_score], -1))
        parts = [
            torch.stack([g.game_clock, g.shot_clock, g.period,
                         g.inbounding_in_progress.to(F32),
                         g.inbound_clock], -1),
            scores, b.pos, b.vel,
            torch.stack([b.grabbed.to(F32), b.in_flight.to(F32),
                         b.shot_point_value.to(F32),
                         b.last_touched_team.to(F32)], -1),
            att_hoop, def_hoop, block(i, att_hoop, True),
        ]
        # teammate blocks: N/2 - 1 = 0 for N = 2; opponent blocks: N/2 =
        # 1.  An opponent's dir-to-hoop uses my defending hoop, its
        # attacking one (src/game.cpp:1395)
        for j in range(cfg.num_agents):
            if j != i:
                parts.append(block(j, def_hoop, False,
                                   a.pos[:, j] - a.pos[:, i]))
        parts.append(torch.stack([(b.holder == C.AGENT_IDS[j]).to(F32)
                                  for j in range(cfg.num_agents)], -1))
        parts.append(torch.stack([(inbounder_id == C.AGENT_IDS[j]).to(F32)
                                  for j in range(cfg.num_agents)], -1))
        obs = torch.cat(parts, dim=-1)
        pad = C.OBS_SIZE - obs.shape[-1]
        assert pad >= 0, f"observation overflow: {obs.shape[-1]} > " \
            f"{C.OBS_SIZE}"
        all_obs.append(torch.nn.functional.pad(obs, (0, pad)))
    return R(s, agents=R(a, obs=torch.stack(all_obs, 1)))


# =====================================================================
# 19. rewardSystem (src/game.cpp:811-870)
# =====================================================================

def reward_system(cfg: SimConfig, s: State) -> State:
    a, b, g = s.agents, s.ball, s.game
    new_rewards = []
    for i in range(cfg.num_agents):
        other = 1 - i  # the only other agent (src/game.cpp:820-824)
        dist_other = length(a.pos[:, other] - a.pos[:, i])
        on_offense = a.team[:, i].to(F32) == g.team_in_possession
        r = a.reward[:, i]
        off_active = on_offense & (g.game_clock > 5.0)
        mine = b.shot_by_agent == C.AGENT_IDS[i]
        made = mine & (b.shot_going_in == 1)
        missing = mine & (b.shot_going_in == 0) & (b.in_flight == 1)
        r = r + torch.where(off_active & made,
                            b.shot_point_value.to(F32), 0.0)
        r = r - torch.where(off_active & (~made) & missing, 1.0, 0.0)
        r = r + torch.where(off_active, a.shot_pct[:, i], 0.0)
        r = r + torch.where(~on_offense, -1.0 + torch.exp(-0.4 * dist_other),
                            0.0)
        new_rewards.append(r)
    return R(s, agents=R(a, reward=torch.stack(new_rewards, 1)))
