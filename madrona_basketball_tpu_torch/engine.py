"""World generation, episode reset and the structured step (port of
`madrona_basketball_tpu.engine`, engine.py:36-316).

Two forms of the same worlds:

  * `init_rows` builds the initial SoA rows (SF, SI) that kernels A, B,
    F and I step, without a structured state;
  * the structured engine: `generate_world` / `init_batch` build a
    `state.State` of W worlds, `reset_world` / `reset_system` are the
    episode reset, `step_core` the 19-system chain of systems.py in the
    reference's taskgraph order and `step` / `step_batch` draw the tick's
    noise from a torch.Generator first.  `layout.pack` of `init_batch`
    equals `init_rows` on the same generator state.

`init_rows` builds the initial (SF, SI) without a structured state.  It
keeps the deliberate generate-vs-reset differences of the reference
(PARITY.md section 2.1): the ball starts at the grid start point even
though the offense holds it (src/gen.cpp:169), team colours are the
generateWorld ones (src/constants.hpp:18-19) and every done flag is 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import constants as C
from .config import SimConfig
from . import systems as S
from .maths import const
from .ops.layout import F_IDX, I_IDX, N_F32_ROWS, N_I32_ROWS, hoop_positions
from .state import State, tree_select, zero_state

F32 = torch.float32
I32 = torch.int32
A = C.NUM_AGENTS
PLACEHOLDER = C.ENTITY_ID_PLACEHOLDER


def draw_reset_u(num_worlds: int, gen: torch.Generator,
                 device="cuda") -> torch.Tensor:
    """(3, W) spawn uniforms: rows 0-1 U(-1,1) offense x/y deviation, row
    2 U(0,1) defender angle (systems.draw_noise's reset_u)."""
    u = torch.rand((3, num_worlds), generator=gen, dtype=F32, device=device)
    return torch.cat([2.0 * u[:2] - 1.0, u[2:]])


def init_rows(cfg: SimConfig, num_worlds: int, gen: torch.Generator | None,
              device="cuda", reset_u: torch.Tensor | None = None):
    """Fresh worlds as (sf (72,W) f32, si (59,W) i32).

    Spawns come from `reset_u` (3, W) when given (tests pass the JAX
    draws), else from `gen`."""
    W = num_worlds
    dev = torch.device(device)
    if reset_u is None:
        reset_u = draw_reset_u(W, gen, dev)
    reset_u = reset_u.to(device=dev, dtype=F32)
    sf = torch.zeros((N_F32_ROWS, W), dtype=F32, device=dev)
    si = torch.zeros((N_I32_ROWS, W), dtype=I32, device=dev)

    def put_f(k, v):
        sf[F_IDX[k]] = v

    def put_i(k, v):
        si[I_IDX[k]] = v

    one = cfg.one_on_one
    # 1v1 spawn (src/helper.cpp:112-132)
    p0x = torch.clamp(cfg.start_x + reset_u[0] * C.START_POS_STDDEV,
                      0.0, cfg.grid_width)
    p0y = torch.clamp(cfg.start_y + reset_u[1] * C.START_POS_STDDEV,
                      0.0, cfg.grid_height)
    angle = reset_u[2] * (2.0 * math.pi)
    p1x = torch.clamp(p0x + C.DEFENDER_SPAWN_RADIUS * torch.cos(angle),
                      0.0, cfg.grid_width)
    p1y = torch.clamp(p0y + C.DEFENDER_SPAWN_RADIUS * torch.sin(angle),
                      0.0, cfg.grid_height)
    for i in range(A):
        p = f"a{i}."
        if one:
            px, py = (p0x, p0y) if i == 0 else (p1x, p1y)
        else:  # 5v5 grid spawn (src/helper.cpp:148)
            px = torch.full((W,), cfg.start_x - 1.0 + 2.0 * (i % 2),
                            dtype=F32, device=dev)
            py = torch.full((W,), cfg.start_y - 2.0 + i // 2, dtype=F32,
                            device=dev)
        put_f(p + "pos_x", px)
        put_f(p + "pos_y", py)
        put_f(p + "target_x", px)
        put_f(p + "target_y", py)
        # Quat::angleAxis(-+pi/2, z) in float32 (maths.quat_angle_axis)
        half = np.float32(np.float32((-1.0 if i % 2 == 0 else 1.0) *
                                     math.pi / 2) * np.float32(0.5))
        put_f(p + "quat_w", float(np.cos(half, dtype=np.float32)))
        put_f(p + "quat_z", float(np.sin(half, dtype=np.float32)))
        put_f(p + "max_speed", C.DEFAULT_SPEED - i * C.DEFENDER_SLOWDOWN)
        put_f(p + "quickness", 1.0)
        put_f(p + "reaction", i * C.DEFENDER_REACTION)
        col = (C.TEAM0_COLOR, C.TEAM1_COLOR)[i % 2]
        put_f(p + "color_r", col[0])
        put_f(p + "color_g", col[1])
        put_f(p + "color_b", col[2])
        put_i(p + "has_ball", 1 if i == 0 else 0)
        put_i(p + "held_ball", C.BALL_ID if i == 0 else PLACEHOLDER)
        put_i(p + "points_worth", 2)
        put_i(p + "allowed_move", 1)
        put_i(p + "team", i % 2)
        put_i(p + "defend_hoop", C.HOOP_IDS[i % 2])

    put_f("bpos_x", cfg.start_x)
    put_f("bpos_y", cfg.start_y)
    put_i("bgrabbed", 1 if one else 0)
    put_i("bholder", C.AGENT_IDS[0] if one else PLACEHOLDER)
    for n in ("blt_agent", "blt_team", "bsb_agent", "bsb_team"):
        put_i(n, PLACEHOLDER)
    put_i("bspv", 2)

    put_f("period", 1.0)
    put_f("gclock", cfg.time_per_period)
    put_f("sclock", cfg.shot_clock_duration)
    put_i("glive", 1)
    put_i("t0hoop", C.HOOP_IDS[0])
    put_i("t1hoop", C.HOOP_IDS[1])
    put_i("is1v1", 1 if one else 0)
    return sf, si


# =====================================================================
# The structured engine
# =====================================================================

R = __import__("dataclasses").replace


def _agent_orients(A: int) -> np.ndarray:
    """Quat::angleAxis(-+pi/2, z) of each agent in float32
    (maths.quat_angle_axis), (A, 4)."""
    out = np.zeros((A, 4), np.float32)
    for i in range(A):
        half = np.float32(np.float32((-1.0 if i % 2 == 0 else 1.0) *
                                     math.pi / 2) * np.float32(0.5))
        out[i, 0] = np.cos(half, dtype=np.float32)
        out[i, 3] = np.sin(half, dtype=np.float32)
    return out


def _setup_agent_positions(cfg: SimConfig, s: State, reset_u):
    """Agents placed, possession and attributes set (src/helper.cpp:
    108-160); returns (state, the ball's spawn (W, 3)).  1v1: the offense
    at start + U(-5, 5)^2, the defender on a radius-8 circle at a uniform
    angle; else the 5v5 grid, chosen per world on GameState.isOneOnOne
    as the reference does (engine.py:36-95)."""
    a = s.agents
    W, A = a.pos.shape[0], cfg.num_agents
    dev = a.pos.device
    one = s.game.is_one_on_one == 1
    zero = torch.zeros_like(reset_u[:, 0])
    p0_one = torch.stack([
        torch.clamp(cfg.start_x + reset_u[:, 0] * C.START_POS_STDDEV, 0.0,
                    cfg.grid_width),
        torch.clamp(cfg.start_y + reset_u[:, 1] * C.START_POS_STDDEV, 0.0,
                    cfg.grid_height), zero], dim=-1)
    angle = reset_u[:, 2] * (2.0 * math.pi)
    p1_one = torch.stack([
        torch.clamp(p0_one[:, 0] + C.DEFENDER_SPAWN_RADIUS * torch.cos(angle),
                    0.0, cfg.grid_width),
        torch.clamp(p0_one[:, 1] + C.DEFENDER_SPAWN_RADIUS * torch.sin(angle),
                    0.0, cfg.grid_height), zero], dim=-1)
    pos = torch.stack([
        S._w(one, p0_one if i == 0 else p1_one,
             const([cfg.start_x - 1.0 + 2.0 * (i % 2),
                    cfg.start_y - 2.0 + i // 2, 0.0], dev).expand(W, 3))
        for i in range(A)], dim=1)

    def per_agent(values, dtype=F32):
        return const(values, dev, dtype).expand(W, A).clone()

    a = R(a, pos=pos,
          has_ball=per_agent([1 if i == 0 else 0 for i in range(A)], I32),
          held_ball_id=per_agent([C.BALL_ID if i == 0 else PLACEHOLDER
                                  for i in range(A)], I32),
          points_worth=per_agent([2] * A, I32),
          max_speed=per_agent([C.DEFAULT_SPEED - i * C.DEFENDER_SLOWDOWN
                               for i in range(A)]),
          quickness=per_agent([1.0] * A),
          shooting=per_agent([0.0] * A), ft_pct=per_agent([0.0] * A),
          reaction_speed=per_agent([i * C.DEFENDER_REACTION
                                    for i in range(A)]),
          target_pos=pos, shot_pct=per_agent([0.0] * A))
    ball_spawn = S._w(one, pos[:, 0],
                      const([cfg.start_x, cfg.start_y, 0.0], dev).expand(W, 3))
    return R(s, agents=a), ball_spawn


def _reset_agent_common(cfg: SimConfig, s: State, done_val: float,
                        colors) -> State:
    """The component resets that generateWorld and resetWorld share
    (src/gen.cpp:186-206, 267-284)."""
    a, g = s.agents, s.game
    W, A = a.pos.shape[0], cfg.num_agents
    dev = a.pos.device
    team = const([i % 2 for i in range(A)], dev, I32).expand(W, A)
    a = R(a, action=torch.zeros_like(a.action),
          action_mask=torch.zeros_like(a.action_mask),
          reset=torch.zeros_like(a.reset),
          im_inbounding=torch.zeros_like(a.im_inbounding),
          allowed_to_move=torch.ones_like(a.allowed_to_move),
          done=torch.full_like(a.done, done_val),
          cur_step=torch.zeros_like(a.cur_step),
          orient=const(_agent_orients(A), dev).expand(W, A, 4).clone(),
          grab_cooldown=torch.zeros_like(a.grab_cooldown),
          stat_points=torch.zeros_like(a.stat_points),
          stat_fouls=torch.zeros_like(a.stat_fouls),
          vel=torch.zeros_like(a.vel), team=team.clone(),
          team_color=const([colors[i % 2] for i in range(A)],
                           dev).expand(W, A, 3).clone(),
          defending_hoop=torch.where(team == 0, g.team0_hoop[:, None],
                                     g.team1_hoop[:, None]))
    return R(s, agents=a)


def _reset_ball(cfg: SimConfig, s: State, ball_pos, done_val: float):
    b = s.ball
    one = s.game.is_one_on_one == 1
    b = R(b, pos=ball_pos, reset=torch.zeros_like(b.reset),
          done=torch.full_like(b.done, done_val),
          cur_step=torch.zeros_like(b.cur_step),
          in_flight=torch.zeros_like(b.in_flight),
          last_touched_agent=torch.full_like(b.holder, PLACEHOLDER),
          last_touched_team=torch.full_like(b.holder, PLACEHOLDER),
          shot_by_agent=torch.full_like(b.holder, PLACEHOLDER),
          shot_by_team=torch.full_like(b.holder, PLACEHOLDER),
          shot_point_value=torch.full_like(b.holder, 2),
          shot_going_in=torch.zeros_like(b.shot_going_in),
          vel=torch.zeros_like(b.vel),
          grabbed=one.to(I32),
          holder=torch.where(one, C.AGENT_IDS[0], PLACEHOLDER).to(I32))
    return R(s, ball=b)


def generate_world(cfg: SimConfig, num_worlds: int,
                   gen: torch.Generator | None, device="cuda",
                   reset_u: torch.Tensor | None = None) -> State:
    """`num_worlds` fresh worlds (generateWorld, src/gen.cpp:13-214;
    engine.py:156-185), the spawns from `reset_u` (3, W) when given, else
    drawn from `gen` as `init_rows` draws them.  As the reference does,
    the ball stays at the grid start point though the offense holds it
    (src/gen.cpp:169); it moves to the holder on the first tick."""
    W = num_worlds
    dev = torch.device(device)
    s = zero_state(cfg, W, dev)
    hoop = hoop_positions(cfg, dev).expand(W, 2, 3)
    s = R(s, hoops=R(s.hoops, pos=hoop.clone(), zone_center=hoop.clone()))
    if reset_u is None:
        reset_u = draw_reset_u(W, gen, dev)
    reset_u = reset_u.to(device=dev, dtype=F32).T
    s = _reset_agent_common(cfg, s, 0.0, (C.TEAM0_COLOR, C.TEAM1_COLOR))
    s, _ = _setup_agent_positions(cfg, s, reset_u)
    return _reset_ball(cfg, s, const([cfg.start_x, cfg.start_y, 0.0],
                                     dev).expand(W, 3), 0.0)


def init_batch(cfg: SimConfig, gen: torch.Generator, num_worlds: int,
               device="cuda") -> State:
    """`num_worlds` independent worlds (engine.py:286-302), their spawns
    drawn from `gen`."""
    return generate_world(cfg, num_worlds, gen, device)


def reset_world(cfg: SimConfig, s: State, reset_u) -> State:
    """resetWorld (src/gen.cpp:216-316; engine.py:192-236) of every world,
    `reset_u` (W, 3): the quarter rollover of a full game, else a fresh
    GameState; then agents, ball and hoops."""
    g = s.game
    rollover = (g.game_clock <= 0.0) & (g.is_one_on_one == 0)
    cont = (g.period < 4.0) | (g.team0_score == g.team1_score)
    rc = rollover & cont

    def pick(roll_val, fresh_val):
        return torch.where(rollover, roll_val, fresh_val)

    g = R(g,
          period=pick(torch.where(rc, g.period + 1.0, g.period), 1.0),
          game_clock=pick(torch.where(rc, cfg.time_per_period, g.game_clock),
                          cfg.time_per_period),
          shot_clock=pick(torch.where(rc, cfg.shot_clock_duration,
                                      g.shot_clock),
                          cfg.shot_clock_duration),
          live_ball=pick(rc.to(I32), 1).to(I32),
          inbounding_in_progress=pick(torch.where(
              rc, 0, g.inbounding_in_progress), 0).to(I32),
          team_in_possession=pick(g.team_in_possession, 0.0),
          team0_score=pick(g.team0_score, 0.0),
          team1_score=pick(g.team1_score, 0.0),
          scored_baskets=pick(g.scored_baskets, 0.0),
          oob_count=pick(g.oob_count, 0.0),
          inbound_clock=pick(g.inbound_clock, 0.0))
    s = R(s, game=g)
    s = _reset_agent_common(cfg, s, 1.0, C.RESET_TEAM_COLORS)
    s, ball_spawn = _setup_agent_positions(cfg, s, reset_u)
    s = _reset_ball(cfg, s, ball_spawn, 1.0)
    h = s.hoops
    return R(s, hoops=R(h, reset=torch.zeros_like(h.reset),
                        done=torch.ones_like(h.done),
                        cur_step=torch.zeros_like(h.cur_step)))


def reset_system(cfg: SimConfig, s: State, reset_u) -> State:
    """14. resetSystem (src/game.cpp:957-967): the worlds whose reset_now
    is set take `reset_world`'s result."""
    do = s.reset_now == 1
    out = tree_select(do, reset_world(cfg, s, reset_u), s)
    return R(out, reset_now=torch.where(do, 0, out.reset_now))


def step_core(cfg: SimConfig, s: State, noise: S.StepNoise) -> State:
    """One tick of every world, the systems in the reference's taskgraph
    order (src/game.cpp:1463-1526)."""
    s = S.tick_system(cfg, s)
    s = S.action_mask_system(cfg, s)
    s = S.move_agent_system(cfg, s)
    s = S.grab_system(cfg, s)
    s = S.pass_system(cfg, s)
    s = S.shoot_system(cfg, s, noise)
    s = S.move_ball_system(cfg, s)
    s = S.update_shot_pct_system(cfg, s)
    s = S.score_system(cfg, s)
    s = S.out_of_bounds_system(cfg, s)
    s = S.update_last_touch_system(cfg, s)
    s = S.clock_system(cfg, s)
    s = S.inbound_violation_system(cfg, s)
    s = reset_system(cfg, s, noise.reset_u)
    s = S.update_points_worth_system(cfg, s)
    s = S.agent_collision_system(cfg, s)
    s = S.hard_code_defense_system(cfg, s)
    s = S.fill_observations_system(cfg, s)
    s = S.reward_system(cfg, s)
    return s


def step(cfg: SimConfig, s: State, gen: torch.Generator,
         noise: S.StepNoise | None = None) -> State:
    """Draw the tick's noise from `gen` (unless given), then the chain."""
    if noise is None:
        noise = S.draw_noise(cfg, gen, s.reset_now.shape[0],
                             s.reset_now.device)
    return step_core(cfg, s, noise)


step_batch = step  # the whole fleet in lockstep: every call is batched
