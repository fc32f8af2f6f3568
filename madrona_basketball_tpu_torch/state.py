"""The structured fleet state (port of `madrona_basketball_tpu.state`,
state.py:31-229).

Plain dataclasses of torch tensors with a leading world axis W: the JAX
package keeps one world per pytree and batches with `vmap`; here every
field carries the fleet.  Dtypes are honest (int fields int32, float
fields float32); the reference's bit-reinterpreted exports are made in
export.py.  The JAX State's per-world RNG key lives in a torch.Generator
of the caller instead (systems.py::draw_noise).

Two uses:
  * the structured engine (engine.py, systems.py) steps a `State`, each
    system returning a new one;
  * `ops.layout.unpack` builds the same `State` from the SoA rows, the
    view that the export (export.py) reads; its `obs` is None when the
    view was not given the obs rows.
"""

from __future__ import annotations

import dataclasses

import torch

from . import constants as C
from .config import SimConfig

Tensor = torch.Tensor
F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass
class Agents:
    """Per-agent component columns, (W, A, ...) (src/types.hpp:225-242)."""

    pos: Tensor              # (W, A, 3) f32 - Position
    vel: Tensor              # (W, A, 3) f32 - Velocity (m/s)
    orient: Tensor           # (W, A, 4) f32 quaternion (w, x, y, z)
    action: Tensor           # (W, A, 6) i32 move angle rotate grab pass shoot
    action_mask: Tensor      # (W, A, 4) i32 can move / grab / pass / shoot
    reset: Tensor            # (W, A) i32
    reward: Tensor           # (W, A) f32
    done: Tensor             # (W, A) f32
    cur_step: Tensor         # (W, A) i32
    has_ball: Tensor         # (W, A) i32
    held_ball_id: Tensor     # (W, A) i32
    points_worth: Tensor     # (W, A) i32
    im_inbounding: Tensor    # (W, A) i32
    allowed_to_move: Tensor  # (W, A) i32 (written, never read)
    team: Tensor             # (W, A) i32
    team_color: Tensor       # (W, A, 3) f32
    defending_hoop: Tensor   # (W, A) i32
    grab_cooldown: Tensor    # (W, A) f32
    stat_points: Tensor      # (W, A) f32
    stat_fouls: Tensor       # (W, A) f32
    max_speed: Tensor        # (W, A) f32
    quickness: Tensor        # (W, A) f32
    shooting: Tensor         # (W, A) f32
    ft_pct: Tensor           # (W, A) f32
    reaction_speed: Tensor   # (W, A) f32
    target_pos: Tensor       # (W, A, 3) f32
    shot_pct: Tensor         # (W, A) f32
    obs: Tensor | None       # (W, A, 128) f32


@dataclasses.dataclass
class Ball:
    """The basketball (src/types.hpp:244-253), (W, ...)."""

    pos: Tensor                 # (W, 3) f32
    vel: Tensor                 # (W, 3) f32 - displacement per step
    grabbed: Tensor             # (W,) i32
    holder: Tensor              # (W,) i32
    in_flight: Tensor           # (W,) i32
    last_touched_agent: Tensor  # (W,) i32
    last_touched_team: Tensor   # (W,) i32
    shot_by_agent: Tensor       # (W,) i32
    shot_by_team: Tensor        # (W,) i32
    shot_point_value: Tensor    # (W,) i32
    shot_going_in: Tensor       # (W,) i32
    reset: Tensor               # (W,) i32
    done: Tensor                # (W,) f32
    cur_step: Tensor            # (W,) i32


@dataclasses.dataclass
class Hoops:
    """Per-hoop columns (src/types.hpp:255-263), (W, H, ...)."""

    pos: Tensor          # (W, H, 3) f32
    zone_radius: Tensor  # (W, H) f32
    zone_height: Tensor  # (W, H) f32
    zone_center: Tensor  # (W, H, 3) f32
    reset: Tensor        # (W, H) i32
    done: Tensor         # (W, H) f32
    cur_step: Tensor     # (W, H) i32


@dataclasses.dataclass
class GameState:
    """The GameState singleton (src/types.hpp:46-67), (W,)."""

    inbounding_in_progress: Tensor  # i32
    live_ball: Tensor               # i32
    period: Tensor                  # f32
    team_in_possession: Tensor      # f32
    team0_hoop: Tensor              # i32
    team0_score: Tensor             # f32
    team1_hoop: Tensor              # i32
    team1_score: Tensor             # f32
    game_clock: Tensor              # f32
    shot_clock: Tensor              # f32
    scored_baskets: Tensor          # f32
    oob_count: Tensor               # f32
    inbound_clock: Tensor           # f32
    is_one_on_one: Tensor           # i32


@dataclasses.dataclass
class State:
    """The fleet's full simulation state."""

    agents: Agents
    ball: Ball
    hoops: Hoops
    game: GameState
    reset_now: Tensor  # (W,) i32 - the WorldClock singleton


def zero_state(cfg: SimConfig, num_worlds: int, device="cuda") -> State:
    """The all-zero skeleton of `num_worlds` worlds (state.py:121-206) that
    engine.generate_world fills."""
    A, H, W = cfg.num_agents, cfg.num_hoops, num_worlds
    dev = torch.device(device)

    def full(shape, v, dtype):
        return torch.full((W,) + tuple(shape), v, dtype=dtype, device=dev)

    def z(*shape, dtype=F32):
        return full(shape, 0, dtype)

    orient = z(A, 4)
    orient[..., 0] = 1.0
    agents = Agents(
        pos=z(A, 3), vel=z(A, 3), orient=orient,
        action=z(A, 6, dtype=I32), action_mask=z(A, 4, dtype=I32),
        reset=z(A, dtype=I32), reward=z(A), done=z(A),
        cur_step=z(A, dtype=I32), has_ball=z(A, dtype=I32),
        held_ball_id=full((A,), C.ENTITY_ID_PLACEHOLDER, I32),
        points_worth=full((A,), 2, I32), im_inbounding=z(A, dtype=I32),
        allowed_to_move=full((A,), 1, I32),
        team=(torch.arange(A, dtype=I32, device=dev) % 2).expand(W, A)
        .clone(),
        team_color=z(A, 3), defending_hoop=z(A, dtype=I32),
        grab_cooldown=z(A), stat_points=z(A), stat_fouls=z(A),
        max_speed=z(A), quickness=z(A), shooting=z(A), ft_pct=z(A),
        reaction_speed=z(A), target_pos=z(A, 3), shot_pct=z(A),
        obs=z(A, C.OBS_SIZE))
    ph = C.ENTITY_ID_PLACEHOLDER
    ball = Ball(
        pos=z(3), vel=z(3), grabbed=z(dtype=I32), holder=full((), ph, I32),
        in_flight=z(dtype=I32), last_touched_agent=full((), ph, I32),
        last_touched_team=full((), ph, I32), shot_by_agent=full((), ph, I32),
        shot_by_team=full((), ph, I32), shot_point_value=full((), 2, I32),
        shot_going_in=z(dtype=I32), reset=z(dtype=I32), done=z(),
        cur_step=z(dtype=I32))
    hoops = Hoops(
        pos=z(H, 3), zone_radius=full((H,), C.HOOP_SCORE_ZONE_SIZE, F32),
        zone_height=full((H,), 0.1, F32), zone_center=z(H, 3),
        reset=z(H, dtype=I32), done=z(H), cur_step=z(H, dtype=I32))
    game = GameState(
        inbounding_in_progress=z(dtype=I32), live_ball=full((), 1, I32),
        period=full((), 1.0, F32), team_in_possession=z(),
        team0_hoop=full((), C.HOOP_IDS[0], I32), team0_score=z(),
        team1_hoop=full((), C.HOOP_IDS[1], I32), team1_score=z(),
        game_clock=full((), cfg.time_per_period, F32),
        shot_clock=full((), cfg.shot_clock_duration, F32),
        scored_baskets=z(), oob_count=z(), inbound_clock=z(),
        is_one_on_one=full((), 1 if cfg.one_on_one else 0, I32))
    return State(agents=agents, ball=ball, hoops=hoops, game=game,
                 reset_now=z(dtype=I32))


def tree_map(fn, *trees):
    """`fn` over the tensors of one or more equal dataclass trees (None
    leaves stay None)."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0):
        return type(t0)(**{f.name: tree_map(fn, *(getattr(t, f.name)
                                                  for t in trees))
                           for f in dataclasses.fields(t0)})
    if t0 is None:
        return None
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The tensors of a dataclass tree, in field order."""
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    return [] if tree is None else [tree]


def tree_select(pred: Tensor, on_true, on_false):
    """Per-world `where` over two equal trees (state.py:209-224): pred
    (W,) bool picks each world's fields from `on_true` or `on_false`
    (the merge of the functional reset_world into the live state,
    src/game.cpp:963)."""
    def sel(t, f):
        return torch.where(pred.reshape((-1,) + (1,) * (t.dim() - 1)), t, f)
    return tree_map(sel, on_true, on_false)
