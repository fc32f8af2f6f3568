"""Structured view of the fleet state (port of `madrona_basketball_tpu.state`,
state.py:31-118).

Plain dataclasses of torch tensors with a leading world axis, built from
the SoA rows by `ops.layout.unpack` (single fields are row views, grouped
ones stacked copies).  They carry the fields that the export (export.py)
reads.  The engine writes new rows on every step instead of
updating them, so a view stays a snapshot of the step it was taken at.
Dtypes are honest (int fields int32, float fields float32); the
reference's bit-reinterpreted exports are made in export.py.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class Agents:
    """Per-agent columns, (W, A, ...) (src/types.hpp:225-242)."""

    pos: Tensor             # (W, A, 3) f32
    orient: Tensor          # (W, A, 4) f32 quaternion (w, x, y, z)
    action: Tensor          # (W, A, 6) i32 move angle rotate grab pass shoot
    action_mask: Tensor     # (W, A, 4) i32 can move / grab / pass / shoot
    reset: Tensor           # (W, A) i32
    reward: Tensor          # (W, A) f32
    done: Tensor            # (W, A) f32
    has_ball: Tensor        # (W, A) i32
    held_ball_id: Tensor    # (W, A) i32
    points_worth: Tensor    # (W, A) i32
    team: Tensor            # (W, A) i32
    team_color: Tensor      # (W, A, 3) f32
    defending_hoop: Tensor  # (W, A) i32
    stat_points: Tensor     # (W, A) f32
    stat_fouls: Tensor      # (W, A) f32
    obs: Tensor | None      # (W, A, 128) f32, when the view was given obs


@dataclasses.dataclass
class Ball:
    """The basketball (src/types.hpp:244-253), (W, ...)."""

    pos: Tensor                 # (W, 3) f32
    vel: Tensor                 # (W, 3) f32
    grabbed: Tensor             # (W,) i32
    holder: Tensor              # (W,) i32
    in_flight: Tensor           # (W,) i32
    last_touched_agent: Tensor  # (W,) i32
    last_touched_team: Tensor   # (W,) i32
    shot_by_agent: Tensor       # (W,) i32
    shot_by_team: Tensor        # (W,) i32
    shot_point_value: Tensor    # (W,) i32
    shot_going_in: Tensor       # (W,) i32


@dataclasses.dataclass
class Hoops:
    """Per-hoop columns (src/types.hpp:255-263), (W, H, ...)."""

    pos: Tensor       # (W, H, 3) f32, from the config


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
    """The fleet's state as the export reads it; the JAX State's RNG key
    lives in the engine's torch.Generator instead."""

    agents: Agents
    ball: Ball
    hoops: Hoops
    game: GameState
