"""The reference's tensor export (port of `madrona_basketball_tpu.export`,
export.py:30-107; src/mgr.cpp:315-445, bound in src/bindings.cpp:65-100).

Named tensors over a structured `state.State` view with the reference's
logical shapes.  The reference bit-reinterprets some fields (GameState's
five int fields through a float tensor, team colours and stats floats
through int tensors, src/mgr.cpp:323-327,392-403); by default the export
casts values instead, and `bitcast_compat=True` gives the raw bit
patterns.
"""

from __future__ import annotations

import torch

from . import constants as C
from .state import State

F32 = torch.float32
I32 = torch.int32


def game_state_tensor(s: State) -> torch.Tensor:
    """(W, 14) float32 in the field order of src/types.hpp:46-67."""
    g = s.game
    return torch.stack([
        g.inbounding_in_progress.to(F32), g.live_ball.to(F32), g.period,
        g.team_in_possession, g.team0_hoop.to(F32), g.team0_score,
        g.team1_hoop.to(F32), g.team1_score, g.game_clock, g.shot_clock,
        g.scored_baskets, g.oob_count, g.inbound_clock,
        g.is_one_on_one.to(F32)], dim=-1)


def export_tensors(s: State, bitcast_compat: bool = False) -> dict:
    """Every reference tensor, keyed by its binding name without
    `_tensor`; the view must carry obs."""
    a, b, h = s.agents, s.ball, s.hoops
    W = a.pos.shape[0]
    dev = a.pos.device

    def cast_f2i(x):
        return x.contiguous().view(I32) if bitcast_compat else x.to(I32)

    gs = game_state_tensor(s)
    if bitcast_compat:
        g = s.game
        for col, x in ((0, g.inbounding_in_progress), (1, g.live_ball),
                       (4, g.team0_hoop), (6, g.team1_hoop),
                       (13, g.is_one_on_one)):
            gs[:, col] = x.contiguous().view(F32)

    return {
        # general
        "reset": a.reset[..., None],                         # (W, A, 1) i32
        "game_state": gs,                                    # (W, 14) f32
        # agents
        "action": a.action,                                  # (W, A, 6) i32
        "action_mask": a.action_mask,                        # (W, A, 4) i32
        "observations": a.obs,                               # (W, A, 128) f32
        "reward": a.reward,                                  # (W, A) f32
        "done": a.done,                                      # (W, A) f32
        "agent_pos": a.pos,                                  # (W, A, 3) f32
        "orientation": a.orient,                             # (W, A, 4) f32
        "agent_possession": torch.stack(
            [a.has_ball, a.held_ball_id, a.points_worth], dim=-1),
        "agent_team": torch.cat(
            [a.team[..., None], cast_f2i(a.team_color),
             a.defending_hoop[..., None]], dim=-1),          # (W, A, 5) i32
        "agent_stats": cast_f2i(torch.stack(
            [a.stat_points, a.stat_fouls], dim=-1)),         # (W, A, 2) i32
        "agent_entity_id": torch.tensor(
            C.AGENT_IDS, dtype=I32, device=dev).expand(W, len(C.AGENT_IDS)),
        # ball
        "basketball_pos": b.pos[:, None, :],                 # (W, 1, 3) f32
        "ball_physics": torch.stack(
            [b.in_flight, b.last_touched_agent, b.last_touched_team,
             b.shot_by_agent, b.shot_by_team, b.shot_point_value,
             b.shot_going_in], dim=-1)[:, None, :],          # (W, 1, 7) i32
        "ball_grabbed": torch.stack(
            [b.grabbed, b.holder], dim=-1)[:, None, :],      # (W, 1, 2) i32
        "ball_velocity": b.vel[:, None, :],                  # (W, 1, 3) f32
        "ball_entity_id": torch.full((W, 1), C.BALL_ID, dtype=I32,
                                     device=dev),
        # hoops
        "hoop_pos": h.pos,                                   # (W, H, 3) f32
    }
