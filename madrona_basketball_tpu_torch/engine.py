"""World generation straight into the SoA rows (port of
`madrona_basketball_tpu.engine.generate_world` / `init_batch` +
`ops.layout.pack`, engine.py:156-190,286-302 and ops/layout.py:90).

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
from .ops.layout import F_IDX, I_IDX, N_F32_ROWS, N_I32_ROWS

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
