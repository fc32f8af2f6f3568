"""Plain torch sim tick (`step_rows_plain`, and `fused_step` on CPU
tensors) vs the JAX `fused_step_xla`, in all three game modes.

State comes from `layout.pack(engine.init_batch(...))`, noise and actions
are injected from numpy, and Reset flags are pulsed for some worlds.  A
few worlds are staged so that within the run a ball is shot, scores,
goes out of bounds and the world resets.  Integer rows must match
exactly, float rows to 1e-5 (the JAX/torch CPU rounding tier,
tests/test_rollout_kernel.py:109-138)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import engine
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.ops import layout as JL
from madrona_basketball_tpu.ops.fused_step import fused_step_xla

from madrona_basketball_tpu_torch.config import GAME_MODES
from madrona_basketball_tpu_torch.ops.fused_step import (fused_step,
                                                         step_rows_plain)
from madrona_basketball_tpu_torch.ops.layout import F_IDX, I_IDX

W, TICKS = 128, 8
_KW = {"tag": {}, "1v1": {"tag_mode": False},
       "full": {"one_on_one": False, "tag_mode": False}}
_BUCKETS = (2, 8, 3, 2, 2, 2)
_ACT = ("a_move", "a_angle", "a_rotate", "a_grab", "a_pass", "a_shoot")


def _stage(sf, si):
    """Worlds 0-3 aim a shot straight down the court from close range,
    worlds 4-7 sit on the sideline, so scoring / OOB paths run."""
    sf, si = np.array(sf), np.array(si)
    for k in range(4):
        hx = 28.75 if si[I_IDX["a0.defend_hoop"], k] == 0 else 3.25
        sf[F_IDX["a0.pos_x"], k] = hx - 0.5 * (1 if hx > 16 else -1)
        sf[F_IDX["a0.pos_y"], k] = 8.5
        sf[F_IDX["bpos_x"], k] = sf[F_IDX["a0.pos_x"], k]
        sf[F_IDX["bpos_y"], k] = 8.5
    for k in range(4, 8):
        sf[F_IDX["a0.pos_y"], k] = 0.9
        sf[F_IDX["bpos_y"], k] = 0.9
    return sf, si


@pytest.mark.parametrize("mode", sorted(_KW))
def test_step_matches_fused_step_xla(mode):
    jcfg = JSimConfig(**_KW[mode])
    cfg = GAME_MODES[mode]
    sf, si = JL.pack(engine.init_batch(jcfg, jax.random.PRNGKey(3), W))
    sf, si = _stage(sf, si)
    rng = np.random.RandomState(7)
    events = {"shots": 0, "resets": 0, "oob": 0, "inbound": 0}
    for t in range(TICKS):
        for i in range(2):
            for n, b in zip(_ACT, _BUCKETS):
                si[I_IDX[f"a{i}.{n}"]] = rng.randint(0, b, W)
            si[I_IDX[f"a{i}.a_shoot"], :8] = 1
            si[I_IDX[f"a{i}.reset"]] = (rng.uniform(size=W) < 0.05)
        noise = np.concatenate([rng.uniform(-1, 1, (8, W)),
                                rng.uniform(0, 1, (1, W))]).astype(np.float32)
        want = [np.asarray(x) for x in fused_step_xla(
            jcfg, jnp.asarray(sf), jnp.asarray(si), jnp.asarray(noise))]
        step = step_rows_plain if t % 2 else (
            lambda c, a, b, n: fused_step(c, a, b, n))
        got = [x.numpy() for x in step(cfg, torch.tensor(sf), torch.tensor(si),
                                       torch.tensor(noise))]
        np.testing.assert_array_equal(got[1], want[1], err_msg=f"tick {t}")
        np.testing.assert_allclose(got[0], want[0], atol=1e-5,
                                   err_msg=f"tick {t}")
        np.testing.assert_allclose(got[2], want[2], atol=1e-5,
                                   err_msg=f"tick {t}")
        events["shots"] += int(want[1][I_IDX["binflight"]].sum())
        events["resets"] += int((want[0][F_IDX["a0.done"]] > 0).sum())
        events["oob"] += int(want[0][F_IDX["oob"]].sum())
        events["inbound"] += int(want[1][I_IDX["ginb"]].sum())
        sf, si = np.array(want[0]), np.array(want[1])
    assert events["shots"] > 0 and events["resets"] > 0, events
    if mode == "full":
        assert events["oob"] > 0 or events["inbound"] > 0, events


def test_fused_step_rejects_bad_shapes():
    cfg = GAME_MODES["tag"]
    sf = torch.zeros((72, 4))
    si = torch.zeros((59, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_step(cfg, sf, si, torch.zeros((8, 4)))
    with pytest.raises(ValueError):
        fused_step(cfg, sf, si.float(), torch.zeros((9, 4)))
