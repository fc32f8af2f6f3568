"""The structured engine of the port (systems.py, engine.py::step_core,
maths.py) vs the JAX package's (systems.py, engine.py, maths.py) on the
same states and injected `StepNoise`, and vs the port's own rows tick.

States: 64 worlds stepped by the rows tick (`step_rows_plain`) with
random actions, then edited per world so that every branch fires: a
grab within reach, a game clock about to expire, an inbound violation,
the ball out of bounds, a shot about to score, reset_now and Reset flags
set, half the worlds in full-game rules (GameState.isOneOnOne is read at
run time).  Each system runs once on those states on both sides (the JAX
one under `vmap`, jitted), with tag rules off and, for the systems that
read them, on.

Tolerances: integer fields exact; float fields 2e-5 relative / 2e-5
absolute (XLA:CPU's atan2, sin, cos, acos, erf and exp against torch's,
and XLA's fused multiply-adds; the largest difference seen is ~4e-6).
Worlds within the F1 band of the going-in decision
(tests/test_torch_shot_xla.py) would be excepted; none of these draws
falls in it, so the test asserts every world.  The structured tick equals
the rows tick after `layout.pack`: integer rows exact, float rows 1e-5
absolute, one tick from the same rows at each of 20 points of a rows
trajectory in each game mode."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import engine as JE
from madrona_basketball_tpu import maths as JM
from madrona_basketball_tpu import systems as JS
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.ops import layout as JL

from madrona_basketball_tpu_torch import constants as C
from madrona_basketball_tpu_torch import engine as E
from madrona_basketball_tpu_torch import maths as M
from madrona_basketball_tpu_torch import systems as S
from madrona_basketball_tpu_torch.config import GAME_MODES, SimConfig
from madrona_basketball_tpu_torch.engine_fused import draw_noise_rows
from madrona_basketball_tpu_torch.ops import layout as L
from madrona_basketball_tpu_torch.ops.fused_step import step_rows_plain
from madrona_basketball_tpu_torch.state import tree_select

W = 64
RTOL = ATOL = 2e-5
BUCKETS = (2, 8, 3, 2, 2, 2)


def _random_actions(si, gen):
    for a in range(2):
        for j, n in enumerate(BUCKETS):
            si[L.ACTION_ROWS[a][j]] = torch.randint(0, n, (si.shape[1],),
                                                    generator=gen,
                                                    dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def _rows(seed=0):
    """Rows of W varied worlds (numpy), the obs rows and the noise of the
    tick under test."""
    cfg = GAME_MODES["1v1"]
    gen = torch.Generator().manual_seed(seed)
    sf, si = E.init_rows(cfg, W, gen, "cpu")
    for _ in range(25):
        _random_actions(si, gen)
        sf, si, obs = step_rows_plain(cfg, sf, si, draw_noise_rows(W, gen,
                                                                   "cpu"))
    _random_actions(si, gen)
    for a in range(2):
        for j in range(4):
            si[I(f"a{a}.{L.MASK_NAMES[j]}")] = torch.randint(
                0, 2, (W,), generator=gen, dtype=torch.int32)
    sf, si = sf.numpy().copy(), si.numpy().copy()
    w = np.arange(W)
    rng = np.random.RandomState(seed)
    sel = w % 8

    def f(name, mask, value):
        sf[L.F_IDX[name], mask] = value

    def i_(name, mask, value):
        si[L.I_IDX[name], mask] = value

    # a grab within reach, the ball loose
    m = sel == 0
    f("bpos_x", m, sf[L.F_IDX["a0.pos_x"], m] + 0.1)
    f("bpos_y", m, sf[L.F_IDX["a0.pos_y"], m])
    i_("bgrabbed", m, 0)
    i_("bholder", m, C.ENTITY_ID_PLACEHOLDER)
    i_("binflight", m, 0)
    i_("a0.has_ball", m, 0)
    i_("a0.held_ball", m, C.ENTITY_ID_PLACEHOLDER)
    i_("a0.a_grab", m, 1)
    i_("a0.m_grab", m, 1)
    # the game clock about to expire
    f("gclock", sel == 1, 0.01)
    # an inbound violation
    m = sel == 2
    i_("ginb", m, 1)
    f("iclock", m, 0.0)
    i_("a1.im_inb", m, 1)
    i_("a1.held_ball", m, C.BALL_ID)
    # the ball out of bounds
    f("bpos_x", sel == 3, C.COURT_MIN_X - 0.5)
    # a shot about to score
    m = sel == 4
    hoop = L.hoop_positions(SimConfig()).numpy()
    f("bpos_x", m, hoop[0, 0] + 0.05)
    f("bpos_y", m, hoop[0, 1])
    i_("binflight", m, 1)
    i_("bspv", m, 3)
    i_("bsb_agent", m, C.AGENT_IDS[0])
    i_("bsgi", m, 1)
    i_("bgrabbed", m, 0)
    i_("bholder", m, C.ENTITY_ID_PLACEHOLDER)
    # resets
    i_("reset_now", sel == 5, 1)
    i_("a1.reset", sel == 6, 1)
    # full-game rules in half the worlds
    i_("is1v1", w % 2 == 1, 0)
    f("t0score", w % 4 == 1, rng.randint(0, 9, (W // 4,)))
    f("period", w % 16 == 1, 4.0)
    noise = draw_noise_rows(W, gen, "cpu").numpy()
    return sf, si, obs.numpy(), noise


def I(name):
    return L.I_IDX[name]


def _port_state(cfg, sf, si, obs):
    s = L.unpack(cfg, torch.tensor(sf), torch.tensor(si))
    return dataclasses.replace(s, agents=dataclasses.replace(
        s.agents, obs=torch.tensor(obs).reshape(2, C.OBS_SIZE, W)
        .permute(2, 0, 1).contiguous()))


def _jax_state(jcfg, sf, si, obs):
    return JL.unpack(jcfg, jnp.asarray(sf), jnp.asarray(si),
                     jax.random.split(jax.random.PRNGKey(0), W),
                     obs=jnp.asarray(obs))


def _jax_noise(noise):
    return JS.StepNoise(shot_u=jnp.asarray(noise[:6].T.reshape(W, 2, 3)),
                        reset_u=jnp.asarray(noise[6:].T))


def _compare(got, want, msg):
    gsf, gsi = (x.numpy() for x in L.pack(got))
    wsf, wsi = (np.asarray(x) for x in JL.pack(want))
    for name, idx in L.I_IDX.items():
        np.testing.assert_array_equal(gsi[idx], wsi[idx],
                                      err_msg=f"{msg}: {name}")
    for name, idx in L.F_IDX.items():
        np.testing.assert_allclose(gsf[idx], wsf[idx], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{msg}: {name}")
    np.testing.assert_allclose(got.agents.obs.numpy(),
                               np.asarray(want.agents.obs), rtol=RTOL,
                               atol=ATOL, err_msg=f"{msg}: obs")


SYSTEMS = ["tick_system", "action_mask_system", "move_agent_system",
           "grab_system", "pass_system", "shoot_system", "move_ball_system",
           "update_shot_pct_system", "score_system", "out_of_bounds_system",
           "update_last_touch_system", "clock_system",
           "inbound_violation_system", "reset_system",
           "update_points_worth_system", "agent_collision_system",
           "hard_code_defense_system", "fill_observations_system",
           "reward_system", "step_core", "reset_world"]
TAG_READERS = {"action_mask_system", "agent_collision_system", "step_core"}


def _call(mod, name, cfg, s, noise):
    if name in ("shoot_system", "step_core"):
        return getattr(mod, name)(cfg, s, noise)
    if name in ("reset_system", "reset_world"):
        return getattr(mod, name)(cfg, s, noise.reset_u)
    return getattr(mod, name)(cfg, s)


@pytest.mark.parametrize("name, tag", [(n, False) for n in SYSTEMS] +
                         [(n, True) for n in SYSTEMS if n in TAG_READERS])
def test_system_matches_jax(name, tag):
    cfg, jcfg = SimConfig(tag_mode=tag), JSimConfig(tag_mode=tag)
    sf, si, obs, noise = _rows()
    jmod = JE if name in ("reset_system", "reset_world", "step_core") \
        else JS
    fn = jax.jit(jax.vmap(lambda s, n: _call(jmod, name, jcfg, s, n)))
    want = fn(_jax_state(jcfg, sf, si, obs), _jax_noise(noise))
    got = _call(E if jmod is JE else S, name, cfg,
                _port_state(cfg, sf, si, obs),
                S.StepNoise.from_rows(torch.tensor(noise)))
    _compare(got, want, name)


@pytest.mark.parametrize("mode", ["tag", "1v1", "full"])
def test_structured_tick_equals_rows_tick(mode):
    """One tick from the same rows, 20 times along a rows trajectory with
    random actions (each tick starts from the rows tick's state, so float
    differences do not carry over)."""
    cfg = GAME_MODES[mode]
    gen = torch.Generator().manual_seed(11)
    sf, si = E.init_rows(cfg, W, gen, "cpu")
    obs = torch.zeros((2 * C.OBS_SIZE, W))
    for k in range(20):
        _random_actions(si, gen)
        noise = draw_noise_rows(W, gen, "cpu")
        state = E.step_core(cfg, L.unpack(cfg, sf, si, obs),
                            S.StepNoise.from_rows(noise))
        sf, si, obs = step_rows_plain(cfg, sf, si, noise)
        gsf, gsi = L.pack(state)
        assert torch.equal(gsi, si), f"tick {k}"
        torch.testing.assert_close(gsf, sf, rtol=0, atol=1e-5,
                                   msg=f"tick {k}")
        torch.testing.assert_close(
            state.agents.obs.permute(1, 2, 0).reshape(2 * C.OBS_SIZE, W),
            obs, rtol=0, atol=1e-5, msg=f"tick {k} obs")


def test_init_batch_packs_to_init_rows_and_draws_like_it():
    for mode in ("tag", "full"):
        cfg = GAME_MODES[mode]
        s = E.init_batch(cfg, torch.Generator().manual_seed(4), 64, "cpu")
        sf, si = E.init_rows(cfg, 64, torch.Generator().manual_seed(4), "cpu")
        gsf, gsi = L.pack(s)
        assert torch.equal(gsf, sf) and torch.equal(gsi, si)
        back = L.unpack(cfg, gsf, gsi)
        for x, y in zip(L.pack(back), (sf, si)):
            assert torch.equal(x, y)


def test_step_draws_its_noise_in_the_rows_layout():
    cfg = SimConfig()
    s = E.init_batch(cfg, torch.Generator().manual_seed(2), 32, "cpu")
    a = E.step(cfg, s, torch.Generator().manual_seed(9))
    rows = draw_noise_rows(32, torch.Generator().manual_seed(9), "cpu")
    assert torch.equal(S.StepNoise.from_rows(rows).rows(), rows)
    b = E.step_core(cfg, s, S.StepNoise.from_rows(rows))
    for x, y in zip(L.pack(a), L.pack(b)):
        assert torch.equal(x, y)


def test_tree_select_picks_worlds():
    cfg = SimConfig()
    a = E.init_batch(cfg, torch.Generator().manual_seed(1), 8, "cpu")
    b = E.init_batch(cfg, torch.Generator().manual_seed(2), 8, "cpu")
    pred = torch.arange(8) % 2 == 0
    m = tree_select(pred, a, b)
    for x, y, z in zip(L.pack(m), L.pack(a), L.pack(b)):
        assert torch.equal(x[:, 0::2], y[:, 0::2])
        assert torch.equal(x[:, 1::2], z[:, 1::2])


def test_maths_matches_jax():
    rng = np.random.RandomState(6)
    u = rng.normal(size=(64, 3)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[:4] = u[:4]                       # aligned
    v[4:8] = -u[4:8]                    # opposite
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ang = rng.uniform(-3, 3, 64).astype(np.float32)
    ax = u / np.linalg.norm(u, axis=1, keepdims=True)
    cases = [
        (M.find_rotation_between_vectors, JM.find_rotation_between_vectors,
         (u, v)),
        (M.quat_mul, JM.quat_mul, (q, q[::-1].copy())),
        (M.quat_rotate, JM.quat_rotate, (q, u)),
        (M.quat_angle_axis, JM.quat_angle_axis, (ang, ax)),
        (M.safe_normalize, JM.safe_normalize, (u,)),
        (M.normalize_unsafe, JM.normalize_unsafe, (u,)),
        (M.length, JM.length, (u,)),
    ]
    for fn, jfn, args in cases:
        got = fn(*(torch.tensor(x) for x in args)).numpy()
        want = np.asarray(jax.vmap(jfn)(*(jnp.asarray(x) for x in args)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=fn.__name__)
    verts = rng.normal(size=(64, 4, 3)).astype(np.float32)
    lo, hi = M.project_rectangle(torch.tensor(verts), torch.tensor(u))
    jlo, jhi = jax.vmap(JM.project_rectangle)(jnp.asarray(verts),
                                              jnp.asarray(u))
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(M.projections_overlap(lo, hi, lo + 1, hi + 1),
                       torch.tensor(np.asarray(JM.projections_overlap(
                           jlo, jhi, jlo + 1, jhi + 1))))
