"""The full rule set (`GAME_MODES["full"]`, the CLI's `--full-game`) held to
the benchmark's plain reference (`benchmark/reference/`), and the
reference's full-rule tick held to the JAX package's full game, on the
CPU at 64 worlds.

  * The reference's tick (`reference/sim.py::step_rows_plain`) against
    the JAX `fused_step_xla` tick by tick from the same rows (the JAX
    rows carried on): integer rows exact, float rows and obs to 1e-5 (the
    JAX / torch CPU rounding tier of tests/test_torch_step.py), in every
    world but those where the two decide a near-tie apart (two agents'
    collision axes whose overlaps tie, a unit vector between points a
    few cm apart): there a one-ulp nudge of one float row of the world's
    input has to make the reference give the JAX rows, and such worlds
    stay under 2 % of the world-ticks.  Worlds are staged so that within
    the run a shot scores, a loose ball goes out of bounds, an
    inbounder's 5-second clock runs out and a quarter's clock expires;
    the rest play random actions.  Each of the four events is asserted
    to occur.
  * The port's plain rollout, collect, three training iterations (with
    and without the frozen opponent) and kernel F's plain launch against
    the reference, bit for bit, as the tag tests of
    benchmark/tests/test_benchmark_reference.py hold them, from the port's
    rows with the same events staged.

The card's kernels B and F in full mode against their plain versions:
tests/test_torch_full_game_card.py (no JAX import there)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_basketball_tpu import engine as jengine
from madrona_basketball_tpu.config import SimConfig as JSimConfig
from madrona_basketball_tpu.ops import layout as JL
from madrona_basketball_tpu.ops.fused_step import fused_step_xla

from benchmark.drivers import train as drv
from benchmark.reference import iteration as R
from benchmark.reference import multistep as RM
from benchmark.reference import rollout as RR
from benchmark.reference import sim as RS
from benchmark.reference.config import GAME_MODES as REF_MODES
from madrona_basketball_tpu_torch.config import GAME_MODES
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.ops import fused_rollout as FR
from madrona_basketball_tpu_torch.ops import fused_step as FS
from madrona_basketball_tpu_torch.ops import rule_phases as RP
from madrona_basketball_tpu_torch.ops.layout import F_IDX, I_IDX
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_fused import (
    init_train_state, make_collect, make_train_iteration)
from madrona_basketball_tpu_torch.utils import profiling as P

from .full_game_rows import CLOCK, INBOUND, stage

CFG = GAME_MODES["full"]
W = 64
CPU = torch.device("cpu")
_BUCKETS = (2, 8, 3, 2, 2, 2)
_ACT = ("a_move", "a_angle", "a_rotate", "a_grab", "a_pass", "a_shoot")
def same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def _staged_rows():
    """The JAX full game's rows at 64 worlds, staged."""
    return stage(*(np.array(x) for x in JL.pack(jengine.init_batch(
        JSimConfig(one_on_one=False, tag_mode=False),
        jax.random.PRNGKey(19), W))))


def _staged_state(hp, seed):
    """The port's train state with its rows staged."""
    state = init_train_state(CFG, hp, seed, CPU)
    sf, si = stage(state.sf.numpy().copy(), state.si.numpy().copy())
    state.sf, state.si = torch.tensor(sf), torch.tensor(si)
    return state


def _agree(got, want) -> np.ndarray:
    """Per world: integer rows equal, float rows and obs within 1e-5."""
    return ((got[1] == want[1]).all(axis=0) &
            (np.abs(got[0] - want[0]) <= 1e-5).all(axis=0) &
            (np.abs(got[2] - want[2]) <= 1e-5).all(axis=0))


def _near_tie(cfg, sf, si, noise, want) -> bool:
    """Whether a one-ulp nudge of one float row of a world's input (the
    columns given) makes the reference give `want`."""
    for r in range(sf.shape[0]):
        for to in (np.inf, -np.inf):
            x = sf.copy()
            x[r] = np.nextafter(x[r], np.float32(to))
            got = [y.numpy() for y in RS.step_rows_plain(
                cfg, torch.tensor(x), torch.tensor(si), torch.tensor(noise))]
            if _agree(got, want).all():
                return True
    return False


def test_reference_tick_matches_the_jax_full_game():
    jcfg = JSimConfig(one_on_one=False, tag_mode=False)
    ref_cfg = REF_MODES["full"]
    sf, si = _staged_rows()
    rng = np.random.RandomState(23)
    events = dict(baskets=0, oob_turnovers=0, inbound_violations=0,
                  rollovers=0)
    ticks, ties = 40, []
    for t in range(ticks):
        for a in range(2):
            for n, b in zip(_ACT, _BUCKETS):
                si[I_IDX[f"a{a}.{n}"]] = rng.randint(0, b, W)
                si[I_IDX[f"a{a}.{n}"], INBOUND.start:INBOUND.stop] = 0
        noise = np.concatenate([rng.uniform(-1, 1, (8, W)),
                                rng.uniform(0, 1, (1, W))]).astype(np.float32)
        want = [np.asarray(x) for x in fused_step_xla(
            jcfg, jnp.asarray(sf), jnp.asarray(si), jnp.asarray(noise))]
        got = [x.numpy() for x in RS.step_rows_plain(
            ref_cfg, torch.tensor(sf), torch.tensor(si), torch.tensor(noise))]
        for k in np.flatnonzero(~_agree(got, want)):
            c = slice(k, k + 1)
            assert _near_tie(ref_cfg, sf[:, c], si[:, c], noise[:, c],
                             [x[:, c] for x in want]), f"tick {t} world {k}"
            ties.append((t, k))
        up = {n: want[0][F_IDX[n]] > sf[F_IDX[n]]
              for n in ("sbaskets", "oob", "period")}
        inbounding = si[I_IDX["ginb"]] == 1
        events["baskets"] += int(up["sbaskets"].sum())
        events["oob_turnovers"] += int((up["oob"] & ~inbounding).sum())
        events["inbound_violations"] += int((up["oob"] & inbounding).sum())
        events["rollovers"] += int(up["period"].sum())
        sf, si = np.array(want[0]), np.array(want[1])
    assert all(n > 0 for n in events.values()), events
    assert len(ties) <= 0.02 * ticks * W, ties


@pytest.mark.parametrize("frozen", [False, True])
def test_rollout_plain_matches_the_reference(frozen):
    hp = PPOParams(num_envs=W)
    st = _staged_state(hp, 9)
    obs = torch.rand((256, W), generator=torch.Generator().manual_seed(6))
    mats = FR.pack_policy(st.agent)
    fmats = FR.pack_policy(st.frozen) if frozen else None
    noise = FR.philox_noise(9, 0, 6, W, CPU)
    same(RR.rollout(REF_MODES["full"], st.sf, st.si, obs, mats, fmats,
                    n_steps=6, trainee_idx=1, noise=noise),
         FR.rollout_plain(CFG, st.sf, st.si, obs, mats, fmats, n_steps=6,
                          trainee_idx=1, noise=noise))


@pytest.mark.parametrize("frozen", [False, True])
def test_collect_matches_the_reference(frozen):
    hp = PPOParams(num_envs=W, num_rollout_steps=8, use_frozen=frozen)
    state = _staged_state(hp, 2 ** 31 + 91)
    state.counter = 3
    out = make_collect(CFG, hp, CPU)(state)
    ref = R.collect(REF_MODES["full"], hp, drv.snapshot(state))
    same(ref["traj"], out[1]["traj"])
    same((ref["sf"], ref["si"], ref["obs"]),
         (out[0].sf, out[0].si, out[0].obs))


@pytest.mark.parametrize("frozen", [False, True])
def test_three_iterations_match_the_reference(frozen):
    """Three iterations of the port's training iteration equal three of
    the reference's from the same staged state, every stage.  The tracer
    is on: its rule-phase counter sees mixed warps and rule events."""
    hp = PPOParams(num_envs=W, num_rollout_steps=8, use_frozen=frozen)
    state = _staged_state(hp, 2 ** 31 + 77)
    it = make_train_iteration(CFG, hp, CPU)
    ref = drv.snapshot(state)
    P.TRACER.start("cpu")
    try:
        RP.COUNTER.sample(state.sf, state.si)
        for _ in range(3):
            state, out = it(state)
            ref, ref_out = R.iteration(REF_MODES["full"], hp,
                                       copy.deepcopy(ref))
            same(drv.snapshot(state), ref)
            mine = drv.stage_outputs(out)
            same(mine, {k: ref_out[k] for k in mine})
    finally:
        ph = P.TRACER.stop()["counters"]["rule_phases"]
    assert ph["samples"] == 4 and ph["mixed_groups"] > 0, ph
    assert ph["baskets"] > 0 and ph["oob"] > 0 and ph["rollovers"] > 0, ph


@pytest.mark.parametrize("every", [True, False])
def test_multistep_plain_matches_the_reference(every):
    """Kernel F's plain launch over 40 ticks of the staged rows: the
    CLOCK worlds roll over into the second quarter."""
    seed = ((2 ** 31 + 5) << 32) | 9
    st = _staged_state(PPOParams(num_envs=W), 2)
    prog = FS.fused_multistep(CFG, st.sf, st.si, 40, seed=seed, tick_base=3,
                              obs_every_tick=every, blank_agent=0)
    same(RM.multistep(REF_MODES["full"], st.sf, st.si, torch.arange(W),
                      seed=seed, n_steps=40, tick_base=3, blank_agent=0),
         prog)
    assert bool((prog[0][F_IDX["period"], CLOCK.start:CLOCK.stop] ==
                 2.0).all())


def test_training_samples_the_rule_phase_counter_once_an_iteration():
    """With the tracer on, each eager iteration samples the counter after
    its writeback stamp; the counter's worlds add up to every world of
    every sample."""
    hp = PPOParams(num_envs=W, num_rollout_steps=4)
    state = init_train_state(CFG, hp, 17, CPU)
    it = make_train_iteration(CFG, hp, CPU)
    P.TRACER.start("cpu")
    try:
        for _ in range(3):
            state, _ = it(state)
    finally:
        rec = P.TRACER.stop()
    ph = rec["counters"]["rule_phases"]
    assert ph["samples"] == 3 and ph["groups"] == 3 * W // 32
    assert sum(ph["worlds"].values()) == 3 * W
    assert [n for n, _ in rec["stamps"]].count("writeback") == 3
