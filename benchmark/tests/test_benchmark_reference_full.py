"""The full rule set (`GAME_MODES["full"]`, the `full_game` cells): the
benchmark's frozen reference equals the port's plain versions bit for bit
(the full-mode twin of test_benchmark_reference.py), a sound run of each
new cell is correct and a broken one is not, on the CPU at sizes a test
run holds; and the program's rule-phase counter and the
`mixed_warp_share.train` reader give the hand-counted answer on handmade
rows, the tracer off adding nothing to the training or stepping path;
and B's and F's plain ticks counted under the full rules lie within 1 %
of the frozen counts taken on the tag tick."""

import copy
import json
import time
import types

import pytest
import torch

from benchmark import run as B
from benchmark.counts import multistep_F, rollout_B
from benchmark.drivers import train as drv
from benchmark.reference import iteration as R
from benchmark.reference import multistep as RM
from benchmark.reference import rollout as RR
from benchmark.reference import sim as RS
from benchmark.reference.config import GAME_MODES as REF_MODES
from madrona_basketball_tpu_torch.config import GAME_MODES
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.engine_fused import draw_noise_rows
from madrona_basketball_tpu_torch.ops import fused_rollout as FR
from madrona_basketball_tpu_torch.ops import fused_step as FS
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ops import rule_phases as RP
from madrona_basketball_tpu_torch.ops.layout import F_IDX, I_IDX
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_fused import (
    init_train_state, make_train_iteration)
from madrona_basketball_tpu_torch.utils import profiling as P

CFG = GAME_MODES["full"]
REF = REF_MODES["full"]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 4243
SIZES = {"full_game.train": (dict(num_envs=256, num_rollout_steps=8), {}),
         "full_game.step": (dict(num_envs=8), dict(ticks_per_launch=16))}


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


# ---- the frozen reference, bit for bit ----

def test_sim_tick_and_draws():
    sf, si = init_rows(CFG, 64, torch.Generator().manual_seed(3), CPU)
    noise = draw_noise_rows(64, torch.Generator().manual_seed(4), CPU)
    same(RS.step_rows_plain(REF, sf, si, noise),
         FS.step_rows_plain(CFG, sf, si, noise))


@pytest.mark.parametrize("every", [True, False])
def test_multistep_on_any_worlds(every):
    """Kernel F's plain launch (its in-kernel Philox) over 64 worlds, and
    the reference over all of them and over three alone."""
    seed = ((2 ** 31 + 77) << 32) | 3
    sf, si = init_rows(CFG, 64, torch.Generator().manual_seed(1), CPU)
    prog = FS.fused_multistep(CFG, sf, si, 12, seed=seed, tick_base=5,
                              obs_every_tick=every, blank_agent=0)
    same(RM.multistep(REF, sf, si, torch.arange(64), seed=seed, n_steps=12,
                      tick_base=5, blank_agent=0), prog)
    few = torch.tensor([3, 17, 40])
    same(RM.multistep(REF, sf[:, few], si[:, few], few, seed=seed,
                      n_steps=12, tick_base=5, blank_agent=0),
         tuple(x[:, few] for x in prog))


@pytest.mark.parametrize("frozen", [False, True])
def test_rollout(frozen):
    sf, si = init_rows(CFG, 64, torch.Generator().manual_seed(5), CPU)
    obs = torch.rand((256, 64), generator=torch.Generator().manual_seed(6))
    st = init_train_state(CFG, PPOParams(num_envs=64), 9, CPU)
    mats = FR.pack_policy(st.agent)
    fmats = FR.pack_policy(st.frozen) if frozen else None
    noise = FR.philox_noise(9, 0, 3, 64, CPU)
    same(RR.rollout(REF, sf, si, obs, mats, fmats, n_steps=3, trainee_idx=1,
                    noise=noise),
         FR.rollout_plain(CFG, sf, si, obs, mats, fmats, n_steps=3,
                          trainee_idx=1, noise=noise))


@pytest.mark.parametrize("frozen", [False, True])
def test_iteration_equals_the_program(frozen):
    """Two iterations of the reference from the program's state equal two
    of the program's iteration (its plain versions on the CPU)."""
    hp = PPOParams(num_envs=64, num_rollout_steps=4, use_frozen=frozen)
    seed = 2 ** 31 + 77
    state = init_train_state(CFG, hp, seed, CPU)
    it = make_train_iteration(CFG, hp, CPU)
    ref = drv.snapshot(state)
    for _ in range(2):
        state, out = it(state)
        ref, ref_out = R.iteration(REF, hp, copy.deepcopy(ref))
        same(drv.snapshot(state), ref)
        mine = drv.stage_outputs(out)
        same(mine, {k: ref_out[k] for k in mine})


# ---- the new cells, sound and broken, at test sizes ----

def plan(cell: str) -> dict:
    p = B.cell_plan(json.loads((B.ROOT / "BENCHMARK.json").read_text()),
                    cell)
    sizes, traffic = SIZES[cell]
    p["config"]["ppo"].update(sizes)
    p["config"].update(log_every=2, save_every=2)
    p["traffic"].update(traffic, profile_iterations=4, profile_launches=3)
    return p


def test_the_cells_run_the_full_rules():
    cfg = B.cell_plan(json.loads((B.ROOT / "BENCHMARK.json").read_text()),
                      "full_game.train")["config"]
    tag = json.loads((B.HERE / "configs" / "tag_ppo.json").read_text())
    assert cfg["sim"] == dict(tag["sim"], one_on_one=False, tag_mode=False)
    for k in ("ppo", "policy", "log_every", "save_every", "assumed"):
        assert cfg[k] == tag[k], k


@pytest.mark.parametrize("cell", list(SIZES))
def test_sound_run_is_correct(cell):
    out = B.run_cell(plan(cell), SEED, 0.5, False, "cpu", time.perf_counter())
    assert out["correct"], out["check"]


def update_unchanged(orig):
    def f(hp, idx, count, traj, side, nrm, ustats, params, mu, nu, **kw):
        return tuple(params), tuple(mu), tuple(nu)
    return f


def launch_unchanged(orig):
    def f(cfg, sf, si, n_steps, **kw):
        return sf.clone(), si.clone(), orig(cfg, sf, si, n_steps, **kw)[2]
    return f


@pytest.mark.parametrize("cell, module, name, fault", [
    ("full_game.train", FU, "fused_update_phase", update_unchanged),
    ("full_game.step", FS, "fused_multistep", launch_unchanged),
], ids=["train_state_unchanged", "step_state_unchanged"])
def test_fault_is_not_correct(monkeypatch, cell, module, name, fault):
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    out = B.run_cell(plan(cell), SEED, 0.5, False, "cpu", time.perf_counter())
    assert not out["correct"], out["check"]


# ---- the rule-phase counter and its readers ----

def handmade():
    """70 worlds (two whole 32-world groups and one of 6): world 0
    inbounding, world 33 in flight, worlds 32 and 34-63 held, the rest
    loose; the second rows add two baskets in world 5, two rollovers in
    world 6, an out-of-bounds turnover in world 7 and a new game in world
    8 (from 3 baskets to 1)."""
    sf = torch.zeros((72, 70))
    si = torch.zeros((59, 70), dtype=torch.int32)
    si[I_IDX["ginb"], 0] = 1
    si[I_IDX["binflight"], 33] = 1
    si[I_IDX["bgrabbed"], 32:64] = 1
    sf[F_IDX["period"]] = 1.0
    sf[F_IDX["sbaskets"], 8] = 3.0
    sf2 = sf.clone()
    sf2[F_IDX["sbaskets"], 5] = 2.0
    sf2[F_IDX["period"], 6] = 3.0
    sf2[F_IDX["oob"], 7] = 1.0
    sf2[F_IDX["sbaskets"], 8] = 1.0
    return sf, sf2, si


def test_counter_hand_counted():
    """Two samples of the tracer's counter (a hook of its session) on the
    handmade rows, each under its host span."""
    sf, sf2, si = handmade()
    P.TRACER.start("cpu")
    try:
        RP.COUNTER.sample(sf, si)
        RP.COUNTER.sample(sf2, si)
    finally:
        rec = P.TRACER.stop()
    # groups 0 (inbounding + loose) and 1 (held + in flight) are mixed
    assert rec["counters"]["rule_phases"] == {
        "samples": 2, "groups": 6, "mixed_groups": 4,
        "worlds": {"inbounding": 2, "in_flight": 2, "held": 62,
                   "loose": 74},
        "baskets": 3, "oob": 1, "rollovers": 2}
    assert [s[0] for s in rec["spans"]] == ["rule_phases"] * 2
    P.TRACER.start("cpu")       # a session starts from zero
    assert P.TRACER.stop()["counters"]["rule_phases"]["samples"] == 0


def test_readers_hand_counted():
    """The reader samples a counter of its own after each of the
    traffic's profile iterations, which it steps through the run
    (`Run._advance`); on the handmade rows, two samples."""
    sf, sf2, si = handmade()
    steps = iter([sf, sf2])

    class Run:
        state = None

        def _advance(self, state):
            return types.SimpleNamespace(sf=next(steps), si=si), {}
    reader = B.load_module(B.HERE / "metrics" / "mixed_warp_share.train.py",
                           "m_train")
    ctx = {"run": Run(), "plan": {"traffic": {"profile_iterations": 2}}}
    assert reader.read(ctx) == pytest.approx(100.0 * 4 / 6)
    assert RP.mixed_share({"groups": 0, "mixed_groups": 0}) is None


def test_tracer_off_adds_nothing(monkeypatch):
    """Off: an eager iteration does not sample the counter (no operation,
    no buffer), nor does a stepping launch; on, an iteration samples it
    once."""
    calls = []
    monkeypatch.setattr(RP, "_sample",
                        lambda *a: calls.append(a[0].shape[1]))
    hp = PPOParams(num_envs=32, num_rollout_steps=2)
    state = init_train_state(CFG, hp, 3, CPU)
    it = make_train_iteration(CFG, hp, CPU)
    state, _ = it(state)
    FS.fused_multistep(CFG, state.sf, state.si, 2, seed=1)
    assert calls == [] and not P.TRACER.on
    P.TRACER.start("cpu")
    try:
        state, _ = it(state)
        FS.fused_multistep(CFG, state.sf, state.si, 2, seed=1)
    finally:
        P.TRACER.stop()
    assert calls == [32]


@pytest.mark.parametrize("cell", ["full_game.train"])
def test_stretch_reads_the_counter(cell):
    """The reader's stretch over a sound run of the training cell on the
    CPU: the traffic's profile iterations, the state advanced."""
    p = plan(cell)
    run = drv.Run(p["config"], p["traffic"], SEED, CPU)
    before = run.state.counter
    reader = B.load_module(B.HERE / "metrics" / "mixed_warp_share.train.py",
                           "m_train_run")
    share = reader.read({"run": run, "plan": p})
    assert run.state.counter == before + p["traffic"]["profile_iterations"]
    assert 0.0 <= share <= 100.0


# ---- B's and F's operation counts under the full rules ----

def count_ops(fn, *args, **kw):
    """Float arithmetic a plain version issues, counted as the frozen
    counts were (benchmark/counts/update_D.py): elementwise results one op
    an element, reductions one an input element, products two a
    multiply-add."""
    from torch.utils._python_dispatch import TorchDispatchMode
    arith = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "rsqrt",
             "sin", "cos", "exp", "log", "abs", "sign", "clamp", "clamp_min",
             "clamp_max", "maximum", "minimum", "pow", "reciprocal"}
    n = [0]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            base = func.__name__.split(".")[0].rstrip("_")
            if base in arith and isinstance(out, torch.Tensor) and \
                    out.is_floating_point():
                n[0] += out.numel()
            elif base in ("sum", "mean") and isinstance(args[0],
                                                         torch.Tensor):
                n[0] += args[0].numel()
            elif base in ("mm", "bmm", "addmm") and out.is_floating_point():
                n[0] += 2 * args[-2].numel() * args[-1].shape[-1]
                if base == "addmm":
                    n[0] += out.numel()
            return out

    with Counter():
        fn(*args, **kw)
    return n[0]


def per_world_tick(cfg) -> dict:
    """(a world-tick's operations, a tick's constant) of the plain tick
    with and without obs and of the rollout's tick, from counts at 64
    and 128 worlds."""
    out = {}
    for W in (64, 128):
        sf, si = init_rows(cfg, W, torch.Generator().manual_seed(0), CPU)
        noise = draw_noise_rows(W, torch.Generator().manual_seed(1), CPU)
        st = init_train_state(cfg, PPOParams(num_envs=W), 0, CPU)
        kw = dict(n_steps=1, trainee_idx=1,
                  noise=FR.philox_noise(0, 0, 1, W, CPU))
        out[W] = (count_ops(FS.step_rows_plain, cfg, sf, si, noise),
                  count_ops(FS.step_rows_plain, cfg, sf, si, noise,
                            compute_obs=False),
                  count_ops(FR.rollout_plain, cfg, sf, si,
                            torch.zeros((256, W)),
                            FR.pack_policy(st.agent), **kw))
    return {k: ((out[128][j] - out[64][j]) / 64,
                out[64][j] - 64 * (out[128][j] - out[64][j]) / 64)
            for j, k in enumerate(("F", "F_no_obs", "B"))}


def test_recount_of_B_and_F_under_the_full_rules():
    """The frozen counts were taken on the tag tick; the same count of the
    full tick lies within 1 % of them a world-tick (1 515 against 1 517
    for F, 14 667.3125 against 14 669.3125 for B), so the existing
    roofline metrics serve the full_game cells."""
    tag = per_world_tick(GAME_MODES["tag"])
    assert tag["F"] == (multistep_F.OPS_PER_WORLD_TICK, 0)
    assert tag["F_no_obs"] == (multistep_F.OPS_PER_WORLD_TICK_NO_OBS, 0)
    assert tag["B"] == (rollout_B.OPS_PER_WORLD_TICK, rollout_B.OPS_PER_TICK)
    full = per_world_tick(CFG)
    assert full == {"F": (1515, 0), "F_no_obs": (1259, 0),
                    "B": (14667.3125, 206)}
    for k, frozen in (("F", multistep_F.OPS_PER_WORLD_TICK),
                      ("F_no_obs", multistep_F.OPS_PER_WORLD_TICK_NO_OBS),
                      ("B", rollout_B.OPS_PER_WORLD_TICK)):
        assert abs(full[k][0] / frozen - 1) < 0.01, k
