"""Kernels B and F under the full rule set (`GAME_MODES["full"]`) on a card,
against their plain versions on the same card, and the tracer's
rule-phase counter in a captured training chunk.  Marked `card`: each
test skips without one.  No JAX here.

  * B: 8192 worlds, the rule events staged in every 64-world block
    (tests/full_game_rows.py), 32 ticks of in-kernel Philox with and
    without the frozen opponent, against `rollout_plain` on B's Philox
    draws; F: the same rows stepped 700 ticks (past a quarter's 620) in
    one launch, obs every tick, agent 0 blanked, against
    `multistep_rows_plain` on F's Philox draws.  A world parts where an
    integer row or a sampled action differs, or any float by more than
    1e-4.  The card's FMA contraction moves the last ulp, which decides
    a near-tie: at most 0.1 % of the OOB-staged worlds and 0.1 % of the
    rest part in B (chip_smoke.py's tier for B in tag mode), none in F.
    The staged events happen; the CLOCK worlds roll over.
  * The counter: a training chunk captured with the tracer off has the
    kernel nodes of one captured with it on, whose report leaves the
    stamps and the counter's samples out; its replays sample the counter
    once an iteration.
"""

import pytest
import torch

from madrona_basketball_tpu_torch.config import GAME_MODES
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.ops import fused_rollout as FR
from madrona_basketball_tpu_torch.ops import fused_step as FS
from madrona_basketball_tpu_torch.ops import rule_phases as RP
from madrona_basketball_tpu_torch.ops.layout import F_IDX
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train import make_train_chunk
from madrona_basketball_tpu_torch.ppo.train_fused import (
    init_train_state, make_train_iteration)
from madrona_basketball_tpu_torch.utils import profiling as P

from .full_game_rows import BLOCK, CLASSES, CLOCK, OOB, stage
from tests import torch_threads  # noqa: F401

CFG = GAME_MODES["full"]
W = 8192
TOL = 1e-4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _rows(dev, seed):
    sf, si = init_rows(CFG, W, torch.Generator().manual_seed(seed), "cpu")
    sf, si = stage(sf.numpy().copy(), si.numpy().copy())
    return torch.tensor(sf, device=dev), torch.tensor(si, device=dev)


def _tier(k, p, max_share, acts=None):
    """k, p are (sf, si, obs[, traj]).  The share of the worlds that part
    (the module docstring) is at most `max_share` in the OOB class
    (tests/full_game_rows.py) and in the rest; prints the parted worlds by
    class.  Returns the share of all worlds."""
    floats = (0, 2, 3) if acts is not None else (0, 2)
    div = (k[1] != p[1]).any(dim=0)
    if acts is not None:
        div |= (k[3][:, acts] != p[3][:, acts]).any(dim=1).any(dim=0)
    for i in floats:
        d = (k[i] - p[i]).abs()
        div |= d.amax(dim=tuple(range(d.dim() - 1))) > TOL
    cls = torch.arange(div.numel(), device=div.device) % BLOCK

    def members(r):
        return torch.isin(cls, torch.tensor(list(r), device=div.device))
    by = {name: int(div[members(r)].sum()) for name, r in CLASSES.items()}
    oob = members(OOB)
    print(f"parted {int(div.sum())} of {div.numel()} worlds, by class {by}")
    assert float(div[oob].float().mean()) <= max_share, by
    assert float(div[~oob].float().mean()) <= max_share, by
    return float(div.float().mean())


@pytest.mark.card
@pytest.mark.parametrize("frozen", [False, True])
def test_rollout_kernel_matches_plain(card, frozen):
    sf, si = _rows(card, 3)
    obs = torch.rand((256, W), generator=torch.Generator(device=card)
                     .manual_seed(4), device=card)
    st = init_train_state(CFG, PPOParams(num_envs=W), 11, card)
    mats = FR.pack_policy(st.agent)
    fmats = FR.pack_policy(st.frozen) if frozen else None
    seed = 2 ** 33 + 17
    k = FR.fused_rollout(CFG, sf, si, obs, mats, fmats, n_steps=32,
                         trainee_idx=1, seed=seed)
    p = FR.rollout_plain(CFG, sf, si, obs, mats, fmats, n_steps=32,
                         trainee_idx=1,
                         noise=FR.philox_noise(seed, 0, 32, W, card))
    torch.cuda.synchronize(card)
    _tier(k, p, 1e-3, acts=slice(FR.R_ACT, FR.R_ACT + 6))
    for n in ("sbaskets", "oob", "period"):
        assert bool((k[0][F_IDX[n]] > sf[F_IDX[n]]).any()), n


@pytest.mark.card
def test_multistep_kernel_matches_plain(card):
    sf, si = _rows(card, 5)
    key = ((2 ** 31 + 3) << 32) | 7
    k = FS.fused_multistep(CFG, sf, si, 700, seed=key, obs_every_tick=True,
                           blank_agent=0)
    p = FS.multistep_rows_plain(
        CFG, sf, si, FS.philox_multistep_noise(key, 0, 700, W, card), 700,
        obs_every_tick=True, blank_agent=0)
    torch.cuda.synchronize(card)
    _tier(k, p, 0.0)
    clock = torch.isin(torch.arange(W, device=card) % BLOCK,
                       torch.tensor(list(CLOCK), device=card))
    assert bool((k[0][F_IDX["period"]] > sf[F_IDX["period"]])[clock].all())


@pytest.mark.card
def test_counter_adds_no_kernel_node_and_samples_each_replay(card):
    hp = PPOParams(num_envs=1024, num_rollout_steps=8)
    it = make_train_iteration(CFG, hp, card)
    state = init_train_state(CFG, hp, 21, card)
    off = make_train_chunk(it, 2)
    state, _ = off(state)
    P.TRACER.start(card)
    try:
        on = make_train_chunk(it, 2)
        state, _ = on(state)
    finally:
        setup = P.TRACER.stop()
    assert off.captured["kernel_nodes"] is not None
    assert on.captured["kernel_nodes"] == off.captured["kernel_nodes"]
    assert setup["kernel_nodes"]["train_iteration"] == {
        "kernels": off.captured["kernel_nodes"], "stamps": 8}
    assert RP.COUNTER.nodes > 0
    P.TRACER.start(card)
    try:
        for _ in range(3):
            state, _ = on(state)
            off(state)
    finally:
        rec = P.TRACER.stop()
    ph = rec["counters"]["rule_phases"]
    assert ph["samples"] == 6 and ph["groups"] == 6 * 1024 // 32, ph
    assert sum(ph["worlds"].values()) == 6 * 1024
