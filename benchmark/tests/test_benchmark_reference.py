"""The benchmark's frozen reference equals the port's plain versions at
this commit, bit for bit, on small inputs on the CPU."""

import copy

import pytest
import torch

from benchmark.drivers import train as drv
from benchmark.reference import gae as RG
from benchmark.reference import iteration as R
from benchmark.reference import multistep as RM
from benchmark.reference import rollout as RR
from benchmark.reference import sim as RS
from benchmark.reference import update as RU
from madrona_basketball_tpu_torch.config import SimConfig
from madrona_basketball_tpu_torch.engine import init_rows
from madrona_basketball_tpu_torch.engine_fused import draw_noise_rows
from madrona_basketball_tpu_torch.ops import fused_gae as FG
from madrona_basketball_tpu_torch.ops import fused_rollout as FR
from madrona_basketball_tpu_torch.ops import fused_step as FS
from madrona_basketball_tpu_torch.ops import fused_update as FU
from madrona_basketball_tpu_torch.ppo.hparams import PPOParams
from madrona_basketball_tpu_torch.ppo.train_fused import (
    init_train_state, make_train_iteration)

CFG = SimConfig()
CPU = torch.device("cpu")


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


def test_sim_tick_and_draws():
    sf, si = init_rows(CFG, 64, torch.Generator().manual_seed(3), CPU)
    noise = draw_noise_rows(64, torch.Generator().manual_seed(4), CPU)
    same(RS.draw_noise_rows(64, torch.Generator().manual_seed(4), CPU),
         noise)
    same(RS.step_rows_plain(CFG, sf, si, noise),
         FS.step_rows_plain(CFG, sf, si, noise))


def test_philox_noise():
    seed = 2 ** 33 + 5
    same(RR.philox_noise(seed, 96, 3, 64, CPU),
         FR.philox_noise(seed, 96, 3, 64, CPU))


@pytest.mark.parametrize("every", [True, False])
def test_multistep_on_any_worlds(every):
    """Kernel F's plain launch (its in-kernel Philox) over 64 worlds, and
    the reference over all of them and over three alone."""
    seed = ((2 ** 31 + 77) << 32) | 3
    sf, si = init_rows(CFG, 64, torch.Generator().manual_seed(1), CPU)
    prog = FS.fused_multistep(CFG, sf, si, 12, seed=seed, tick_base=5,
                              obs_every_tick=every, blank_agent=0)
    same(RM.multistep(CFG, sf, si, torch.arange(64), seed=seed, n_steps=12,
                      tick_base=5, blank_agent=0), prog)
    few = torch.tensor([3, 17, 40])
    same(RM.multistep(CFG, sf[:, few], si[:, few], few, seed=seed,
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
    same(RR.rollout(CFG, sf, si, obs, mats, fmats, n_steps=3, trainee_idx=1,
                    noise=noise),
         FR.rollout_plain(CFG, sf, si, obs, mats, fmats, n_steps=3,
                          trainee_idx=1, noise=noise))


def test_gae_and_update():
    g = torch.Generator().manual_seed(7)
    T, W = 4, 256
    hp = PPOParams(num_envs=W, num_rollout_steps=T)
    traj = torch.randn((T, 128, W), generator=g)
    traj[:, RR.R_ACT:RR.R_ACT + 6] = torch.randint(0, 2, (T, 6, W),
                                                   generator=g).float()
    traj[:, RR.R_DONE] = (torch.rand((T, W), generator=g) < 0.1).float()
    carry = torch.rand((2, W), generator=g)
    nv = torch.randn((1, W), generator=g)
    vstats = torch.tensor([[0.3, 1.7, 0, 0, 0, 0, 0, 0]])
    kw = dict(gamma=hp.gamma, lam=hp.gae_lambda, r_value=RR.R_VALUE,
              r_rew=RR.R_REW, r_done=RR.R_DONE)
    out = RG.gae(traj, carry, nv, vstats, **kw)
    same(out, FG.gae_plain(traj, carry, nv, vstats, **kw))
    side = out[0]
    st = init_train_state(CFG, hp, 11, CPU)
    params = FU.pack_weights(st.agent.net)
    nrm = FU.pack_norm(st.agent.obs_rms)
    ustats = torch.tensor([[0.1, 0.9, 0.05, 1.3, 0, 0, 0, 0]])
    wb = RU.pick_update_block(W, hp.minibatch_size)
    assert wb == FU.pick_update_block(W, hp.minibatch_size)
    idx = torch.randperm(2 * T * W // wb, generator=g).remainder(
        T * W // wb).to(torch.int32)
    zeros = tuple(torch.zeros_like(p) for p in params)
    ref = RU.update_phase(hp, idx, 5, traj, side, nrm, ustats, params, zeros,
                          zeros, wb=wb)
    same(ref[:3], FU.update_phase_plain(hp, idx, 5, traj, side, nrm, ustats,
                                        params, zeros, zeros, wb=wb))


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
        ref, ref_out = R.iteration(CFG, hp, copy.deepcopy(ref))
        same(drv.snapshot(state), ref)
        mine = drv.stage_outputs(out)
        same(mine, {k: ref_out[k] for k in mine})
