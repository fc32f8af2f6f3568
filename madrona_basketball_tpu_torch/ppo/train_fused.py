"""Experience collection of the flagship PPO iteration (port of
`madrona_basketball_tpu/ppo/train_fused.py:36-71,190-223,547-655`).

`make_collect(cfg, hp, device)` returns `collect(state) -> (state', out)`
which runs, in order:

  1. the reset pulse: Reset flags set, trainee actions zeroed, one sim
     tick (kernel A, ops/fused_step.py), flags cleared;
  2. the T-tick rollout with the policy in the loop (kernel B,
     ops/fused_rollout.py), which also yields the obs moments;
  3. `next_value`, a plain critic forward on the last obs;
  4. GAE, the side array and the episode-stat partials (kernel C,
     ops/fused_gae.py);
  5. the windowed-meter scan (a small kernel, ppo/train.py::meter_scan),
     then torch glue: the closed-form Chan merges of the value / return /
     advantage block moments and the obs moments.

`out` holds what the JAX iteration hands to `update_policy_traj` at
train_fused.py:660 - traj, side, ustats, the new obs_rms / value_rms -
plus the episode stats and the metrics.  The update phase itself is not
ported yet; `state'` carries the new normalizers and unchanged weights.

Noise: by default the pulse draws its 9 rows from a torch.Generator
seeded by (seed, counter) and the rollout uses kernel B's in-kernel
Philox with key = seed and tick_base = counter * T, so every iteration
gets fresh, reproducible streams.  `collect(state, noise=...)` injects
all draws instead (the tests' path).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import constants as C
from ..config import SimConfig
from ..engine import init_rows
from ..engine_fused import draw_noise_rows
from ..models import agent as agent_lib
from ..models.agent import Agent
from ..models.normalize import EPS as RMS_EPS
from ..models.normalize import _rms_merge, rms_update_padded_moments
from ..ops import fused_gae as FG
from ..ops import fused_rollout as FR
from ..ops.fused_step import fused_step
from ..ops.layout import ACTION_ROWS, N_OBS_ROWS, RESET_ROWS
from .hparams import PPOParams
from .train import EpisodeStats, init_stats, meter_scan

F32 = torch.float32
I32 = torch.int32
OBS = C.OBS_SIZE


@dataclasses.dataclass
class RolloutState:
    agent: Agent
    frozen: Agent
    sf: torch.Tensor    # (N_F32_ROWS, W)
    si: torch.Tensor    # (N_I32_ROWS, W)
    obs: torch.Tensor   # (N_OBS_ROWS, W)
    stats: EpisodeStats
    seed: int
    counter: int        # iterations collected so far


def init_rollout_state(cfg: SimConfig, hp: PPOParams, seed: int,
                       device="cuda", agent: Optional[Agent] = None,
                       frozen: Optional[Agent] = None) -> RolloutState:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not "
                           "available")
    gen_cpu = torch.Generator().manual_seed(seed)
    if agent is None:
        agent = agent_lib.init_agent(gen_cpu, dev)
    if frozen is None:
        frozen = agent_lib.init_agent(gen_cpu, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sf, si = init_rows(cfg, hp.num_envs, gen, dev)
    return RolloutState(
        agent=agent, frozen=frozen, sf=sf, si=si,
        obs=torch.zeros((N_OBS_ROWS, hp.num_envs), dtype=F32, device=dev),
        stats=init_stats(hp.num_envs, dev), seed=seed, counter=0)


@dataclasses.dataclass
class CollectNoise:
    """Injected draws of one iteration: the pulse's sim noise (9, W), the
    rollout's (T * EXT_NOISE_CHUNK, W) external-noise matrix (None keeps
    the Philox stream of (seed, counter), which is the same on every
    device) and the frozen policy's pulse uniforms (19, W) (use_frozen
    only)."""
    pulse: torch.Tensor
    rollout: Optional[torch.Tensor] = None
    pulse_frozen_u: Optional[torch.Tensor] = None


def make_collect(cfg: SimConfig, hp: PPOParams, device="cuda"):
    ti = hp.trainee_idx
    fi = 1 - ti
    T = hp.num_rollout_steps
    ti_lo = ti * OBS
    fi_lo = fi * OBS
    dev = torch.device(device)

    def reset_pulse(state: RolloutState, noise: Optional[CollectNoise]):
        si = state.si.clone()
        for r in RESET_ROWS:
            si[r] = 1
        for r in ACTION_ROWS[ti]:
            si[r] = 0
        if noise is not None:
            pulse = noise.pulse
            f_u = noise.pulse_frozen_u
        else:
            gen = torch.Generator(device=dev).manual_seed(
                (state.seed * 1_000_003 + state.counter) % (2 ** 63))
            pulse = draw_noise_rows(hp.num_envs, gen, dev)
            f_u = (torch.rand((FR.N_LOGITS, hp.num_envs), generator=gen,
                              device=dev) if hp.use_frozen else None)
        if hp.use_frozen:
            fa, _, _ = agent_lib.forward(
                state.frozen, state.obs[fi_lo:fi_lo + OBS].T,
                FR.gumbel_from_uniform(f_u).T)
            for j, r in enumerate(ACTION_ROWS[fi]):
                si[r] = fa[:, j]
        sf, si, obs = fused_step(cfg, state.sf, si, pulse)
        for r in RESET_ROWS:
            si[r] = 0
        return sf, si, obs

    @torch.no_grad()
    def collect(state: RolloutState, noise: Optional[CollectNoise] = None,
                mark: Optional[Callable[[str], None]] = None):
        """One iteration's experience; `mark(name)` (optional) is called
        after each phase, for timing."""
        mark = mark or (lambda name: None)
        agent = state.agent
        sf, si, obs = reset_pulse(state, noise)
        mark("reset_pulse")

        mats = FR.pack_policy(agent)
        fmats = FR.pack_policy(state.frozen) if hp.use_frozen else None
        sf, si, obs, traj, om = FR.fused_rollout(
            cfg, sf, si, obs, mats, fmats, n_steps=T, trainee_idx=ti,
            noise=None if noise is None else noise.rollout,
            seed=state.seed, tick_base=state.counter * T)
        mark("rollout")

        next_value = agent_lib.evaluate(agent, obs[ti_lo:ti_lo + OBS].T)
        vrm = agent.value_rms
        vstats = torch.zeros((1, FG.VSTAT_COLS), dtype=F32, device=dev)
        vstats[0, 0] = vrm.mean[0]
        vstats[0, 1] = torch.sqrt(vrm.var[0] + RMS_EPS)
        st = state.stats
        carry = torch.stack([st.curr_rewards, st.episode_lengths])
        side, moments, carry_out, ticks = FG.fused_gae(
            traj, carry, next_value[None, :], vstats, gamma=hp.gamma,
            lam=hp.gae_lambda, r_value=FR.R_VALUE, r_rew=FR.R_REW,
            r_done=FR.R_DONE)
        mark("gae")

        # windowed meters: per-tick sums arrive reduced per block
        m = meter_scan(ticks, torch.stack([
            st.mean_reward, st.reward_size, st.mean_length, st.length_size]))
        stats = EpisodeStats(curr_rewards=carry_out[0],
                             episode_lengths=carry_out[1],
                             mean_reward=m[0], reward_size=m[1],
                             mean_length=m[2], length_size=m[3])

        n_per = float(T * hp.num_envs // moments.shape[0])
        vm_b, vv_b, nN = FG.combine_block_moments(moments[:, 0],
                                                  moments[:, 1], n_per)
        am_b, av_b, _ = FG.combine_block_moments(moments[:, 2],
                                                 moments[:, 3], n_per)
        rm_b, rv_b, _ = FG.combine_block_moments(moments[:, 4],
                                                 moments[:, 5], n_per)
        value_rms = _rms_merge(vrm, vm_b.reshape(1), vv_b.reshape(1), nN)
        value_rms = _rms_merge(value_rms, rm_b.reshape(1), rv_b.reshape(1),
                               nN)
        ar = 1.0 / (torch.sqrt(av_b) + 1e-8)
        vr_post = torch.rsqrt(value_rms.var[0] + RMS_EPS)
        ustats = torch.zeros((1, 8), dtype=F32, device=dev)
        ustats[0, 0] = value_rms.mean[0]
        ustats[0, 1] = vr_post
        ustats[0, 2] = am_b
        ustats[0, 3] = ar
        obs_rms = rms_update_padded_moments(agent.obs_rms, om[:, 0],
                                            om[:, 1], om[0, 2])
        adv_n = (side[:, FG.SIDE_ADV] - am_b) * ar
        values_n = torch.clamp(
            (side[:, FG.SIDE_VALUE] - value_rms.mean[0]) * vr_post,
            -5.0, 5.0)
        metrics = {
            "mean_reward": stats.mean_reward,
            "mean_episode_length": stats.mean_length,
            "reward_window": stats.reward_size,
            "adv_abs_mean": adv_n.abs().mean(),
            "value_mean": values_n.mean(),
        }
        mark("glue")
        new_agent = Agent(net=agent.net, obs_rms=obs_rms,
                          value_rms=value_rms)
        out = dict(traj=traj, side=side, ustats=ustats, obs_rms=obs_rms,
                   value_rms=value_rms, stats=stats, metrics=metrics)
        state = dataclasses.replace(state, agent=new_agent, sf=sf, si=si,
                                    obs=obs, stats=stats,
                                    counter=state.counter + 1)
        return state, out

    return collect
