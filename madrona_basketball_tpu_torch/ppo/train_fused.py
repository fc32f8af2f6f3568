"""The flagship PPO iteration (port of
`madrona_basketball_tpu/ppo/train_fused.py:36-71,190-223,521-677`):
experience collection, then the update phase.

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

`make_collect(..., rollout_tiled=True)` is the JAX trainer's
`--rollout-tiled` path (train_fused.py:272-292,403-406,640): kernel I
(`fused_rollout_tiled`) replaces kernel B in step 2 and yields no
moments, so after GAE kernel E (`ops/fused_gae.py::obs_moments`) reduces
the trajectory's obs rows into the same (103, 8) moments, timed as its
own "obs_moments" span; the world count must be a multiple of 1024.

`out` holds what the JAX iteration hands to `update_policy_traj` at
train_fused.py:660 - traj, side, ustats, the new obs_rms / value_rms -
plus the episode stats and the metrics; `state'` carries the new
normalizers and unchanged weights.

`make_train_iteration(cfg, hp, device)` returns
`train_iteration(state, noise=None, perms=None, mark=None) ->
(state', out)` which runs
`collect` and then the update phase (kernel D, ops/fused_update.py) on
its trajectory with the post-collect obs normalizer: E epochs, each a
permutation of the T * W / wb (tick, world-block) blocks dealt into M
minibatches, gradient + global-norm clip + Adam per minibatch.  The new
weights are written back into the agent's module in place and the Adam
state is replaced; `out` is the collect's.

Noise: by default the pulse draws its 9 rows from a torch.Generator
seeded by `pulse_seed(seed, counter)` and the rollout uses kernel B's
in-kernel Philox with key = seed and tick_base = counter * T, so every
iteration gets fresh, reproducible streams; the update's block
permutations come from a second generator seeded by
`perm_seed(seed, counter)`.  Each generator is made once and reseeded
before every iteration, which gives the draws of a fresh generator of
that seed.  `collect(state, noise=...)` and `train_iteration(state,
noise=..., perms=...)` inject all draws instead (the tests' path).

Data parallel (`mesh`, a parallel/mesh.py::DataMesh; the port of the
JAX trainer's `--data-parallel`, train_fused.py:167-183,261-330,366-382):
each rank holds its W_l = W / size worlds' rows (`shard_train_state`),
and every rank runs the same program.  The pulse draws its rows for all W
worlds and takes the rank's columns; kernel B (or I) steps the rank's
worlds with its Philox counter at world_base = rank * W_l, so a k-rank
run draws exactly the one-rank run's noise.  Then:

  * plain (`dp_update=False`): the trajectory and the last trainee obs
    are all-gathered into world order; next_value, kernel C, the meter
    scan, kernel E (the obs moments: B's fold is per shard) and kernel D
    run on the whole fleet on every rank, the stats carry whole too.
    D is deterministic, so the learner stays bit-identical across ranks
    with no broadcast;
  * `dp_update=True` (`--dp-update`, train_fused.py:155-159,407-520,
    641-660; the untiled path only): B's fold and kernel C run on the
    rank's worlds (the stats carry sharded too); the per-shard obs
    moments merge by the JAX package's cross-shard Chan combine, C's
    block moments and meter partials are all-gathered and stacked (exact
    when W_l is a multiple of C's block, so the shards' blocks are the
    fleet's).  The update never gathers the trajectory: per minibatch
    kernel G (ops/fused_update.py::fused_minibatch_grad_prefetch) takes
    the gradient over the rank's blocks, the 5216 floats are summed over
    the ranks and scaled by 1 / size, and `clip_adam_step` runs on every
    rank.  The shuffle is stratified (PARITY.md deviation 7): each rank
    permutes its own T * W_l / wb_l blocks; every rank draws all
    (size, E, T * W_l / wb_l) permutations and takes row `rank`, so one
    rank draws the flagship's own permutations.

The JAX trainer's alternate paths (train_fused.py:132-160,217-257,
563-576,679-776; `make_train_iteration`'s rollout_kernel / fused_grads /
fused_gae / backend flags, checked by `check_paths` with its messages):
`--no-fused-gae` keeps kernel B (or I) and runs `_unfused_tail`'s torch
GAE, then kernel D with ustats None on the normalized side rows;
`--no-fused-grads` builds the feat matrix from the trajectory and runs the
autodiff update (ppo/train.py::make_update_fns); the per-tick rollout
(`--no-rollout-kernel`, `--backend xla-rows`) is `_per_tick_body`: kernel
A a tick with the policy in torch, then `compute_advantages` and the
autodiff update; ppo/train.py's structured trainer runs the same body
over the structured engine.  With hp.record_world0 the per-tick paths
return world 0's rows (`world0_rows`) in out["metrics"]["world0"].

The bf16 flags (train_fused.py:114-115,146-154,161; `make_train_iteration`'s
bf16_traj / bf16_policy, checked by `check_paths` with the JAX
messages): bf16_traj stores kernel B's trajectory in bfloat16 (rounded
on store; state, obs and the obs moments float32), and every consumer
upcasts it on load - kernel C, kernel E and kernel D, or kernel G under
dp_update; under a plain mesh the bf16 trajectory is what is
all-gathered.  It needs the untiled fused-GAE path.  bf16_policy rounds
the operands of kernel B's Dense layers (and the frozen policy's) to
bf16; it needs the untiled rollout kernel.  Neither changes the train
state's types: the weights, normalizers and Adam moments stay float32.

`train_iteration.static(state)` is the iteration's static-buffer form,
`StaticIteration`: the state copied into tensors that keep their
addresses, and `step()`, one iteration from those tensors back into
them that reads tick_base and the Adam count from device counters and
advances them.  `ppo/train.py::make_train_chunk` captures one `step()`
in a CUDA graph and replays it.

Phase stamps (utils/profiling.py): `mark(name)` is called after each
phase - "perms" (when the permutations are drawn, not injected), the
collect's (reset_pulse, rollout, gae, [obs_moments], glue), "update".
With the tracer on, `train_iteration` without a `mark` and
`StaticIteration.step` pass the tracer's stamp, bracketed by "start" and
"writeback" (the iteration's end), so a captured step holds one stamp
node per phase boundary; with it off they pass none.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
from typing import Callable, Optional

import torch

from .. import constants as C
from ..config import SimConfig
from ..engine import init_rows
from ..engine_fused import draw_noise_rows
from ..models import agent as agent_lib
from ..models.agent import Agent
from ..models.normalize import EPS as RMS_EPS
from ..models.normalize import (RMSState, _rms_merge, rms_update_padded,
                                rms_update_padded_moments,
                                rms_update_padded_tdw)
from ..ops import fused_gae as FG
from ..ops import fused_rollout as FR
from ..ops import fused_update as FU
from ..ops import rule_phases
from ..ops.fused_step import fused_step
from ..ops.layout import (ACTION_NAMES, ACTION_ROWS, F_IDX, I_IDX,
                          N_NOISE_ROWS, N_OBS_ROWS, RESET_ROWS)
from ..parallel.mesh import DataMesh, all_gather, all_gather_columns, \
    all_reduce_
from ..utils.profiling import TRACER
from .hparams import PPOParams
from .train import (AdamState, EpisodeStats, _stats_step, clip_adam_step,
                    init_adam, init_stats, make_update_fns, meter_scan,
                    normalize_advantages)

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


def pulse_seed(seed: int, counter: int) -> int:
    """The seed of iteration `counter`'s reset-pulse draws."""
    return (seed * 1_000_003 + counter) % (2 ** 63)


def perm_seed(seed: int, counter: int) -> int:
    """The seed of iteration `counter`'s block permutations."""
    return ((seed * 1_000_003 + counter) * 1_000_033 + 7) % (2 ** 63)


DP_UPDATE_NEEDS = ("dp_update shards the update phase over the data mesh "
                   "(per-minibatch gradient psum); it requires a mesh and "
                   "the (untiled) fused-GAE flagship path")


def shard_worlds(hp: PPOParams, mesh: Optional[DataMesh],
                 rollout_tiled: bool = False, dp_update: bool = False,
                 rollout_kernel: bool = True) -> int:
    """W_l, the worlds of one rank (W without a mesh), after checking
    that they meet the kernels' geometry: kernel I's 1024-world tiles,
    kernel B's 32-world warps (rollout_kernel), and under dp_update
    kernel C's world block (the shards' blocks must be the fleet's for
    the stacked block moments and meter partials to be exact)."""
    if dp_update and (mesh is None or rollout_tiled):
        raise ValueError(DP_UPDATE_NEEDS)
    W_l = hp.num_envs if mesh is None else mesh.worlds(hp.num_envs)
    if rollout_tiled:
        FR.check_tiled_worlds(W_l)
    if mesh is None or not rollout_kernel:
        return W_l
    if W_l % FR.MOM_GROUP:
        raise ValueError(f"{W_l} worlds a rank: the rollout kernel takes "
                         f"whole warps of {FR.MOM_GROUP} worlds")
    gb = FG.pick_gae_block(hp.num_envs)
    if dp_update and W_l % gb:
        raise ValueError(f"dp_update: {W_l} worlds a rank must be a "
                         f"multiple of kernel C's {gb}-world block, or the "
                         "ranks' block moments and meter partials are not "
                         "the whole fleet's")
    return W_l


def combine_shard_moments(m: torch.Tensor):
    """The JAX package's cross-shard Chan combine (train_fused.py:641-650)
    of per-shard (ROLL_OBS, 8) [mean, M2, n, 0...] moment blocks stacked
    (size, ROLL_OBS, 8) over equal shards -> (mean, M2, n)."""
    means, m2s, ns = m[:, :, 0], m[:, :, 1], m[:, :, 2]
    gmean = means.mean(dim=0)
    gm2 = m2s.sum(dim=0) + (ns * (means - gmean[None]) ** 2).sum(dim=0)
    return gmean, gm2, ns.sum(dim=0)[0]


def make_collect(cfg: SimConfig, hp: PPOParams, device="cuda",
                 rollout_tiled: bool = False):
    run, gen = _collect_body(cfg, hp, device, rollout_tiled)

    @torch.no_grad()
    def collect(state: RolloutState, noise: Optional[CollectNoise] = None,
                mark: Optional[Callable[[str], None]] = None):
        """One iteration's experience; `mark(name)` (optional) is called
        after each phase, for timing."""
        if noise is None:
            gen.manual_seed(pulse_seed(state.seed, state.counter))
        return run(state, noise, mark, state.counter * hp.num_rollout_steps)

    return collect


class RowsWorlds:
    """The fleet of a rows TrainState as `_reset_pulse` and
    `_per_tick_body` handle it: env = (sf, si, obs), one tick = kernel A.
    ppo/train.py::StructuredWorlds is the structured engine's twin."""

    @staticmethod
    def get(state):
        return state.sf, state.si, state.obs

    @staticmethod
    def fields(env) -> dict:
        sf, si, obs = env
        return dict(sf=sf, si=si, obs=obs)

    @staticmethod
    def owned(env):
        """env with its int rows copied, so `set_*` may write them."""
        sf, si, obs = env
        return sf, si.clone(), obs

    @staticmethod
    def obs(env, i):
        """Agent i's observations (W, 128)."""
        return env[2][i * OBS:(i + 1) * OBS].T

    @staticmethod
    def set_reset(env, value: int):
        for r in RESET_ROWS:
            env[1][r] = value
        return env

    @staticmethod
    def set_actions(env, i, actions):
        for j, r in enumerate(ACTION_ROWS[i]):
            env[1][r] = actions[:, j]
        return env

    @staticmethod
    def step(cfg, env, noise):
        """One tick (kernel A) with the (9, W) noise rows; the new env's
        rows are the kernel's own tensors, which `set_*` may write."""
        return fused_step(cfg, env[0], env[1], noise)

    @staticmethod
    def reward_done(env, i):
        return (env[0][F_IDX[f"a{i}.reward"]],
                env[0][F_IDX[f"a{i}.done"]])

    @staticmethod
    def world0(env, done):
        return world0_rows(env[0], env[1], done)


def _reset_pulse(cfg: SimConfig, hp: PPOParams, dev, gen, local,
                 worlds=RowsWorlds):
    """`reset_pulse(state, noise) -> env` (train_fused.py:212-223, and
    train.py:369-378 on the structured engine): the Reset flags set, the
    trainee's actions zeroed (the frozen opponent's from its policy), one
    tick, the flags cleared.  Draws from `gen` unless `noise` is given;
    `local` takes the rank's columns of a whole-fleet draw."""
    ti, fi = hp.trainee_idx, 1 - hp.trainee_idx

    def reset_pulse(state, noise: Optional[CollectNoise]):
        env = worlds.set_reset(worlds.owned(worlds.get(state)), 1)
        env = worlds.set_actions(
            env, ti, torch.zeros((worlds.obs(env, ti).shape[0], 6),
                                 dtype=I32, device=dev))
        if noise is not None:
            pulse = local(noise.pulse)
            f_u = local(noise.pulse_frozen_u)
        else:
            pulse = local(draw_noise_rows(hp.num_envs, gen, dev))
            f_u = local(torch.rand((FR.N_LOGITS, hp.num_envs), generator=gen,
                                   device=dev) if hp.use_frozen else None)
        if hp.use_frozen:
            fa, _, _ = agent_lib.forward(
                state.frozen, worlds.obs(env, fi),
                FR.gumbel_from_uniform(f_u).T)
            env = worlds.set_actions(env, fi, fa)
        return worlds.set_reset(worlds.step(cfg, env, pulse), 0)

    return reset_pulse


def _collect_body(cfg: SimConfig, hp: PPOParams, device, rollout_tiled,
                  mesh: Optional[DataMesh] = None, dp_update: bool = False,
                  fused_gae: bool = True, fused_grads: bool = True,
                  bf16_traj: bool = False, bf16_policy: bool = False):
    """(run, gen): `run(state, noise, mark, tick_base)` is the collect
    with the pulse drawn from the generator `gen` as it stands (unless
    `noise` is given) and kernel B's Philox ticks from tick_base (an int
    or a 0-d int32 tensor on the card).  Under a mesh the state holds the
    rank's columns and `noise` the whole fleet's draws.  fused_gae=False
    is the JAX trainer's `--no-fused-gae` tail (`_unfused_tail`), which
    also serves `--no-fused-grads`.  bf16_traj / bf16_policy select kernel
    B's bf16 branches (the trajectory's dtype then picks its consumers')."""
    ti = hp.trainee_idx
    fi = 1 - ti
    T = hp.num_rollout_steps
    ti_lo = ti * OBS
    fi_lo = fi * OBS
    dev = torch.device(device)
    shard_worlds(hp, mesh, rollout_tiled, dp_update)
    gather = mesh is not None and not dp_update
    cols = None if mesh is None else mesh.columns(hp.num_envs)
    gen = torch.Generator(device=dev)

    def local(x):
        """The rank's columns of a whole-fleet draw."""
        return x if cols is None or x is None else x[:, cols].contiguous()

    reset_pulse = _reset_pulse(cfg, hp, dev, gen, local)
    unfused = _unfused_tail(hp, dev, fused_grads)

    @torch.no_grad()
    def run(state: RolloutState, noise: Optional[CollectNoise], mark,
            tick_base):
        mark = mark or (lambda name: None)
        agent = state.agent
        sf, si, obs = reset_pulse(state, noise)
        mark("reset_pulse")

        mats = FR.pack_policy(agent)
        fmats = FR.pack_policy(state.frozen) if hp.use_frozen else None
        kw = dict(n_steps=T, trainee_idx=ti, seed=state.seed,
                  tick_base=tick_base,
                  noise=None if noise is None else local(noise.rollout))
        if cols is not None:
            kw["world_base"] = cols.start
        if rollout_tiled:
            sf, si, obs, traj = FR.fused_rollout_tiled(cfg, sf, si, obs,
                                                       mats, fmats, **kw)
        else:
            sf, si, obs, traj, om = FR.fused_rollout(
                cfg, sf, si, obs, mats, fmats, **kw,
                traj_dtype=torch.bfloat16 if bf16_traj else F32,
                policy_bf16=bf16_policy)
        mark("rollout")
        obs_t = obs[ti_lo:ti_lo + OBS]
        if gather:
            # the whole fleet's trajectory and last trainee obs, in world
            # order, on every rank
            traj = all_gather_columns(traj, mesh)
            obs_t = all_gather_columns(obs_t, mesh)
            mark("all_gather")

        next_value = agent_lib.evaluate(agent, obs_t.T)
        if not fused_gae:
            return unfused(state, sf, si, obs, traj, next_value, mark)
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
        if dp_update:
            # the ranks' blocks stacked in world order: the fleet's blocks
            moments = all_gather(moments, mesh).flatten(0, 1)
            ticks = all_gather(ticks, mesh).flatten(0, 1)
        mark("gae")
        if rollout_tiled or gather:
            om = FG.obs_moments(traj, FR.ROLL_OBS)
            mark("obs_moments")

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
        if dp_update:
            obs_rms = rms_update_padded_moments(
                agent.obs_rms, *combine_shard_moments(all_gather(om, mesh)))
        else:
            obs_rms = rms_update_padded_moments(agent.obs_rms, om[:, 0],
                                                om[:, 1], om[0, 2])
        adv_n = (side[:, FG.SIDE_ADV] - am_b) * ar
        values_n = torch.clamp(
            (side[:, FG.SIDE_VALUE] - value_rms.mean[0]) * vr_post,
            -5.0, 5.0)
        means = torch.stack([adv_n.abs().mean(), values_n.mean()])
        if dp_update:
            # the fleet's means over equal shards
            means = all_reduce_(means, mesh) * (1.0 / mesh.size)
        metrics = {
            "mean_reward": stats.mean_reward,
            "mean_episode_length": stats.mean_length,
            "reward_window": stats.reward_size,
            "adv_abs_mean": means[0],
            "value_mean": means[1],
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

    return run, gen


def stats_scan(stats: EpisodeStats, rewards, dones) -> EpisodeStats:
    """T steps of `_stats_step` over (T, N) rewards and dones
    (train_fused.py:568-570)."""
    for t in range(rewards.shape[0]):
        stats = _stats_step(stats, rewards[t], dones[t])
    return stats


def _metrics(stats: EpisodeStats, adv_n, values_n) -> dict:
    return {"mean_reward": stats.mean_reward,
            "mean_episode_length": stats.mean_length,
            "reward_window": stats.reward_size,
            "adv_abs_mean": adv_n.abs().mean(),
            "value_mean": values_n.mean()}


def _unfused_tail(hp: PPOParams, dev, fused_grads: bool):
    """`tail(state, sf, si, obs, traj, next_value, mark) -> (state', out)`:
    what the JAX trainer runs after the rollout kernel without fused GAE
    (train_fused.py:563-570,679-733).  The per-tick episode stats scan,
    `normalize_advantages` (GAE, the value normalizer, the standardized
    advantages), then

      * fused_grads: the normalized side array (T, 8, W) [value_n, adv_n,
        ret_n, 0...] and the obs normalizer's merge of the trajectory's
        obs rows (`rms_update_padded_tdw`); out["ustats"] is None, so
        kernel D takes the side rows as they are;
      * not fused_grads: value_n, adv_n and ret_n written into the
        trajectory's spare rows R_LOGP + 1..3 (the last over the raw
        value, dead once GAE has run), the (T * W, 128) feat matrix, and
        `rms_update_padded` of its obs columns; out["feat"] feeds the
        autodiff update.

    Kernel B's obs-moment fold still runs on these paths (its partials are
    not read), as the JAX trainer leaves them out only by building B
    without them."""
    T = hp.num_rollout_steps

    def tail(state, sf, si, obs, traj, next_value, mark):
        agent = state.agent
        done = traj[:, FR.R_DONE]
        rewards = traj[:, FR.R_REW]
        stats = stats_scan(state.stats, rewards, done)
        value_rms, adv_n, values_n, returns_n = normalize_advantages(
            hp, agent, traj[:, FR.R_VALUE], rewards, 1.0 - done, next_value)
        mark("gae")
        W = traj.shape[2]
        out = dict(stats=stats, metrics=_metrics(stats, adv_n, values_n),
                   ustats=None)
        if fused_grads:
            side = torch.zeros((T, FG.SIDE_ROWS, W), dtype=F32, device=dev)
            side[:, FG.SIDE_VALUE] = values_n
            side[:, FG.SIDE_ADV] = adv_n
            side[:, FG.SIDE_RET] = returns_n
            obs_rms = rms_update_padded_tdw(agent.obs_rms,
                                            traj[:, :FR.ROLL_OBS])
            out.update(traj=traj, side=side)
        else:
            traj[:, FR.R_LOGP + 1] = values_n
            traj[:, FR.R_LOGP + 2] = adv_n
            traj[:, FR.R_LOGP + 3] = returns_n
            feat = traj.transpose(1, 2).reshape(T * W, FR.ROLL_ROWS)
            obs_rms = rms_update_padded(agent.obs_rms, feat[:, :FR.ROLL_OBS])
            out.update(traj=traj, feat=feat)
        mark("glue")
        out.update(obs_rms=obs_rms, value_rms=value_rms)
        new_agent = Agent(net=agent.net, obs_rms=obs_rms,
                          value_rms=value_rms)
        return dataclasses.replace(state, agent=new_agent, sf=sf, si=si,
                                   obs=obs, stats=stats,
                                   counter=state.counter + 1), out

    return tail


def _per_tick_body(cfg: SimConfig, hp: PPOParams, device,
                   mesh: Optional[DataMesh] = None, worlds=RowsWorlds):
    """(run, gen) of the per-tick rollout, the JAX trainer's
    `--no-rollout-kernel` / `--backend xla-rows` collect
    (train_fused.py:190-257,752-776), and with
    worlds=ppo/train.py::StructuredWorlds the structured trainer's
    (train.py:343-440): the reset pulse, then T ticks of

      the trainee's policy in torch on its obs (Gumbel-max from uniforms),
      the frozen opponent's likewise (use_frozen), the actions written
      into the worlds, one tick (kernel A on the rows, the systems of
      systems.py on the structured state) with the tick's sim noise, one
      trajectory row appended;

    then `next_value`, the episode stats scan and `compute_advantages`
    (make_update_fns).  `run(state, noise, mark, tick_base)` draws each
    tick's uniforms from `gen` in the order trainee (19, W), frozen
    (19, W), sim noise (9, W), unless `noise` is given: noise.rollout is
    then kernel B's external-noise matrix (T * EXT_NOISE_CHUNK, W), so the
    same draws drive this collect and kernel B's.  tick_base is unused.
    Under a data mesh each rank steps its columns and the trajectory is
    all-gathered before the stats, so the learner sees the whole fleet.
    With hp.record_world0 out["metrics"]["world0"] holds world 0's
    per-tick rows (each leaf (T, 1, ...))."""
    ti, fi = hp.trainee_idx, 1 - hp.trainee_idx
    T = hp.num_rollout_steps
    dev = torch.device(device)
    W_l = shard_worlds(hp, mesh, rollout_kernel=False)
    cols = None if mesh is None else mesh.columns(hp.num_envs)
    gen = torch.Generator(device=dev)
    compute_advantages, _ = make_update_fns(hp)
    CH = FR.EXT_NOISE_CHUNK

    def local(x):
        return x if cols is None or x is None else x[:, cols].contiguous()

    reset_pulse = _reset_pulse(cfg, hp, dev, gen, local, worlds)

    def draws(noise, t):
        if noise is not None:
            c = local(noise.rollout[t * CH:(t + 1) * CH])
            tu = c[FR.EXT_TRAINEE_U:FR.EXT_TRAINEE_U + FR.N_LOGITS]
            fu = c[FR.EXT_FROZEN_U:FR.EXT_FROZEN_U + FR.N_LOGITS]
            return tu, fu, c[:N_NOISE_ROWS]
        tu = torch.rand((FR.N_LOGITS, hp.num_envs), generator=gen,
                        device=dev)
        fu = torch.rand((FR.N_LOGITS, hp.num_envs), generator=gen,
                        device=dev) if hp.use_frozen else None
        sim = draw_noise_rows(hp.num_envs, gen, dev)
        return local(tu), local(fu), local(sim)

    @torch.no_grad()
    def run(state, noise: Optional[CollectNoise], mark, tick_base):
        mark = mark or (lambda name: None)
        agent = state.agent
        env = reset_pulse(state, noise)
        mark("reset_pulse")
        obs_b = torch.empty((T, OBS, W_l), dtype=F32, device=dev)
        act_b = torch.empty((T, 6, W_l), dtype=I32, device=dev)
        tick = torch.empty((T, 4, W_l), dtype=F32, device=dev)
        w0 = []
        for t in range(T):
            tu, fu, sim = draws(noise, t)
            obs_t = worlds.obs(env, ti)
            obs_b[t] = obs_t.T
            actions, logp, value = agent_lib.forward(
                agent, obs_t, FR.gumbel_from_uniform(tu).T)
            env = worlds.set_actions(env, ti, actions)
            if hp.use_frozen:
                fa = agent_lib.act(state.frozen, worlds.obs(env, fi),
                                   FR.gumbel_from_uniform(fu).T)
                env = worlds.set_actions(env, fi, fa)
            env = worlds.step(cfg, env, sim)
            rew, done = worlds.reward_done(env, ti)
            act_b[t] = actions.T
            tick[t, 0] = value
            tick[t, 1] = logp
            tick[t, 2] = rew
            tick[t, 3] = done
            if hp.record_world0:
                w0.append(worlds.world0(env, done))
        mark("rollout")
        last = worlds.obs(env, ti).T
        if cols is not None:
            obs_b, act_b, tick, last = (all_gather_columns(x, mesh) for x in
                                        (obs_b, act_b, tick, last))
            mark("all_gather")
        done = tick[:, 3]
        stats = stats_scan(state.stats, tick[:, 2], done)
        buf = dict(obs=obs_b.transpose(1, 2), actions=act_b.transpose(1, 2),
                   values=tick[:, 0], log_probs=tick[:, 1],
                   not_dones=1.0 - done, rewards=tick[:, 2],
                   next_value=agent_lib.evaluate(agent, last.T))
        new_agent, adv_n, values_n, returns_n = compute_advantages(agent, buf)
        mark("gae")
        metrics = _metrics(stats, adv_n, values_n)
        if hp.record_world0:
            metrics["world0"] = {k: torch.stack([w[k] for w in w0])
                                 for k in w0[0]}
        out = dict(buf=buf, advantages=adv_n, values_n=values_n,
                   returns_n=returns_n, obs_rms=new_agent.obs_rms,
                   value_rms=new_agent.value_rms, stats=stats,
                   metrics=metrics)
        state = dataclasses.replace(state, agent=new_agent, stats=stats,
                                    counter=state.counter + 1,
                                    **worlds.fields(env))
        return state, out

    return run, gen


def world0_rows(sf, si, done) -> dict:
    """World 0's npz telemetry of one tick from the rows, in the schema of
    the reference's trajectory logs (train_fused.py:779-820): each leaf
    carries a leading world axis of 1."""
    def gf(k):
        return sf[F_IDX[k], 0]

    def gi(k):
        return si[I_IDX[k], 0]

    A = C.NUM_AGENTS

    def per_agent(get, names):
        return torch.stack([torch.stack([get(f"a{i}.{n}") for n in names])
                            for i in range(A)])

    game = torch.stack([
        gi("ginb").to(F32), gi("glive").to(F32), gf("period"), gf("tip"),
        gi("t0hoop").to(F32), gf("t0score"), gi("t1hoop").to(F32),
        gf("t1score"), gf("gclock"), gf("sclock"), gf("sbaskets"), gf("oob"),
        gf("iclock"), gi("is1v1").to(F32)])
    return {
        "agent_pos": per_agent(gf, ("pos_x", "pos_y", "pos_z"))[None],
        "ball_pos": torch.stack([gf("bpos_x"), gf("bpos_y"),
                                 gf("bpos_z")])[None, None],
        "ball_vel": torch.stack([gf("bvel_x"), gf("bvel_y"),
                                 gf("bvel_z")])[None, None],
        "orientation": per_agent(gf, ("quat_w", "quat_x", "quat_y",
                                      "quat_z"))[None],
        "ball_physics": torch.stack([
            gi("binflight"), gi("blt_agent"), gi("blt_team"),
            gi("bsb_agent"), gi("bsb_team"), gi("bspv"),
            gi("bsgi")])[None, None],
        "agent_possession": per_agent(gi, ("has_ball", "held_ball",
                                           "points_worth"))[None],
        "game_state": game[None],
        "rewards": torch.stack([gf(f"a{i}.reward") for i in range(A)])[None],
        "actions": per_agent(gi, ACTION_NAMES)[None],
        "done": done[0:1],
    }


# ---------------------------------------------------------------------
# The whole iteration: collect, then the update phase
# ---------------------------------------------------------------------

@dataclasses.dataclass
class TrainState(RolloutState):
    opt: AdamState
    iteration: int = 0


def init_train_state(cfg: SimConfig, hp: PPOParams, seed: int,
                     device="cuda", agent: Optional[Agent] = None,
                     frozen: Optional[Agent] = None) -> TrainState:
    rs = init_rollout_state(cfg, hp, seed, device, agent, frozen)
    opt = init_adam(FU.pack_weights(rs.agent.net))
    return TrainState(**{f.name: getattr(rs, f.name)
                         for f in dataclasses.fields(RolloutState)},
                      opt=opt, iteration=0)


# ---- full train-state resume (madrona_basketball_tpu/utils/
# checkpoint.py:87-97): the pulse and permutation generators are reseeded
# from (seed, counter) before every iteration, so a restored state
# continues bit for bit like the run that saved it ----

_RMS = ("obs_rms", "value_rms")
_RMS_FIELDS = ("mean", "var", "count")


def _agent_tensors(agent: Agent) -> dict:
    return {"net": {k: v.detach().cpu().clone()
                    for k, v in agent.net.state_dict().items()},
            **{attr: {f: getattr(getattr(agent, attr), f).detach().cpu()
                      for f in _RMS_FIELDS}
               for attr in _RMS}}


def _agent_from(d: dict, device) -> Agent:
    net = agent_lib.ActorCritic()
    net.load_state_dict(d["net"])
    return Agent(net=net.to(device),
                 **{attr: RMSState(**{f: d[attr][f].to(device)
                                      for f in _RMS_FIELDS})
                    for attr in _RMS})


def save_train_state(state: TrainState, path: str) -> str:
    """`torch.save` of the whole `TrainState` (rows, episode stats, both
    agents, Adam's moments and step count, seed, iteration counter) as
    plain dicts of CPU tensors and ints, so `restore_train_state` loads
    it with `weights_only=True`."""
    stats = state.stats
    blob = {
        "agent": _agent_tensors(state.agent),
        "frozen": _agent_tensors(state.frozen),
        "rows": {k: getattr(state, k).detach().cpu()
                 for k in ("sf", "si", "obs")},
        "stats": {f.name: getattr(stats, f.name).detach().cpu()
                  for f in dataclasses.fields(stats)},
        "opt": {"count": state.opt.count,
                "mu": [m.detach().cpu() for m in state.opt.mu],
                "nu": [v.detach().cpu() for v in state.opt.nu]},
        "seed": state.seed, "counter": state.counter,
        "iteration": state.iteration,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(blob, path)
    return path


def restore_train_state(path: str, device="cuda") -> TrainState:
    """The `TrainState` that `save_train_state` wrote, on `device`."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    opt = blob["opt"]
    return TrainState(
        agent=_agent_from(blob["agent"], device),
        frozen=_agent_from(blob["frozen"], device),
        **{k: v.to(device) for k, v in blob["rows"].items()},
        stats=EpisodeStats(**{k: v.to(device)
                              for k, v in blob["stats"].items()}),
        seed=blob["seed"], counter=blob["counter"],
        opt=AdamState(count=opt["count"],
                      mu=tuple(m.to(device) for m in opt["mu"]),
                      nu=tuple(v.to(device) for v in opt["nu"])),
        iteration=blob["iteration"])


def update_block(hp: PPOParams) -> int:
    """The update's block width: `hp.update_block`, else the JAX default
    `pick_update_block(W, mb)` (it sets which samples share a minibatch,
    so it is training semantics, not a tuning knob)."""
    wb = hp.update_block or FU.pick_update_block(hp.num_envs,
                                                 hp.minibatch_size)
    if hp.num_envs % wb or hp.minibatch_size % wb:
        raise ValueError(f"update_block={wb} must divide both num_envs="
                         f"{hp.num_envs} and minibatch_size="
                         f"{hp.minibatch_size}")
    return wb


@torch.no_grad()
def dp_update_phase(hp_l: PPOParams, mesh: DataMesh, idx, count, traj, side,
                    ustats, nrm, params, mu, nu, *, wb: int):
    """The update phase of `dp_update` (JAX `_dp_body`,
    train_fused.py:445-486) over this rank's blocks: hp_l is the rank's
    PPOParams (num_envs W_l, so its minibatch is the rank's share), idx
    this rank's (n * mb_l / wb,) block indices, whole minibatches in
    order; traj (T, 128, W_l) and the raw side (T, 8, W_l) the rank's,
    normalized here once from ustats.  Per minibatch: kernel G's gradient
    over the rank's blocks, summed over the ranks and scaled by 1 / size
    (the mean over the whole minibatch), then `clip_adam_step` at step
    count + k + 1 (count an int, or a 0-d int32 tensor on the card).
    Returns (params', mu', nu')."""
    bpm = hp_l.minibatch_size // wb
    side_n = FU.normalize_side(side, ustats)
    if traj.device.type == "cuda":
        from .. import _build
        count = _build.device_int(count, traj.device)
    for k in range(idx.numel() // bpm):
        g = FU.fused_minibatch_grad_prefetch(
            hp_l, idx[k * bpm:(k + 1) * bpm], traj, side_n, nrm, *params,
            wb=wb)
        flat = all_reduce_(torch.cat([x.reshape(-1) for x in g]), mesh)
        flat.mul_(1.0 / mesh.size)
        g = [x.view_as(p) for x, p in
             zip(flat.split([p.numel() for p in params]), params)]
        params, mu, nu = clip_adam_step(
            params, mu, nu, g, count + (k + 1), lr=hp_l.learning_rate,
            max_norm=hp_l.max_grad_norm)
    return params, mu, nu


ROLLOUT_KERNEL_WORLD0 = ("rollout_kernel does not support record_world0; "
                         "use the scan rollout (e.g. --viewer without "
                         "--rollout-kernel)")
ROLLOUT_KERNEL_BACKEND = ("rollout_kernel requires the pallas backend "
                          "(TPU); pass rollout_interpret=True to dry-run on "
                          "CPU")
FUSED_GAE_NEEDS = ("fused_gae requires rollout_kernel=True and "
                   "fused_grads=True (it consumes the trajectory buffer's "
                   "raw-side contract)")
TILED_NEEDS = ("rollout_tiled selects the 2-D-tiled variant of the rollout "
               "kernel; pass rollout_kernel=True")
BF16_TRAJ_NEEDS = ("bf16_traj requires the flagship path (rollout_kernel + "
                   "fused_grads + fused_gae, untiled): only its Pallas "
                   "consumers understand the bf16 trajectory layout")
BF16_POLICY_NEEDS = ("bf16_policy selects bf16 matmul operands inside the "
                     "(untiled) rollout kernel; pass rollout_kernel=True")


def check_paths(hp: PPOParams, backend: str, rollout_kernel: bool,
                fused_grads: bool, fused_gae: bool, rollout_tiled: bool,
                mesh, dp_update: bool, bf16_traj: bool = False,
                bf16_policy: bool = False):
    """The JAX trainer's checks of its path flags, with its messages
    (train_fused.py:132-160): among them, bf16_traj takes the untiled
    fused-GAE path (the flagship, a plain mesh, dp_update) and
    bf16_policy the untiled rollout kernel (also --no-fused-gae and
    --no-fused-grads)."""
    if backend not in ("pallas", "xla"):
        raise ValueError(f"backend must be 'pallas' or 'xla', not "
                         f"{backend!r}")
    if rollout_kernel and hp.record_world0:
        raise ValueError(ROLLOUT_KERNEL_WORLD0)
    if rollout_kernel and backend != "pallas":
        raise ValueError(ROLLOUT_KERNEL_BACKEND)
    if fused_gae and not (rollout_kernel and fused_grads):
        raise ValueError(FUSED_GAE_NEEDS)
    if rollout_tiled and not rollout_kernel:
        raise ValueError(TILED_NEEDS)
    if bf16_traj and not (fused_gae and not rollout_tiled):
        raise ValueError(BF16_TRAJ_NEEDS)
    if bf16_policy and not (rollout_kernel and not rollout_tiled):
        raise ValueError(BF16_POLICY_NEEDS)
    if dp_update and not (mesh is not None and fused_gae and
                          not rollout_tiled):
        raise ValueError(DP_UPDATE_NEEDS)


def make_train_iteration(cfg: SimConfig, hp: PPOParams, device="cuda",
                         rollout_tiled: bool = False,
                         mesh: Optional[DataMesh] = None,
                         dp_update: bool = False, *,
                         rollout_kernel: bool = True,
                         fused_grads: bool = True,
                         fused_gae: Optional[bool] = None,
                         backend: str = "pallas", worlds=RowsWorlds,
                         bf16_traj: bool = False, bf16_policy: bool = False):
    """The iteration of the JAX `make_train_iteration_fused` for its path
    flags (fused_gae None: on when rollout_kernel and fused_grads are, as
    the JAX CLI defaults it), checked with its messages (`check_paths`):

      * rollout kernel + fused GAE (the flagship, and `rollout_tiled`):
        kernels B (or I), C, meter, E, D, as the module docstring says;
      * rollout kernel, fused_gae=False (`--no-fused-gae`): B (or I),
        then `_unfused_tail`'s torch GAE and kernel D with ustats=None on
        the normalized side rows;
      * rollout kernel, fused_grads=False (`--no-fused-grads`): B (or I),
        `_unfused_tail`'s feat matrix, then the autodiff update
        (ppo/train.py::make_update_fns) shuffled in hp.shuffle_block
        super-rows;
      * rollout_kernel=False (`--no-rollout-kernel`, and backend "xla",
        the JAX CLI's `--backend xla-rows`): `_per_tick_body`'s T
        launches of kernel A with the policy in torch, then the autodiff
        update (with `worlds`=ppo/train.py::StructuredWorlds, the
        structured trainer: its engine's tick in place of kernel A);
      * bf16_traj (untiled fused GAE): kernel B stores the trajectory in
        bf16 and C, E, D (or G) upcast it on load; bf16_policy (untiled
        rollout kernel): kernel B's Dense layers take bf16 operands.
        On the card kernel A is the rows tick's only implementation, so
        "pallas" and "xla" run the same tick; the backend only decides,
        as in JAX, whether the rollout kernel may be asked for.

    perms (injected or drawn from the permutation generator): kernel D's
    (E, T * W / wb) block permutations on the D paths, the autodiff
    update's (E, T * W / shuffle_block) super-row permutations (argsort
    of uint32-range draws, as the JAX package draws them) on the others;
    under dp_update (size, E, T * W_l / wb)."""
    if fused_gae is None:
        fused_gae = rollout_kernel and fused_grads
    check_paths(hp, backend, rollout_kernel, fused_grads, fused_gae,
                rollout_tiled, mesh, dp_update, bf16_traj, bf16_policy)
    T = hp.num_rollout_steps
    if hp.num_minibatches * hp.minibatch_size != T * hp.num_envs:
        raise ValueError(
            f"num_minibatches={hp.num_minibatches} must divide the rollout "
            f"batch ({T}*{hp.num_envs}={T * hp.num_envs} samples) exactly "
            f"for the update phase")
    W_l = shard_worlds(hp, mesh, rollout_tiled, dp_update, rollout_kernel)
    n_updates = hp.update_epochs * hp.num_minibatches
    dev = torch.device(device)
    autodiff = not (rollout_kernel and fused_grads)
    if rollout_kernel:
        run_collect, pulse_gen = _collect_body(
            cfg, hp, device, rollout_tiled, mesh, dp_update, fused_gae,
            fused_grads, bf16_traj, bf16_policy)
    else:
        run_collect, pulse_gen = _per_tick_body(cfg, hp, device, mesh,
                                                worlds)
    perm_gen = torch.Generator(device=dev)
    if autodiff:
        _, update_policy = make_update_fns(hp)
        perm_shape = update_policy.perm_shape
    elif dp_update:
        hp_l = dataclasses.replace(hp, num_envs=W_l)
        if hp.num_minibatches * hp_l.minibatch_size != T * W_l:
            raise ValueError(f"dp_update: num_minibatches="
                             f"{hp.num_minibatches} must divide a rank's "
                             f"{T * W_l} samples")
        wb = hp.update_block or FU.pick_update_block(W_l,
                                                     hp_l.minibatch_size)
        if W_l % wb or hp_l.minibatch_size % wb:
            raise ValueError(f"dp_update: update_block={wb} must divide "
                             f"both worlds/shard={W_l} and the local "
                             f"minibatch={hp_l.minibatch_size}")
        perm_shape = (mesh.size, hp.update_epochs, T * (W_l // wb))
    else:
        wb = update_block(hp)
        perm_shape = (hp.update_epochs, T * (hp.num_envs // wb))

    def reseed(seed: int, counter: int):
        """Seed both generators for iteration `counter`."""
        pulse_gen.manual_seed(pulse_seed(seed, counter))
        perm_gen.manual_seed(perm_seed(seed, counter))

    def draw_perms():
        if autodiff:
            return update_policy.draw_perms(perm_gen, dev)
        return torch.stack([
            torch.randperm(perm_shape[-1], generator=perm_gen, device=dev)
            for _ in range(math.prod(perm_shape[:-1]))
        ]).reshape(perm_shape)

    def run(state: TrainState, noise, perms, mark, tick_base, count):
        """One iteration with kernel B's tick_base and the Adam count
        given (ints, or 0-d int32 tensors on the card), drawing what is
        not injected from the generators as they stand."""
        mark_ = mark or (lambda name: None)
        if perms is None:
            perms = draw_perms()
            mark_("perms")
        if tuple(perms.shape) != perm_shape:
            raise ValueError(f"perms must be {perm_shape}")
        state, out = run_collect(state, noise, mark, tick_base)
        agent = state.agent
        if not rollout_kernel:
            agent, opt = update_policy(
                agent, state.opt, out["buf"], out["advantages"],
                out["values_n"], out["returns_n"], perms.to(dev), count)
        elif autodiff:
            agent, opt = update_policy.with_feat(
                agent, state.opt, out["feat"], FR.ROLL_OBS, 6, perms.to(dev),
                count)
        else:
            with torch.no_grad():
                if dp_update:
                    params, mu, nu = dp_update_phase(
                        hp_l, mesh, perms[mesh.rank].to(device=dev, dtype=I32)
                        .reshape(-1), count, out["traj"], out["side"],
                        out["ustats"], FU.pack_norm(agent.obs_rms),
                        FU.pack_weights(agent.net), state.opt.mu,
                        state.opt.nu, wb=wb)
                else:
                    params, mu, nu = FU.fused_update_phase(
                        hp, perms.to(device=dev, dtype=I32).reshape(-1),
                        count, out["traj"], out["side"],
                        FU.pack_norm(agent.obs_rms), out["ustats"],
                        FU.pack_weights(agent.net), state.opt.mu,
                        state.opt.nu, wb=wb)
                FU.unpack_weights(agent.net, *params)
            opt = AdamState(count=state.opt.count + n_updates, mu=mu, nu=nu)
        mark_("update")
        state = dataclasses.replace(state, opt=opt,
                                    iteration=state.iteration + 1)
        return state, out

    def train_iteration(state: TrainState,
                        noise: Optional[CollectNoise] = None,
                        perms: Optional[torch.Tensor] = None,
                        mark: Optional[Callable[[str], None]] = None):
        """One iteration.  perms (`make_train_iteration`'s shapes) injects
        the epochs' permutations; noise the whole fleet's draws
        (CollectNoise); `mark(name)` is called after each phase (the
        collect's, then "update").  Returns (state', out), `out` as the
        collect gives it, the metrics at out["metrics"].  With no `mark`
        and the tracer on, the tracer's stamps, "start" to "writeback",
        then a sample of the rule-phase counter it reports."""
        reseed(state.seed, state.counter)
        if mark is None and TRACER.on:
            TRACER.mark("start")
            state, out = run(state, noise, perms, TRACER.mark,
                             state.counter * T, state.opt.count)
            TRACER.mark("writeback")
            _sample_rule_phases(state)
            return state, out
        return run(state, noise, perms, mark, state.counter * T,
                   state.opt.count)

    def static(state: TrainState) -> "StaticIteration":
        """This iteration's static-buffer form, loaded with `state`."""
        return StaticIteration(state, run, reseed, (pulse_gen, perm_gen),
                               T, n_updates)

    train_iteration.static = static
    train_iteration.mesh = mesh
    train_iteration.perm_shape = perm_shape
    return train_iteration


# ---------------------------------------------------------------------
# The static-buffer form (what a CUDA graph captures)
# ---------------------------------------------------------------------

# the iteration's metrics, in the order of StaticIteration.metrics
METRICS = ("mean_reward", "mean_episode_length", "reward_window",
           "adv_abs_mean", "value_mean")


def world_tensors(state) -> list:
    """The fleet's tensors of a rows TrainState (sf, si, obs) or of the
    structured trainer's (its env State's tensors, in field order)."""
    if hasattr(state, "sf"):
        return [state.sf, state.si, state.obs]
    from ..state import tree_leaves
    return tree_leaves(state.env)


def state_device(state) -> torch.device:
    return state.sf.device if hasattr(state, "sf") else \
        state.env.reset_now.device


def state_tensors(state: TrainState) -> list:
    """Every tensor of a TrainState, in a fixed order: both agents'
    weights and normalizers, the rows, the episode stats, Adam's
    moments."""
    out = []
    for a in (state.agent, state.frozen):
        out += list(a.net.parameters())
        out += [getattr(r, f) for r in (a.obs_rms, a.value_rms)
                for f in ("mean", "var", "count")]
    out += world_tensors(state)
    out += [getattr(state.stats, f.name)
            for f in dataclasses.fields(EpisodeStats)]
    return out + list(state.opt.mu) + list(state.opt.nu)


def _sample_rule_phases(state):
    """The rule-phase counter that the tracer reports, on a rows state's
    fleet (the structured trainer's state holds no rows: not sampled)."""
    if hasattr(state, "sf"):
        rule_phases.COUNTER.sample(state.sf, state.si)


def _clone_rms(r: RMSState) -> RMSState:
    return RMSState(mean=r.mean.clone(), var=r.var.clone(),
                    count=r.count.clone())


class StaticIteration:
    """One training iteration on tensors that keep their addresses.

    `self.state` is a TrainState of the iteration's own tensors; its host
    ints are unused: `counter` and `count` (0-d int32 on the state's
    device) hold the iteration counter and the Adam step count.  `load`
    copies a TrainState in; `step()` runs one iteration from the buffers
    (tick_base = counter * T and the Adam count read on the device, the
    pulse and the permutations drawn from `generators` as they stand),
    copies the result back into them, writes the metrics (METRICS order)
    into `metrics` and advances both counters: nothing in it reads a
    value on the host, so a CUDA graph can capture it.  Before each
    `step()` the caller reseeds the generators (`reseed(seed, counter)`),
    which makes it the eager `train_iteration`.  `result(state, n)` is
    the TrainState after n steps from `state`: the weights are copied
    into state's module in place (as the eager iteration updates it),
    every other tensor is a copy."""

    def __init__(self, state: TrainState, run, reseed, generators, T: int,
                 n_updates: int):
        self._run, self._T, self._n_updates = run, T, n_updates
        self.reseed, self.generators = reseed, generators
        self.state = copy.deepcopy(state)
        if not hasattr(state, "sf"):
            # own contiguous buffers (a view's deep copy keeps its strides)
            from ..state import tree_map
            self.state.env = tree_map(lambda t: t.contiguous().clone(),
                                      self.state.env)
        dev = state_device(state)
        self.counter = torch.zeros((), dtype=I32, device=dev)
        self.count = torch.zeros((), dtype=I32, device=dev)
        self.metrics = torch.zeros((len(METRICS),), dtype=F32, device=dev)
        self.world0 = None
        self.load(state)

    @torch.no_grad()
    def load(self, state: TrainState):
        if state.seed != self.state.seed:
            raise ValueError(f"seed {state.seed}: these buffers run kernel "
                             f"B's Philox key {self.state.seed}")
        for dst, src in zip(state_tensors(self.state), state_tensors(state)):
            dst.copy_(src)
        self.counter.fill_(state.counter)
        self.count.fill_(state.opt.count)

    @torch.no_grad()
    def step(self):
        st = self.state
        mark = TRACER.mark if TRACER.on else None
        if mark:
            mark("start")
        new, out = self._run(st, None, None, mark, self.counter * self._T,
                             self.count)
        for dst, src in zip(state_tensors(st), state_tensors(new)):
            if dst is not src:      # the weights are updated in place
                dst.copy_(src)
        self.metrics.copy_(torch.stack([out["metrics"][k]
                                        for k in METRICS]))
        # world 0's rows (record_world0): the step's own tensors, which a
        # captured step rewrites in place at every replay
        self.world0 = out["metrics"].get("world0")
        self.counter.add_(1)
        self.count.add_(self._n_updates)
        if mark:
            mark("writeback")
            _sample_rule_phases(st)

    @torch.no_grad()
    def result(self, state: TrainState, n: int) -> TrainState:
        s = self.state
        for dst, src in zip(state.agent.net.parameters(),
                            s.agent.net.parameters()):
            dst.copy_(src)
        agent = Agent(net=state.agent.net,
                      obs_rms=_clone_rms(s.agent.obs_rms),
                      value_rms=_clone_rms(s.agent.value_rms))
        stats = EpisodeStats(**{f.name: getattr(s.stats, f.name).clone()
                                for f in dataclasses.fields(EpisodeStats)})
        opt = AdamState(count=state.opt.count + n * self._n_updates,
                        mu=tuple(m.clone() for m in s.opt.mu),
                        nu=tuple(v.clone() for v in s.opt.nu))
        if hasattr(s, "sf"):
            fleet = dict(sf=s.sf.clone(), si=s.si.clone(), obs=s.obs.clone())
        else:
            from ..state import tree_map
            fleet = dict(env=tree_map(torch.clone, s.env))
        return dataclasses.replace(
            state, agent=agent, stats=stats, counter=state.counter + n,
            opt=opt, iteration=state.iteration + n, **fleet)
