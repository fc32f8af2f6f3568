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

`train_iteration.static(state)` is the iteration's static-buffer form,
`StaticIteration`: the state copied into tensors that keep their
addresses, and `step()`, one iteration from those tensors back into
them that reads tick_base and the Adam count from device counters and
advances them.  `ppo/train.py::make_train_chunk` captures one `step()`
in a CUDA graph and replays it.
"""

from __future__ import annotations

import copy
import dataclasses
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
from ..models.normalize import (RMSState, _rms_merge,
                                rms_update_padded_moments)
from ..ops import fused_gae as FG
from ..ops import fused_rollout as FR
from ..ops import fused_update as FU
from ..ops.fused_step import fused_step
from ..ops.layout import ACTION_ROWS, N_OBS_ROWS, RESET_ROWS
from .hparams import PPOParams
from .train import AdamState, EpisodeStats, init_adam, init_stats, meter_scan

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


def _collect_body(cfg: SimConfig, hp: PPOParams, device, rollout_tiled):
    """(run, gen): `run(state, noise, mark, tick_base)` is the collect
    with the pulse drawn from the generator `gen` as it stands (unless
    `noise` is given) and kernel B's Philox ticks from tick_base (an int
    or a 0-d int32 tensor on the card)."""
    ti = hp.trainee_idx
    fi = 1 - ti
    T = hp.num_rollout_steps
    ti_lo = ti * OBS
    fi_lo = fi * OBS
    dev = torch.device(device)
    if rollout_tiled:
        FR.check_tiled_worlds(hp.num_envs)
    gen = torch.Generator(device=dev)

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
                  noise=None if noise is None else noise.rollout)
        if rollout_tiled:
            sf, si, obs, traj = FR.fused_rollout_tiled(cfg, sf, si, obs,
                                                       mats, fmats, **kw)
        else:
            sf, si, obs, traj, om = FR.fused_rollout(cfg, sf, si, obs, mats,
                                                     fmats, **kw)
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
        if rollout_tiled:
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

    return run, gen


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


def make_train_iteration(cfg: SimConfig, hp: PPOParams, device="cuda",
                         rollout_tiled: bool = False):
    T = hp.num_rollout_steps
    if hp.num_minibatches * hp.minibatch_size != T * hp.num_envs:
        raise ValueError(
            f"num_minibatches={hp.num_minibatches} must divide the rollout "
            f"batch ({T}*{hp.num_envs}={T * hp.num_envs} samples) exactly "
            f"for the update phase")
    wb = update_block(hp)
    n_blocks = T * (hp.num_envs // wb)
    n_updates = hp.update_epochs * hp.num_minibatches
    dev = torch.device(device)
    run_collect, pulse_gen = _collect_body(cfg, hp, device, rollout_tiled)
    perm_gen = torch.Generator(device=dev)

    def reseed(seed: int, counter: int):
        """Seed both generators for iteration `counter`."""
        pulse_gen.manual_seed(pulse_seed(seed, counter))
        perm_gen.manual_seed(perm_seed(seed, counter))

    def run(state: TrainState, noise, perms, mark, tick_base, count):
        """One iteration with kernel B's tick_base and the Adam count
        given (ints, or 0-d int32 tensors on the card), drawing what is
        not injected from the generators as they stand."""
        mark_ = mark or (lambda name: None)
        if perms is None:
            perms = torch.stack([torch.randperm(n_blocks, generator=perm_gen,
                                                device=dev)
                                 for _ in range(hp.update_epochs)])
        if tuple(perms.shape) != (hp.update_epochs, n_blocks):
            raise ValueError(f"perms must be ({hp.update_epochs}, "
                             f"{n_blocks})")
        state, out = run_collect(state, noise, mark, tick_base)
        agent = state.agent
        with torch.no_grad():
            params, mu, nu = FU.fused_update_phase(
                hp, perms.to(device=dev, dtype=I32).reshape(-1), count,
                out["traj"], out["side"], FU.pack_norm(agent.obs_rms),
                out["ustats"], FU.pack_weights(agent.net), state.opt.mu,
                state.opt.nu, wb=wb)
            FU.unpack_weights(agent.net, *params)
        mark_("update")
        opt = AdamState(count=state.opt.count + n_updates, mu=mu, nu=nu)
        state = dataclasses.replace(state, opt=opt,
                                    iteration=state.iteration + 1)
        return state, out

    def train_iteration(state: TrainState,
                        noise: Optional[CollectNoise] = None,
                        perms: Optional[torch.Tensor] = None,
                        mark: Optional[Callable[[str], None]] = None):
        """One iteration.  perms (E, T * W / wb) injects the epochs' block
        permutations; `mark(name)` is called after each phase (the
        collect's, then "update").  Returns (state', out), `out` as
        `collect` gives it, the metrics at out["metrics"]."""
        reseed(state.seed, state.counter)
        return run(state, noise, perms, mark, state.counter * T,
                   state.opt.count)

    def static(state: TrainState) -> "StaticIteration":
        """This iteration's static-buffer form, loaded with `state`."""
        return StaticIteration(state, run, reseed, (pulse_gen, perm_gen),
                               T, n_updates)

    train_iteration.static = static
    return train_iteration


# ---------------------------------------------------------------------
# The static-buffer form (what a CUDA graph captures)
# ---------------------------------------------------------------------

# the iteration's metrics, in the order of StaticIteration.metrics
METRICS = ("mean_reward", "mean_episode_length", "reward_window",
           "adv_abs_mean", "value_mean")


def state_tensors(state: TrainState) -> list:
    """Every tensor of a TrainState, in a fixed order: both agents'
    weights and normalizers, the rows, the episode stats, Adam's
    moments."""
    out = []
    for a in (state.agent, state.frozen):
        out += list(a.net.parameters())
        out += [getattr(r, f) for r in (a.obs_rms, a.value_rms)
                for f in ("mean", "var", "count")]
    out += [state.sf, state.si, state.obs]
    out += [getattr(state.stats, f.name)
            for f in dataclasses.fields(EpisodeStats)]
    return out + list(state.opt.mu) + list(state.opt.nu)


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
        dev = state.sf.device
        self.counter = torch.zeros((), dtype=I32, device=dev)
        self.count = torch.zeros((), dtype=I32, device=dev)
        self.metrics = torch.zeros((len(METRICS),), dtype=F32, device=dev)
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
        new, out = self._run(st, None, None, None, self.counter * self._T,
                             self.count)
        for dst, src in zip(state_tensors(st), state_tensors(new)):
            if dst is not src:      # the weights are updated in place
                dst.copy_(src)
        self.metrics.copy_(torch.stack([out["metrics"][k]
                                        for k in METRICS]))
        self.counter.add_(1)
        self.count.add_(self._n_updates)

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
        return dataclasses.replace(
            state, agent=agent, sf=s.sf.clone(), si=s.si.clone(),
            obs=s.obs.clone(), stats=stats, counter=state.counter + n,
            opt=opt, iteration=state.iteration + n)
