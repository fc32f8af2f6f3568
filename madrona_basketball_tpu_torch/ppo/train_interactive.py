"""Interactive PPO trainer: a host-loop rollout with human override (port
of `madrona_basketball_tpu.ppo.train_interactive`,
train_interactive.py:40-164; scripts/ppo.py:60-141).

The flagship trainer runs the whole rollout in one kernel launch, and a
human cannot reach into tick 17 of it.  The reference trains through its
EnvWrapper one tick at a time so that the viewer can take over world 0
mid-training; this module keeps that capability.  Each tick: the policy
forward in torch, the controller manager's check, `env.step_with_world_
actions` (kernel A on the card; the viewer's pause freezes the sim), the
episode stats step.  The viewer ticks every step, its H key hands world
0's selected agent to the keyboard and Ctrl+P pauses.  GAE and the
update are `ppo/train.py::make_update_fns`, the post-rollout phase the
JAX interactive trainer also calls.

Timer fences: the PPOTimer synchronizes the card at every phase boundary
(rollout, inference, sim, update) and does nothing on the CPU, so its
spans are the reference's host-visible phases; that is 4 synchronizations
a tick, the reference's semantics.  Use `cli.py --interactive` for
interactive and debugging sessions, the flagship trainer for throughput.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants as C
from ..config import SimConfig
from ..controllers import SimpleControllerManager
from ..env import BasketballEnv
from ..infer import _draw, generator, make_policy_fn
from ..models import agent as agent_lib
from ..models.agent import Agent
from ..ops import fused_update as FU
from ..ops.fused_rollout import N_LOGITS, gumbel_from_uniform
from ..utils.timers import PPOTimer
from .hparams import PPOParams
from .train import _stats_step, init_adam, init_stats, make_update_fns

F32 = torch.float32
I32 = torch.int32


class InteractiveTrainer:
    """One object = one training session over a live `BasketballEnv`.

    Draws: the agents come from a CPU generator seeded `seed` (trainee,
    then frozen), the sim noise from the env's engine generator (seed
    `seed`), the trainee's Gumbel noise and the update's permutations
    from `self.gen` (seed `seed + 1`, on `device`), the frozen opponent's
    Gumbel noise from its own generator (seed `seed + 7`, as the JAX
    trainer's frozen key).  `rollout` and `train_iteration` take seams
    for tests: `noise` (an iterator or callable of (9, W) sim-noise
    matrices, one per env call, the reset's first), `gumbel` (likewise of
    (W, 19) Gumbel draws, one a tick) and `perms` (the update's (E, rows)
    permutations)."""

    def __init__(self, cfg: SimConfig, hp: PPOParams,
                 agent: Optional[Agent] = None,
                 frozen: Optional[Agent] = None, viewer=None,
                 seed: int = 0, timer: Optional[PPOTimer] = None,
                 device="cuda"):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not "
                               "available")
        self.hp, self.device = hp, dev
        self.timer = timer if timer is not None else PPOTimer(dev)
        gen_cpu = torch.Generator().manual_seed(seed)
        self.agent = agent if agent is not None else \
            agent_lib.init_agent(gen_cpu, dev)
        frozen = frozen if frozen is not None else \
            agent_lib.init_agent(gen_cpu, dev)
        self.gen = generator(seed + 1, dev)
        frozen_policy = make_policy_fn(frozen, generator(seed + 7, dev)) \
            if hp.use_frozen else None
        self.env = BasketballEnv(hp.num_envs, cfg, seed=seed,
                                 frozen_policy=frozen_policy,
                                 trainee_agent_idx=hp.trainee_idx,
                                 viewer=viewer, device=dev)
        # scripts/ppo.py:257-258: the manager over the live agent, handed
        # to the env (which forwards it to the viewer)
        self.controller_manager = SimpleControllerManager(self.agent,
                                                          seed=seed)
        self.env.set_controller_manager(self.controller_manager)
        self.opt = init_adam(FU.pack_weights(self.agent.net))
        self.stats = init_stats(hp.num_envs, dev)
        self._compute_advantages, self._update_policy = make_update_fns(hp)

    def _gumbel(self, gumbel):
        if gumbel is not None:
            return torch.as_tensor(_draw(gumbel), dtype=F32,
                                   device=self.device)
        return gumbel_from_uniform(torch.rand(
            (self.hp.num_envs, N_LOGITS), generator=self.gen, dtype=F32,
            device=self.device))

    @torch.no_grad()
    def rollout(self, noise=None, gumbel=None) -> dict:
        """One T-tick rollout with the manager consulted every tick
        (scripts/ppo.py:60-141 minus the npz recording).  Returns the
        buffer: obs (T, W, 128), actions (T, W, 6), values, log_probs,
        not_dones, rewards (T, W), next_value (W,)."""
        hp, env, tm = self.hp, self.env, self.timer
        T, N, dev = hp.num_rollout_steps, hp.num_envs, self.device
        tm.start("rollout")
        obs, _, _ = env.reset(None if noise is None else _draw(noise))
        buf = {"obs": torch.empty((T, N, C.OBS_SIZE), dtype=F32,
                                  device=dev),
               "actions": torch.empty((T, N, 6), dtype=I32, device=dev)}
        for k in ("values", "log_probs", "not_dones", "rewards"):
            buf[k] = torch.empty((T, N), dtype=F32, device=dev)
        mgr = self.controller_manager
        for t in range(T):
            g = self._gumbel(gumbel)
            tm.start("inference")
            actions, logp, value = agent_lib.forward(self.agent, obs, g)
            tm.end("inference")
            tm.start("sim")
            n = None if noise is None else _draw(noise)
            if env.viewer is not None and mgr.is_human_control_active():
                selected = env.viewer.get_selected_agent_index()
                human = mgr.get_action(obs[0].cpu().numpy(), env.viewer)
                obs_, rews, dones = env.step_with_world_actions(
                    actions, human, selected, noise=n)
            else:
                obs_, rews, dones = env.step_with_world_actions(actions,
                                                                noise=n)
            tm.end("sim")
            self.stats = _stats_step(self.stats, rews, dones)
            buf["obs"][t] = obs
            buf["actions"][t] = actions
            buf["values"][t] = value
            buf["log_probs"][t] = logp
            buf["not_dones"][t] = 1.0 - dones
            buf["rewards"][t] = rews
            obs = obs_
        buf["next_value"] = agent_lib.evaluate(self.agent, obs)
        tm.end("rollout")
        return buf

    def train_iteration(self, noise=None, gumbel=None, perms=None) -> dict:
        """rollout -> GAE -> update; returns the JAX method's metrics."""
        buf = self.rollout(noise, gumbel)
        if perms is None:
            perms = self._update_policy.draw_perms(self.gen, self.device)
        agent, adv, values_n, returns_n = self._compute_advantages(
            self.agent, buf)
        self.timer.start("update")
        self.agent, self.opt = self._update_policy(
            agent, self.opt, buf, adv, values_n, returns_n, perms)
        self.timer.end("update")
        # keep the manager's RL controller on the latest weights
        self.controller_manager.rl_controller.agent = self.agent
        return {
            "mean_reward": self.stats.mean_reward,
            "mean_episode_length": self.stats.mean_length,
            "reward_window": self.stats.reward_size,
            "adv_abs_mean": adv.abs().mean(),
            "value_mean": values_n.mean(),
        }
