"""Reference-recipe PyTorch PPO driving the native host executor (port of
`madrona_basketball_tpu.crosscheck.torch_ppo`, torch_ppo.py:1-365).

An independent cross-validation trainer: a from-scratch PyTorch
implementation of the reference's exact training recipe
(scripts/ppo.py:60-216, scripts/agent.py:19-182, scripts/action.py) that
steps the port's native host executor (native/__init__.py::NativeEngine,
csrc/host_step.cpp over `sim_world.cuh::step_world`).  It shares no code
with the port's trainers, so their agreement on the same trajectories
closes the trainer-semantics loop.  This copy equals the JAX package's
module but for three things: it imports only port modules, its draws
(the init, the sampling, the minibatch permutations) come from explicit
`torch.Generator`s (with the same generator state as the global one they
replace, the same bits: tests/test_torch_port_crosscheck.py), and
`train` runs the agent and the update on `device` (default "cuda"),
copying the engine's obs to the card each tick.

Faithful recipe details reproduced (not copied — reimplemented and
cross-cited): float64 RunningMeanStd buffers with the Chan merge and
clamp +-5 (scripts/agent.py:19-50), the kaiming-gain init quirk
(scripts/agent.py:96-98), per-bucket categorical heads
(scripts/action.py), reversed-loop GAE with value unnorm + in-place
re-normalization (scripts/ppo.py:144-177), shuffled flat minibatches
with clipped surrogate / clipped value loss / entropy, grad-norm clip
1.0, Adam(3e-4, eps 1e-8) (scripts/ppo.py:180-216, 301), and the
reset-pulse-per-iteration rollout contract (scripts/ppo.py:64).

CLI: python -m madrona_basketball_tpu_torch.crosscheck.torch_ppo \
         --num-envs 512 --num-iterations 300 [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch
import torch.nn as nn

from .. import constants as C
from ..config import SimConfig

BUCKETS = list(C.ACTION_BUCKETS)


class RunningMeanStdT(nn.Module):
    """scripts/agent.py:19-50: f64 buffers, Chan merge, clamp on the
    normalized value (and on the input when un-normalizing)."""

    def __init__(self, dim: int, clamp: float = 5.0):
        super().__init__()
        self.eps = 1e-5
        self.clamp = clamp
        self.register_buffer("mean", torch.zeros(dim, dtype=torch.float64))
        self.register_buffer("var", torch.ones(dim, dtype=torch.float64))
        self.register_buffer("count", torch.ones((), dtype=torch.float64))

    def normalize(self, x):
        m = self.mean.to(torch.float32)
        v = self.var.to(torch.float32) + self.eps
        out = (x - m) * torch.rsqrt(v)
        return torch.clamp(out, -self.clamp, self.clamp) if self.clamp \
            else out

    def unnormalize(self, x):
        if self.clamp:
            x = torch.clamp(x, -self.clamp, self.clamp)
        m = self.mean.to(torch.float32)
        v = self.var.to(torch.float32) + self.eps
        return m + torch.sqrt(v) * x

    @torch.no_grad()
    def update(self, x):
        # batch statistics in f32 exactly as the reference computes them
        # (scripts/agent.py:43 — only the BUFFERS are f64; the promotion
        # to f64 happens in the merge arithmetic below)
        x = x.reshape(-1, x.shape[-1])
        var, mean = torch.var_mean(x, dim=0, unbiased=True)
        n = x.shape[0]
        total = self.count + n
        delta = mean - self.mean
        m = (self.var * self.count + var * n +
             delta ** 2 * self.count * n / total)
        self.mean.copy_(self.mean + delta * n / total)
        self.var.copy_(m / total)
        self.count.copy_(total)


def _bucket_slices():
    off = 0
    for n in BUCKETS:
        yield off, n
        off += n


class TorchAgent(nn.Module):
    """scripts/agent.py:107-178 (module names match the reference's
    state_dict layout, so the port's `.pth` checkpoints load into it).
    `gen`: the CPU generator of the init (None: the global one)."""

    def __init__(self, input_dim: int = C.OBS_SIZE, num_channels: int = 32,
                 num_layers: int = 2, gen: torch.Generator = None):
        super().__init__()
        layers = []
        d = input_dim
        for _ in range(num_layers):
            lin = nn.Linear(d, num_channels)
            # the reference passes gain("relu")=sqrt(2) as kaiming's
            # negative-slope `a` (scripts/agent.py:96-98)
            nn.init.kaiming_normal_(lin.weight, a=math.sqrt(2.0),
                                    generator=gen)
            nn.init.zeros_(lin.bias)
            layers += [lin, nn.LayerNorm(num_channels), nn.ReLU()]
            d = num_channels
        self.backbone = nn.Sequential(*layers)
        self.actor = nn.Linear(num_channels, sum(BUCKETS))
        self.critic = nn.Linear(num_channels, 1)
        for head in (self.actor, self.critic):
            nn.init.orthogonal_(head.weight, gain=0.01, generator=gen)
            nn.init.zeros_(head.bias)
        self.obs_norm = RunningMeanStdT(input_dim)
        self.value_norm = RunningMeanStdT(1)

    def _trunk(self, obs):
        return self.backbone(self.obs_norm.normalize(obs))

    def forward(self, obs, stochastic: bool = True,
                gen: torch.Generator = None):
        """`gen`: the sampling's generator on obs' device (None: the
        global one); the draw is Categorical.sample's own multinomial."""
        x = self._trunk(obs)
        logits = self.actor(x)
        acts, lps = [], []
        for off, n in _bucket_slices():
            dist = torch.distributions.Categorical(
                logits=logits[:, off:off + n])
            a = torch.multinomial(dist.probs, 1, True, generator=gen)[:, 0] \
                if stochastic else logits[:, off:off + n].argmax(-1)
            acts.append(a)
            lps.append(dist.log_prob(a))
        value = self.critic(x).squeeze(-1)
        return (torch.stack(acts, dim=1),
                torch.stack(lps, dim=1).sum(-1), value)

    def evaluate(self, obs):
        return self.critic(self._trunk(obs)).squeeze(-1)

    def get_stats(self, obs, actions):
        x = self._trunk(obs)
        logits = self.actor(x)
        lps, ents = [], []
        for i, (off, n) in enumerate(_bucket_slices()):
            dist = torch.distributions.Categorical(
                logits=logits[:, off:off + n])
            lps.append(dist.log_prob(actions[:, i]))
            ents.append(dist.entropy())
        value = self.critic(x).squeeze(-1)
        return (torch.stack(lps, 1).sum(-1), torch.stack(ents, 1).sum(-1),
                value)

    def unnorm_value(self, v):
        return self.value_norm.unnormalize(v)

    @classmethod
    def from_agent_params(cls, ap) -> "TorchAgent":
        """Initialize from the port's `Agent` (exact same weights, through
        the reference-layout state_dict of utils/checkpoint.py)."""
        from ..utils.checkpoint import state_dict
        agent = cls().to(next(ap.net.parameters()).device)
        agent.load_state_dict(state_dict(ap))
        return agent


def compute_advantages_torch(agent: TorchAgent, buf: dict, gamma: float,
                             gae_lambda: float):
    """scripts/ppo.py:144-177 over a dict buffer of (T, N) tensors.

    Returns (advantages, values_n, returns_n) and mutates the agent's
    normalizers, exactly mirroring the reference's in-place flow."""
    with torch.no_grad():
        T = buf["rewards"].shape[0]
        values = agent.unnorm_value(buf["values"])
        next_value = agent.unnorm_value(buf["next_value"])
        advantages = torch.zeros_like(values)
        last = 0.0
        for t in reversed(range(T)):
            if t == T - 1:
                nnt, nv = buf["not_dones"][t], next_value
            else:
                nnt, nv = buf["not_dones"][t + 1], values[t + 1]
            delta = buf["rewards"][t] + gamma * nv * nnt - values[t]
            advantages[t] = last = delta + gamma * gae_lambda * nnt * last
        returns = advantages + values
        agent.obs_norm.update(buf["obs"].reshape(-1, buf["obs"].shape[-1]))
        agent.value_norm.update(values.reshape(-1, 1))
        agent.value_norm.update(returns.reshape(-1, 1))
        mu, sigma = advantages.mean(), advantages.std()
        advantages = (advantages - mu) / (sigma + 1e-8)
        values_n = agent.value_norm.normalize(
            values.reshape(-1, 1)).reshape(values.shape)
        returns_n = agent.value_norm.normalize(
            returns.reshape(-1, 1)).reshape(returns.shape)
    return advantages, values_n, returns_n


def update_policy_torch(agent: TorchAgent, optimizer, buf, advantages,
                        values_n, returns_n, hp, gen: torch.Generator = None):
    """scripts/ppo.py:180-216: epochs x shuffled flat minibatches; `gen`
    draws the permutations on the buffer's device (None: the global
    generator)."""
    total = advantages.numel()
    mb = total // hp.num_minibatches
    D = buf["obs"].shape[-1]
    obs = buf["obs"].reshape(total, D)
    actions = buf["actions"].reshape(total, len(BUCKETS))
    lp = buf["log_probs"].reshape(total)
    v = values_n.reshape(total)
    adv = advantages.reshape(total)
    ret = returns_n.reshape(total)
    for _ in range(hp.update_epochs):
        order = torch.randperm(total, generator=gen,
                               device=advantages.device)
        for start in range(0, total, mb):
            idx = order[start:start + mb]
            lp_, ent, v_ = agent.get_stats(obs[idx], actions[idx])
            ratio = torch.exp(lp_ - lp[idx])
            surr1 = -adv[idx] * ratio
            surr2 = -adv[idx] * torch.clamp(ratio, 1 - hp.clip_coef,
                                            1 + hp.clip_coef)
            pg_loss = torch.max(surr1, surr2).mean()
            vf = (v_ - ret[idx]) ** 2
            v_clip = v[idx] + (v_ - v[idx]).clamp(-hp.clip_coef,
                                                  hp.clip_coef)
            c_loss = 0.5 * torch.max(vf, (v_clip - ret[idx]) ** 2).mean()
            loss = (pg_loss + hp.vf_coef * c_loss -
                    hp.ent_coef * ent.mean())
            optimizer.zero_grad()
            loss.backward()
            nn.utils.clip_grad_norm_(agent.parameters(), hp.max_grad_norm)
            optimizer.step()


class NativeTorchEnv:
    """EnvWrapper-shaped facade over the native host executor: trainee
    actions written per step, the other agent driven by the in-sim
    hardCodeDefense (the reference's shape when training without a
    frozen checkpoint, scripts/env.py:125-170).  Returns CPU tensors, or
    tensors on `device`."""

    def __init__(self, num_worlds: int, cfg: SimConfig = None,
                 seed: int = 0, trainee_idx: int = 1, device="cpu"):
        from ..native import NativeEngine
        from ..ops import layout
        self.cfg = cfg or SimConfig()
        self.eng = NativeEngine(self.cfg, num_worlds, seed=seed)
        self.ti = trainee_idx
        self.device = torch.device(device)
        self.L = layout
        self._act_rows = [layout.I_IDX[f"a{trainee_idx}.{n}"] for n in
                          ("a_move", "a_angle", "a_rotate", "a_grab",
                           "a_pass", "a_shoot")]
        self._reset_rows = [layout.I_IDX[f"a{i}.reset"]
                            for i in range(C.NUM_AGENTS)]
        self._obs_lo = trainee_idx * C.OBS_SIZE
        self._rew = layout.F_IDX[f"a{trainee_idx}.reward"]
        self._done = layout.F_IDX[f"a{trainee_idx}.done"]

    def _out(self):
        obs = torch.from_numpy(
            self.eng.obs[self._obs_lo:self._obs_lo + C.OBS_SIZE].T.copy())
        rew = torch.from_numpy(self.eng.sf[self._rew].copy())
        done = torch.from_numpy(self.eng.sf[self._done].copy())
        return obs.to(self.device), rew.to(self.device), \
            done.to(self.device)

    def step(self, trainee_actions):
        if isinstance(trainee_actions, torch.Tensor):
            trainee_actions = trainee_actions.cpu().numpy()
        a = np.asarray(trainee_actions, np.int32)
        for j, row in enumerate(self._act_rows):
            self.eng.si[row] = a[:, j]
        self.eng.step()
        return self._out()

    def reset(self):
        """Reset-flag pulse (scripts/env.py:178-185)."""
        for r in self._reset_rows:
            self.eng.si[r] = 1
        out = self.step(np.zeros((self.eng.num_worlds, 6), np.int32))
        for r in self._reset_rows:
            self.eng.si[r] = 0
        return out


def train(num_envs: int = 512, num_iterations: int = 100, seed: int = 0,
          cfg: SimConfig = None, agent: TorchAgent = None,
          log_every: int = 10, hp=None, device="cuda"):
    """The reference training loop (scripts/ppo.py:302-335) against the
    native engine, the agent and the update on `device`; returns (agent,
    history list of per-log dicts).  Draws: the init from a CPU generator
    seeded `seed`, the sampling and the permutations from one on
    `device` seeded `seed`, the sim noise from the engine's."""
    from ..ppo.hparams import PPOParams
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not "
                           "available")
    hp = hp or PPOParams(num_envs=num_envs)
    env = NativeTorchEnv(num_envs, cfg, seed=seed, device=dev)
    agent = (agent or TorchAgent(gen=torch.Generator().manual_seed(seed))
             ).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    optimizer = torch.optim.Adam(agent.parameters(), lr=hp.learning_rate,
                                 eps=1e-8)
    T = hp.num_rollout_steps
    history = []
    curr_rew = torch.zeros(num_envs, device=dev)
    curr_len = torch.zeros(num_envs, device=dev)
    finished_rew, finished_len = [], []
    for it in range(1, num_iterations + 1):
        obs, _, _ = env.reset()
        rows = {k: [] for k in ("obs", "actions", "values", "log_probs",
                                "not_dones", "rewards")}
        with torch.no_grad():
            for _ in range(T):
                actions, logp, value = agent(obs, gen=gen)
                obs_, rew, done = env.step(actions)
                curr_rew += rew
                curr_len += 1
                for i in torch.nonzero(done > 0.5).flatten().tolist():
                    finished_rew.append(float(curr_rew[i]))
                    finished_len.append(float(curr_len[i]))
                curr_rew *= (1.0 - done)
                curr_len *= (1.0 - done)
                rows["obs"].append(obs)
                rows["actions"].append(actions)
                rows["values"].append(value)
                rows["log_probs"].append(logp)
                rows["not_dones"].append(1.0 - done)
                rows["rewards"].append(rew)
                obs = obs_
        buf = {k: torch.stack(v) for k, v in rows.items()}
        with torch.no_grad():
            buf["next_value"] = agent.evaluate(obs)
        adv, vn, rn = compute_advantages_torch(agent, buf, hp.gamma,
                                               hp.gae_lambda)
        update_policy_torch(agent, optimizer, buf, adv, vn, rn, hp, gen)
        if it % log_every == 0:
            window_r = finished_rew[-100:]
            window_l = finished_len[-100:]
            entry = {
                "iteration": it,
                "mean_reward": float(np.mean(window_r)) if window_r
                else 0.0,
                "mean_episode_length": float(np.mean(window_l))
                if window_l else 0.0,
                "episodes": len(finished_rew),
            }
            history.append(entry)
            print(f"[torch-ppo] iter {it}: reward "
                  f"{entry['mean_reward']:.2f} len "
                  f"{entry['mean_episode_length']:.1f} "
                  f"episodes {entry['episodes']}")
    return agent, history


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Reference-recipe torch PPO on the native engine")
    p.add_argument("--num-envs", type=int, default=512)
    p.add_argument("--num-iterations", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--out", type=str, default=None,
                   help="npz path for the reward history")
    p.add_argument("--device", type=str, default="cuda",
                   help="the agent's and the update's device (the engine "
                        "runs on the host)")
    args = p.parse_args(argv)
    _, history = train(args.num_envs, args.num_iterations, args.seed,
                       log_every=args.log_every, device=args.device)
    if args.out and history:
        np.savez(args.out, **{k: np.array([h[k] for h in history])
                              for k in history[0]})
        print(f"history saved to {args.out}")


if __name__ == "__main__":
    main()
