"""Rollout storage (port of `madrona_basketball_tpu.ppo.buffers`,
buffers.py:20-76).

API parity with the reference's `RolloutBuffer` (scripts/buffers.py:4-33)
as a dataclass of tensors on an explicit device.  The port's trainers
build the same (T, N) layout themselves and never use it; it serves
loops driven from the host that want the reference's buffer surface.
Like the JAX class it is functional: `set_step` returns a new buffer and
leaves the old one as it was.
"""

from __future__ import annotations

import dataclasses

import torch

F32 = torch.float32


@dataclasses.dataclass
class RolloutBuffer:
    obs: torch.Tensor         # (T, N, obs_dim)
    actions: torch.Tensor     # (T, N, act_dim) int32
    values: torch.Tensor      # (T, N)
    log_probs: torch.Tensor   # (T, N)
    rewards: torch.Tensor     # (T, N)
    not_dones: torch.Tensor   # (T, N)
    next_value: torch.Tensor  # (N,)
    advantages: torch.Tensor  # (T, N)
    returns: torch.Tensor     # (T, N)

    @property
    def horizon(self) -> int:
        return self.obs.shape[0]

    @property
    def n_envs(self) -> int:
        return self.obs.shape[1]

    def get_total_steps(self) -> int:
        return self.horizon * self.n_envs

    def set_step(self, t: int, obs, actions, values, log_probs, rewards,
                 not_dones) -> "RolloutBuffer":
        def at(buf, v):
            out = buf.clone()
            out[t] = torch.as_tensor(v, dtype=buf.dtype, device=buf.device)
            return out
        return dataclasses.replace(
            self, obs=at(self.obs, obs), actions=at(self.actions, actions),
            values=at(self.values, values),
            log_probs=at(self.log_probs, log_probs),
            rewards=at(self.rewards, rewards),
            not_dones=at(self.not_dones, not_dones))

    def get_minibatch(self, indices: torch.Tensor):
        """Flat-index gather across (T * N,) (scripts/buffers.py:25-33):
        (obs, actions, log_probs, values, advantages, returns)."""
        idx = torch.as_tensor(indices, device=self.obs.device).long()
        o = self.obs.reshape(-1, self.obs.shape[-1])[idx]
        a = self.actions.reshape(-1, self.actions.shape[-1])[idx]
        lp = self.log_probs.reshape(-1)[idx]
        v = self.values.reshape(-1)[idx]
        adv = self.advantages.reshape(-1)[idx]
        ret = self.returns.reshape(-1)[idx]
        return o, a, lp, v, adv, ret


def make_buffer(n_steps: int, n_envs: int, obs_dim: int, act_dim: int,
                device="cuda") -> RolloutBuffer:
    def z(*shape, dtype=F32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return RolloutBuffer(
        obs=z(n_steps, n_envs, obs_dim),
        actions=z(n_steps, n_envs, act_dim, dtype=torch.int32),
        values=z(n_steps, n_envs), log_probs=z(n_steps, n_envs),
        rewards=z(n_steps, n_envs), not_dones=z(n_steps, n_envs),
        next_value=z(n_envs), advantages=z(n_steps, n_envs),
        returns=z(n_steps, n_envs))
