"""PPO hyperparameters (port of `madrona_basketball_tpu.ppo.hparams`);
defaults match the reference recipe (scripts/ppo.py:24-57)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PPOParams:
    num_envs: int = 8192
    num_rollout_steps: int = 32
    learning_rate: float = 3e-4
    gamma: float = 0.998
    gae_lambda: float = 0.95
    num_minibatches: int = 4
    update_epochs: int = 4
    clip_coef: float = 0.2
    clip_vloss: bool = True
    ent_coef: float = 0.01
    vf_coef: float = 1.0
    max_grad_norm: float = 1.0
    trainee_idx: int = 1
    use_frozen: bool = False
    record_world0: bool = False
    shuffle_block: int = 8
    update_block: int = 0

    @property
    def rollout_batch_size(self) -> int:
        return self.num_envs * self.num_rollout_steps

    @property
    def minibatch_size(self) -> int:
        return self.rollout_batch_size // self.num_minibatches
